// Hopper (sm_90a) primitives of the port's kernels, as inline PTX: shared
// memory addresses, mbarriers, TMA tile loads and 1-d bulk copies, named
// barriers, warpgroup MMA (wgmma) with its shared-memory descriptors, the
// warp-level tensor-core path (ldmatrix, mma.sync m16n8k16, cp.async,
// and the fragment addressing of swizzled or padded bf16 tiles) of the
// flash backward and the paged prefill, and the 3xTF32 path of the f32
// attention kernels (mma.sync m16n8k8 .tf32 on f32 values split into a
// TF32 pair, the fragment addressing of swizzled f32 tiles, and their
// loads, contiguous or gathered row by row).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Two f32 values as one bf16x2 register, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x on the SFU (flushes denormal results to 0).
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The (tile, head, batch) of this block of a 1-d grid of n_tiles x heads
// x batch blocks, numbered tile-major: blocks are dispatched in
// ascending blockIdx.x, so all heads and batches of one tile rank go
// before the next rank. With `reverse` rank 0 is the last tile. Launched
// heaviest rank first, the long blocks do not land in the last wave.
struct TileOrder {
  int tile, head, batch;
};
__device__ __forceinline__ TileOrder tile_order(int n_tiles, int heads,
                                                bool reverse) {
  const int per = gridDim.x / n_tiles;   // heads * batch
  const int rank = blockIdx.x / per, rem = blockIdx.x % per;
  return {reverse ? n_tiles - 1 - rank : rank, rem % heads, rem / heads};
}

// ------------------------------------------------------------ mbarrier --

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Arrive once and add `bytes` to the transactions the phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

// Spin until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar), "r"(parity) : "memory");
}

// ----------------------------------------------------------------- TMA --

// Copy the box at coordinates (c0, c1, c2, c3) of a 4-d tensor map into
// shared memory at `dst`; completion is reported to mbarrier `bar`.
// Elements outside the tensor arrive as zeros.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const void* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar) : "memory");
}

// Copy `bytes` (a multiple of 16) of contiguous global memory at `src`
// into shared memory at `dst`, both 16-byte aligned, with TMA's 1-d bulk
// copy; completion is reported to mbarrier `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// Barrier `id` (1..15; 0 is __syncthreads') over `threads` threads, a
// multiple of 32: a subset of the block's warps waits for each other.
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// --------------------------------------------------------------- wgmma --

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N of this warpgroup's committed groups are pending
// (groups complete in commit order).
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin registers that an in-flight wgmma reads or writes: called on them
// after the wgmma_wait that covers it, it keeps the compiler from
// touching them earlier.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// Descriptor of a bf16 operand tile in shared memory with the 128-byte
// swizzle that TMA's CU_TENSOR_MAP_SWIZZLE_128B writes: rows of 64
// elements (128 bytes), 8-row groups 1024 bytes apart (SBO). `lbo` is the
// byte distance between 64-element column blocks of an MN-major operand
// (unused for K-major). The tile must start 1024-byte aligned; a K step
// of 16 elements inside a row advances the address by 32 bytes.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  uint64_t d = 0;
  d |= (uint64_t)((addr & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)(1024 >> 4) << 32;
  d |= (uint64_t)1 << 62;
  return d;
}

// The same for the 32-byte swizzle that CU_TENSOR_MAP_SWIZZLE_32B writes:
// rows of 16 elements (32 bytes), 8-row groups 256 bytes apart (SBO). A
// K-major operand of 16 columns is one k16 step; an MN-major one of 16
// columns is one N block (`lbo`, the distance to the next, unused at
// N = 16), and a k16 step is 16 rows (512 bytes). The tile must start
// 256-byte aligned.
__device__ __forceinline__ uint64_t sw32_desc(uint32_t addr, uint32_t lbo) {
  uint64_t d = 0;
  d |= (uint64_t)((addr & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)(256 >> 4) << 32;
  d |= (uint64_t)3 << 62;
  return d;
}

// D (64 x 128, f32) = A (64 x 16) . B (128 x 16)^T (+ D when scale_d),
// A and B bf16 in shared memory behind K-major descriptors.
__device__ __forceinline__ void wgmma_ss_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, f32) += A (64 x 16, bf16 in registers) . B (16 x 64),
// B bf16 in shared memory behind an MN-major descriptor (transpose bit).
__device__ __forceinline__ void wgmma_rs_m64n64k16_tb(float (&d)[32],
                                                    const uint32_t (&a)[4],
                                                    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 16, f32) += A (64 x 16, bf16 in registers) . B (16 x 16), B as
// in wgmma_rs_m64n64k16_tb.
__device__ __forceinline__ void wgmma_rs_m64n16k16_tb(float (&d)[8],
                                                    const uint32_t (&a)[4],
                                                    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ------------------------------------------------- mma.sync / ldmatrix --

// Four 8x8 b16 matrices; lanes 8j..8j+7 give the row addresses of
// matrix j, and register j of lane l receives row l/4, elements
// 2(l%4), 2(l%4)+1 of matrix j (of its transpose with `_t`).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c (16 x 8, f32) += a (16 x 16, bf16, row) . b (16 x 8, bf16, col).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes from global to shared memory, bypassing L1; with `valid`
// false nothing is read and the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0) : "memory");
}
// 4 bytes, likewise.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Bytes of one row of a bf16 tile of D columns in shared memory. At
// D % 64 == 0 a row is D * 2 bytes and its 16-byte chunks are
// XOR-swizzled by the row (chunk ^ row % 8); other widths (D = 80) cannot
// XOR over 8 chunks, so their rows are padded by one chunk instead: an
// odd pitch in chunks (11 at D = 80) puts 8 consecutive rows' chunks at
// 8 distinct offsets mod 128 bytes. Either way ldmatrix's 8 row addresses
// hit 8 different banks.
template <int D>
__host__ __device__ constexpr int tile_row_bytes() {
  static_assert(D % 64 == 0 || (D / 8) % 2 == 0,
                "a padded row needs an odd number of 16-byte chunks");
  return D % 64 == 0 ? 2 * D : 2 * D + 16;
}

// Byte offset of element column `col` (a multiple of 8) of row `row` in a
// bf16 tile of D columns laid out as tile_row_bytes<D> says.
template <int D>
__device__ __forceinline__ uint32_t swz(int row, int col) {
  if constexpr (D % 64 == 0)
    return (uint32_t)(row * D * 2 + ((((col >> 3) ^ (row & 7))) << 4));
  else
    return (uint32_t)(row * tile_row_bytes<D>() + col * 2);
}

// The ldmatrix row address of this lane for a 16 x 16 block at (row0,
// col0) of a swizzled tile: as an A operand (rows = m), or as two B
// operands stored [n][k] (`b_nk`), or as two B operands stored [k][n]
// read transposed (`b_kn`).
template <int D>
__device__ __forceinline__ uint32_t a_addr(uint32_t tile, int row0,
                                           int col0, int lane) {
  return tile + swz<D>(row0 + (lane & 15), col0 + (lane >> 4) * 8);
}
template <int D>
__device__ __forceinline__ uint32_t b_nk_addr(uint32_t tile, int n0, int k0,
                                              int lane) {
  return tile + swz<D>(n0 + (lane & 7) + (lane >> 4) * 8,
                       k0 + ((lane >> 3) & 1) * 8);
}
template <int D>
__device__ __forceinline__ uint32_t b_kn_addr(uint32_t tile, int k0, int n0,
                                              int lane) {
  return tile + swz<D>(k0 + (lane & 7) + ((lane >> 3) & 1) * 8,
                       n0 + (lane >> 4) * 8);
}

// Accumulator tiles (16 x 8 each, N8 of them along n) to bf16 A
// fragments along k: chunk kc is accumulator tiles 2kc and 2kc + 1.
template <int N8>
__device__ __forceinline__ void acc_to_a(const float (&acc)[N8][4],
                                         uint32_t (&a)[N8 / 2][4]) {
#pragma unroll
  for (int kc = 0; kc < N8 / 2; ++kc) {
    a[kc][0] = pack_bf16(acc[2 * kc][0], acc[2 * kc][1]);
    a[kc][1] = pack_bf16(acc[2 * kc][2], acc[2 * kc][3]);
    a[kc][2] = pack_bf16(acc[2 * kc + 1][0], acc[2 * kc + 1][1]);
    a[kc][3] = pack_bf16(acc[2 * kc + 1][2], acc[2 * kc + 1][3]);
  }
}

// ------------------------------------------------------------- 3xTF32 --
//
// An f32 value x is taken as the TF32 pair hi = tf32(x), lo = tf32(x - hi)
// (round to nearest, ties away: cvt.rna), which holds x to about 2^-22
// relative, and a product of two values as hi.hi + hi.lo + lo.hi (the
// lo.lo term is below f32 rounding): CUTLASS's "fast accurate f32"
// (OpMultiplyAddFastF32). Each term is one mma.sync m16n8k8 .tf32 with
// f32 accumulation, so an f32 product costs three tensor-core passes at
// TF32's 495 TFLOP/s: ~165 TFLOP/s, against 67 for f32 FMA. A single TF32
// pass keeps about three decimal digits and misses the f32 tolerance. An
// operand widened from bf16 is exact in TF32 (EXACT): its lo is 0 and its
// passes are skipped.

struct FragA {   // a 16 x 8 A fragment as a TF32 pair
  uint32_t hi[4], lo[4];
};
struct FragB {   // an 8 x 8 B fragment as a TF32 pair
  uint32_t hi[2], lo[2];
};

// x as its TF32 pair; with EXACT (x widened from bf16) hi = x, lo unset.
template <bool EXACT>
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  if constexpr (EXACT) {
    hi = __float_as_uint(x);
  } else {
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
    asm("cvt.rna.tf32.f32 %0, %1;\n"
        : "=r"(lo) : "f"(x - __uint_as_float(hi)));
  }
}

// c (16 x 8, f32) += a (16 x 8, tf32, row) . b (8 x 8, tf32, col).
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a . b in 3xTF32, the small terms first; a pass with an EXACT
// operand's lo is skipped.
template <bool A_EXACT, bool B_EXACT>
__device__ __forceinline__ void mma3(float* c, const FragA& a,
                                     const FragB& b) {
  if constexpr (!A_EXACT) mma_tf32(c, a.lo, b.hi[0], b.hi[1]);
  if constexpr (!B_EXACT) mma_tf32(c, a.hi, b.lo[0], b.lo[1]);
  mma_tf32(c, a.hi, b.hi[0], b.hi[1]);
}

// f32 tiles of D columns in shared memory: rows of f32_pitch<D>() floats
// (D rounded up to 32: 96 at D = 80), 16-byte chunk ch of row r stored
// at chunk ch ^ 2 s(r), s(r) = (r & 3) ^ ((r >> 2) & 1). Fragments are
// read two ways, both free of bank conflicts under that XOR: 8-byte
// loads of (row n0 + g, columns k0 + 2t, +1) for g < 8, t < 4, where
// rows n0 .. n0 + 3 (and n0 + 4 .. n0 + 7) take four different s; and
// 4-byte loads of (rows k0 + 2t and k0 + 2t + 1, column n0 + g), where
// the even rows (and the odd ones) of an 8-row group take four
// different s. (ldmatrix moves 16-bit elements only.)
template <int D>
__host__ __device__ constexpr int f32_pitch() {
  return (D + 31) / 32 * 32;
}
template <int D>
__device__ __forceinline__ int f32_off(int r, int col) {
  const int s = (r & 3) ^ ((r >> 2) & 1);
  return r * f32_pitch<D>() + ((((col >> 2) ^ (s << 1))) << 2) + (col & 3);
}

// The k index of an m16n8k8 fragment is permuted so that a 16 x 8 f32
// accumulator (thread (g, t) holds columns 2t, 2t + 1 of rows g, g + 8)
// is an A fragment as it stands: logical k = t is column 2t, k = t + 4
// is column 2t + 1. Every operand is read under the same permutation.

// A fragment of rows r0 .. r0 + 15, columns k0 .. k0 + 7 of a tile.
template <int D, bool EXACT>
__device__ __forceinline__ void ld_a(FragA& f, const float* tile, int r0,
                                     int k0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float2 x = *reinterpret_cast<const float2*>(
      tile + f32_off<D>(r0 + g, k0 + 2 * t));
  const float2 y = *reinterpret_cast<const float2*>(
      tile + f32_off<D>(r0 + g + 8, k0 + 2 * t));
  split_tf32<EXACT>(x.x, f.hi[0], f.lo[0]);
  split_tf32<EXACT>(y.x, f.hi[1], f.lo[1]);
  split_tf32<EXACT>(x.y, f.hi[2], f.lo[2]);
  split_tf32<EXACT>(y.y, f.hi[3], f.lo[3]);
}

// A fragment from an accumulator tile (c[0..3]: (g, 2t), (g, 2t + 1),
// (g + 8, 2t), (g + 8, 2t + 1)): P or dS as the next product's A.
__device__ __forceinline__ void acc_a(FragA& f, const float* c) {
  split_tf32<false>(c[0], f.hi[0], f.lo[0]);
  split_tf32<false>(c[2], f.hi[1], f.lo[1]);
  split_tf32<false>(c[1], f.hi[2], f.lo[2]);
  split_tf32<false>(c[3], f.hi[3], f.lo[3]);
}

// B fragment (k x n = 8 x 8) of a tile stored [n][k]: rows n0 .. n0 + 7,
// columns k0 .. k0 + 7 (K for S = Q K^T).
template <int D, bool EXACT>
__device__ __forceinline__ void ld_b_nk(FragB& f, const float* tile,
                                        int n0, int k0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float2 x = *reinterpret_cast<const float2*>(
      tile + f32_off<D>(n0 + g, k0 + 2 * t));
  split_tf32<EXACT>(x.x, f.hi[0], f.lo[0]);
  split_tf32<EXACT>(x.y, f.hi[1], f.lo[1]);
}

// B fragment of a tile stored [k][n]: rows k0 .. k0 + 7, columns n0 ..
// n0 + 7 (V for O = P V).
template <int D, bool EXACT>
__device__ __forceinline__ void ld_b_kn(FragB& f, const float* tile,
                                        int k0, int n0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  split_tf32<EXACT>(tile[f32_off<D>(k0 + 2 * t, n0 + g)], f.hi[0],
                    f.lo[0]);
  split_tf32<EXACT>(tile[f32_off<D>(k0 + 2 * t + 1, n0 + g)], f.hi[1],
                    f.lo[1]);
}

// The other place for the split: a tile split once as it lands
// (`split_tile`: its hi in place, its lo in a second tile of the same
// layout), each fragment read as two loads and no arithmetic.
template <int NT>
__device__ __forceinline__ void split_tile(float* tile, float* lo, int n) {
  for (int i = 4 * threadIdx.x; i < n; i += 4 * NT) {
    const float4 x = *reinterpret_cast<const float4*>(tile + i);
    uint4 h, l;
    split_tf32<false>(x.x, h.x, l.x);
    split_tf32<false>(x.y, h.y, l.y);
    split_tf32<false>(x.z, h.z, l.z);
    split_tf32<false>(x.w, h.w, l.w);
    *reinterpret_cast<uint4*>(tile + i) = h;
    *reinterpret_cast<uint4*>(lo + i) = l;
  }
}
template <int D>
__device__ __forceinline__ void ld_a(FragA& f, const float* hi,
                                     const float* lo, int r0, int k0,
                                     int lane) {
  const int a0 = f32_off<D>(r0 + (lane >> 2), k0 + 2 * (lane & 3));
  const int a1 = f32_off<D>(r0 + (lane >> 2) + 8, k0 + 2 * (lane & 3));
  const uint2 x = *reinterpret_cast<const uint2*>(hi + a0);
  const uint2 y = *reinterpret_cast<const uint2*>(hi + a1);
  const uint2 u = *reinterpret_cast<const uint2*>(lo + a0);
  const uint2 w = *reinterpret_cast<const uint2*>(lo + a1);
  f.hi[0] = x.x;
  f.hi[1] = y.x;
  f.hi[2] = x.y;
  f.hi[3] = y.y;
  f.lo[0] = u.x;
  f.lo[1] = w.x;
  f.lo[2] = u.y;
  f.lo[3] = w.y;
}
template <int D>
__device__ __forceinline__ void ld_b_nk(FragB& f, const float* hi,
                                        const float* lo, int n0, int k0,
                                        int lane) {
  const int at = f32_off<D>(n0 + (lane >> 2), k0 + 2 * (lane & 3));
  const uint2 x = *reinterpret_cast<const uint2*>(hi + at);
  const uint2 y = *reinterpret_cast<const uint2*>(lo + at);
  f.hi[0] = x.x;
  f.hi[1] = x.y;
  f.lo[0] = y.x;
  f.lo[1] = y.y;
}
template <int D>
__device__ __forceinline__ void ld_b_kn(FragB& f, const float* hi,
                                        const float* lo, int k0, int n0,
                                        int lane) {
  const int a0 = f32_off<D>(k0 + 2 * (lane & 3), n0 + (lane >> 2));
  const int a1 = f32_off<D>(k0 + 2 * (lane & 3) + 1, n0 + (lane >> 2));
  f.hi[0] = __float_as_uint(hi[a0]);
  f.hi[1] = __float_as_uint(hi[a1]);
  f.lo[0] = __float_as_uint(lo[a0]);
  f.lo[1] = __float_as_uint(lo[a1]);
}

// Rows [row0, row0 + ROWS) of one head (rows `stride` elements apart)
// into an f32 tile (f32_off<D>) by NT threads; rows >= valid are zeros.
// f32 rows go by cp.async (commit and wait as the caller pipelines);
// bf16 rows are widened through registers, synchronously.
template <int D, int ROWS, int NT>
__device__ __forceinline__ void load_tile_f32(float* tile, const float* base,
                                              int row0, int valid,
                                              int stride) {
  constexpr int CPR = D / 4;   // 16-byte chunks per row
  const uint32_t t0 = smem_u32(tile);
  for (int idx = threadIdx.x; idx < ROWS * CPR; idx += NT) {
    const int r = idx / CPR, ch = idx % CPR;
    const bool ok = row0 + r < valid;
    cp_async16(t0 + 4 * f32_off<D>(r, ch * 4),
               base + (size_t)(ok ? row0 + r : 0) * stride + ch * 4, ok);
  }
}
template <int D, int ROWS, int NT>
__device__ __forceinline__ void load_tile_f32(float* tile,
                                              const __nv_bfloat16* base,
                                              int row0, int valid,
                                              int stride) {
  constexpr int CPR = D / 8;   // 16-byte chunks (8 bf16) per row
  for (int idx = threadIdx.x; idx < ROWS * CPR; idx += NT) {
    const int r = idx / CPR, ch = idx % CPR;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (row0 + r < valid)
      raw = *reinterpret_cast<const uint4*>(base + (size_t)(row0 + r) *
                                                       stride + ch * 8);
    const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float2 a = __bfloat1622float2(e[0]), b = __bfloat1622float2(e[1]);
    const float2 c = __bfloat1622float2(e[2]), d = __bfloat1622float2(e[3]);
    *reinterpret_cast<float4*>(tile + f32_off<D>(r, ch * 8)) =
        make_float4(a.x, a.y, b.x, b.y);
    *reinterpret_cast<float4*>(tile + f32_off<D>(r, ch * 8 + 4)) =
        make_float4(c.x, c.y, d.x, d.y);
  }
}

// The same with the tile's rows gathered from anywhere in global memory
// (a paged step's keys, spread over pool blocks): 16-byte chunk ch =
// threadIdx.x % CPR of tile row threadIdx.x / CPR + n * (NT / CPR) comes
// from base + row[n] + ch * (16 / sizeof(T)), for n < NI, CPR = D *
// sizeof(T) / 16 chunks a row; row[n] < 0 gives a row of zeros. The
// caller fills `row` (every table read) before the first copy. f32 by
// cp.async; bf16 widened through registers, synchronously.
template <int D, int NT, int NI>
__device__ __forceinline__ void gather_tile_f32(float* tile,
                                                const float* base,
                                                const long long (&row)[NI]) {
  constexpr int CPR = D / 4;
  static_assert(NT % CPR == 0, "whole rows per pass");
  const uint32_t t0 = smem_u32(tile);
  const int ch = threadIdx.x % CPR, r0 = threadIdx.x / CPR;
#pragma unroll
  for (int n = 0; n < NI; ++n) {
    const bool ok = row[n] >= 0;
    cp_async16(t0 + 4 * f32_off<D>(r0 + n * (NT / CPR), ch * 4),
               base + (ok ? row[n] : 0) + ch * 4, ok);
  }
}
template <int D, int NT, int NI>
__device__ __forceinline__ void gather_tile_f32(float* tile,
                                                const __nv_bfloat16* base,
                                                const long long (&row)[NI]) {
  constexpr int CPR = D / 8;
  static_assert(NT % CPR == 0, "whole rows per pass");
  const int ch = threadIdx.x % CPR, r0 = threadIdx.x / CPR;
#pragma unroll
  for (int n = 0; n < NI; ++n) {
    const int r = r0 + n * (NT / CPR);
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (row[n] >= 0)
      raw = *reinterpret_cast<const uint4*>(base + row[n] + ch * 8);
    const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float2 a = __bfloat1622float2(e[0]), b = __bfloat1622float2(e[1]);
    const float2 c = __bfloat1622float2(e[2]), d = __bfloat1622float2(e[3]);
    *reinterpret_cast<float4*>(tile + f32_off<D>(r, ch * 8)) =
        make_float4(a.x, a.y, b.x, b.y);
    *reinterpret_cast<float4*>(tile + f32_off<D>(r, ch * 8 + 4)) =
        make_float4(c.x, c.y, d.x, d.y);
  }
}

// Two consecutive elements of a row as f32.
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Store two consecutive f32 values of a row as T.
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}

}  // namespace repro_torch
