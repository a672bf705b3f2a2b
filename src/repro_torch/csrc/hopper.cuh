// Hopper (sm_90a) primitives of the port's kernels, as inline PTX: shared
// memory addresses, mbarriers, TMA tile loads and 1-d bulk copies, named
// barriers, warpgroup MMA (wgmma) with its shared-memory descriptors, and
// the warp-level tensor-core path (ldmatrix, mma.sync m16n8k16, cp.async,
// and the fragment addressing of swizzled bf16 tiles) of the flash
// backward and the paged prefill.
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

// Byte offset of element column `col` (a multiple of 8) of row `row` in a
// bf16 tile of D columns whose 16-byte chunks are XOR-swizzled by the row
// (chunk ^ row % 8), so that ldmatrix's 8 row addresses hit 8 banks.
template <int D>
__device__ __forceinline__ uint32_t swz(int row, int col) {
  return (uint32_t)(row * D * 2 + ((((col >> 3) ^ (row & 7))) << 4));
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

}  // namespace repro_torch
