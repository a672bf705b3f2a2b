// Fused RMSNorm, forward and backward, for Hopper, sm_90a.
//
// Replaces the TPU kernel `rmsnorm_pallas` (`_rmsnorm_kernel`,
// src/repro/kernels/rmsnorm.py). For x (rows, d) and w (d,), both in T:
//   r = rsqrt(mean(x^2) + eps)             (f32, one per row)
//   y = T(T(x * r) * w)                     (rounded to T before the
//                                            product with w, as the
//                                            reference does)
// The JAX package has no Pallas backward; its training differentiates
// the jnp norm (src/repro/models/layers.py). The backward here computes,
// per row in f32, with g = dy * w and the forward's r:
//   dx = r * g - x * r^3 * mean(g * x)
//   dw = sum over rows of dy * T(x * r)
//
// Bound on the H100: bytes. The forward moves x in and y out, the
// backward x and dy in and dx out, a few flops per byte; so each byte is
// moved once, and the design is about keeping enough of them in flight
// (~32 KB per SM at 3.35 TB/s and ~1.3 us of latency) while no thread
// waits on a barrier of the whole block:
//   - a persistent grid of at most one block per SM walks tiles of `ng`
//     consecutive rows (tile blockIdx.x, + gridDim.x, ...), fewer rows a
//     tile when that spreads the rows over more SMs;
//   - a producer warp, one thread of it, streams each tile (x, and dy in
//     the backward) into a ring of up to 4 shared-memory stages with one
//     TMA 1-d bulk copy per tensor that completes on the stage's
//     mbarrier, and refills a stage when its consumers release it, so
//     later tiles load while a tile reduces;
//   - a row belongs to a group of GW consumer warps, chosen so that a
//     thread owns at most 32 columns; thread (p, lane) of a group owns the
//     same 16-byte vectors of every row, so in the backward its dw partial
//     stays in registers across rows; w is read once per block into
//     shared memory;
//   - a row's sum is taken with warp shuffles and, across the group's
//     warps, through a small shared-memory exchange behind a named
//     barrier of that group alone;
//   - the row is read from shared memory twice (its sum, then its
//     output), never again from device memory, and y / dx go straight
//     from registers to device memory as 16-byte stores.
// The sum keeps the reduction tree of the 256-thread kernels this design
// replaced (a block per row in the forward, per run of rows in the
// backward), so y and dx are bit-identical to theirs and a model's
// outputs do not move with the redesign: their threads ("virtual"
// threads t = 32 vw + lane, vw < 8) each summed the vectors t, t + 256,
// ... in order, then each warp by xor shuffles, then the 8 warp sums in
// order. Here physical warp p of a group plays the
// virtual warps p, p + GW, ...: it keeps one partial per virtual warp,
// shuffles each, and the 8 sums are added in virtual-warp order.
// dw is reduced without atomics, in a fixed order: each block adds its
// groups' partials in group order and writes one (d,) f32 partial; a
// second kernel sums the (blocks, d) partials per column, block by block
// in strided order with the strides then added in order. Repeated calls
// give bit-identical dw.
#include "common.cuh"
#include "hopper.cuh"

namespace repro_torch {
namespace {

constexpr int COLS = 32;          // columns a consumer thread owns, at most
constexpr int VWARPS = 8;         // warps of the reduction tree (256 threads)
constexpr int MAX_WARPS = 16;     // consumer warps per block
constexpr int MAX_STAGES = 4;     // tiles in the ring
constexpr int RING_BYTES = 192 * 1024;
constexpr int MAX_D = VWARPS * 32 * COLS;   // 8192
constexpr int DW_WARPS = 16;      // the dw sum's warps per 32 columns

// A launch's layout, a function of the shape alone.
struct Plan {
  int gw;        // warps per row group (1, 2, 4 or 8)
  int ng;        // row groups per block = rows per tile
  int stages;    // ring depth
  int blocks;    // persistent blocks
  size_t smem;   // dynamic shared memory: ring, w, warp sums, mbarriers
};

Plan make_plan(int rows, int d, int elem, bool bwd, int max_blocks) {
  Plan p;
  const int nv = d * elem / 16;                 // 16-byte vectors a row
  const int nk = (nv + 32 * VWARPS - 1) / (32 * VWARPS);   // a virtual
  const int vmax = COLS * elem / 16;            // thread's; a thread's max
  p.gw = 1;
  while (p.gw < VWARPS && VWARPS / p.gw * nk > vmax) p.gw *= 2;
  const int row_bytes = d * elem * (bwd ? 2 : 1);
  const int spread = (rows + max_blocks - 1) / max_blocks;
  // as many groups as the warps allow, no more than the rows need to
  // spread over max_blocks blocks, and two stages in the ring
  p.ng = max(1, min(min(MAX_WARPS / p.gw, spread),
                    RING_BYTES / (2 * row_bytes)));
  p.stages = max(1, min(MAX_STAGES, RING_BYTES / (p.ng * row_bytes)));
  p.blocks = min((rows + p.ng - 1) / p.ng, max_blocks);
  p.smem = (size_t)p.stages * p.ng * row_bytes + (size_t)d * elem +
           sizeof(float) * 2 * MAX_WARPS * VWARPS + 8 * 2 * MAX_STAGES;
  return p;
}

template <typename T, bool BWD, int GW>
__global__ void __launch_bounds__((MAX_WARPS + 1) * 32, 1)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const T* __restrict__ dy, float* __restrict__ rstd,
               T* __restrict__ out, float* __restrict__ dw_part, int rows,
               int d, float eps, int ng, int stages) {
  constexpr int N = Vec16<T>::N;
  constexpr int VWN = VWARPS / GW;              // virtual warps a warp plays
  constexpr int KMAX = (COLS / N + VWN - 1) / VWN;   // vectors of one, max
  extern __shared__ __align__(128) uint8_t smem[];
  const int nv = d / N;             // vectors per row
  const int ncw = ng * GW;          // consumer warps; the next is the producer
  const uint32_t row_bytes = (uint32_t)d * sizeof(T);
  const uint32_t tile_bytes = ng * row_bytes;              // x of a tile
  const uint32_t stage_bytes = BWD ? 2 * tile_bytes : tile_bytes;
  T* sw = reinterpret_cast<T*>(smem + (size_t)stages * stage_bytes);
  float* red = reinterpret_cast<float*>(sw + d);   // [2][MAX_WARPS][VWARPS]
  const uint32_t full =                                   // + 8 * stage
      smem_u32(red + 2 * MAX_WARPS * VWARPS);
  const uint32_t empty = full + 8 * MAX_STAGES;           // + 8 * stage
  const int tiles = (rows + ng - 1) / ng;
  const int my_tiles = (tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, ncw);   // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  for (int c = threadIdx.x; c < nv; c += blockDim.x)
    *reinterpret_cast<uint4*>(sw + c * N) =
        *reinterpret_cast<const uint4*>(w + c * N);
  __syncthreads();

  float dwa[KMAX][VWN][N];   // backward: this thread's dw partial
#pragma unroll
  for (int kk = 0; kk < KMAX; ++kk)
#pragma unroll
    for (int i = 0; i < VWN; ++i)
#pragma unroll
      for (int e = 0; e < N; ++e) dwa[kk][i][e] = 0.f;

  if (warp == ncw) {
    // ---- producer: one thread keeps the ring full
    if (lane == 0) {
      for (int it = 0; it < my_tiles; ++it) {
        const int s = it % stages;
        if (it >= stages)   // the consumers released this stage's last tile
          mbar_wait(empty + 8 * s, (it / stages - 1) & 1);
        const int r0 = ((int)blockIdx.x + it * (int)gridDim.x) * ng;
        const uint32_t bytes = min(ng, rows - r0) * row_bytes;
        const uint32_t dst = smem_u32(smem) + s * stage_bytes;
        const uint32_t bar = full + 8 * s;
        mbar_expect_tx(bar, BWD ? 2 * bytes : bytes);
        bulk_load(dst, x + (size_t)r0 * d, bytes, bar);
        if constexpr (BWD)
          bulk_load(dst + tile_bytes, dy + (size_t)r0 * d, bytes, bar);
      }
    }
  } else {
    // ---- consumers: group g takes row g of every tile; warp p of the
    // group plays virtual warps p, p + GW, ...: its vector (kk, i) is
    // c = lane + 32 (p + GW i) + 256 kk
    const int g = warp / GW, p = warp % GW;
    const float inv_d = 1.f / (float)d;
    for (int it = 0; it < my_tiles; ++it) {
      const int s = it % stages;
      const int row = ((int)blockIdx.x + it * (int)gridDim.x) * ng + g;
      const bool live = row < rows;     // the same for the whole group
      float r = 0.f;
      if (BWD && live) r = rstd[row];   // in flight while the tile lands
      mbar_wait(full + 8 * s, (it / stages) & 1);
      const T* sx = reinterpret_cast<const T*>(
          smem + (size_t)s * stage_bytes + (size_t)g * row_bytes);
      const T* sdy = sx + (size_t)ng * d;

      // pass 1: sum(x^2) (forward) or sum(dy * w * x) (backward), one
      // partial per virtual warp
      float acc[VWN];
#pragma unroll
      for (int i = 0; i < VWN; ++i) acc[i] = 0.f;
      if (live) {
#pragma unroll
        for (int kk = 0; kk < KMAX; ++kk)
#pragma unroll
          for (int i = 0; i < VWN; ++i) {
            const int c = lane + 32 * (p + GW * i) + 32 * VWARPS * kk;
            if (c >= nv) continue;
            float xv[N];
            load_vec16<T>(sx + c * N, xv);
            if constexpr (BWD) {
              float gv[N], wv[N];
              load_vec16<T>(sdy + c * N, gv);
              load_vec16<T>(sw + c * N, wv);
#pragma unroll
              for (int e = 0; e < N; ++e)
                acc[i] = fmaf(gv[e] * wv[e], xv[e], acc[i]);
            } else {
#pragma unroll
              for (int e = 0; e < N; ++e) acc[i] = fmaf(xv[e], xv[e], acc[i]);
            }
          }
      }
      // each virtual warp's sum by xor shuffles, then the 8 sums in
      // virtual-warp order (through shared memory when the group has
      // several warps: two sets of slots, so a tile's writes never meet
      // the previous tile's reads)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int i = 0; i < VWN; ++i)
          acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], off);
      float total = 0.f;
      if constexpr (GW == 1) {
#pragma unroll
        for (int i = 0; i < VWARPS; ++i) total += acc[i];
      } else {
        float* sums = red + ((it & 1) * MAX_WARPS + g) * VWARPS;
        if (lane == 0) {
#pragma unroll
          for (int i = 0; i < VWN; ++i) sums[p + GW * i] = acc[i];
        }
        named_barrier(1 + g, GW * 32);
#pragma unroll
        for (int v = 0; v < VWARPS; ++v) total += sums[v];
      }

      // pass 2: the row's output from shared memory to device memory
      if (live) {
        T* orow = out + (size_t)row * d;
        if constexpr (BWD) {
          const float a = r * r * r * total * inv_d;
#pragma unroll
          for (int kk = 0; kk < KMAX; ++kk)
#pragma unroll
            for (int i = 0; i < VWN; ++i) {
              const int c = lane + 32 * (p + GW * i) + 32 * VWARPS * kk;
              if (c >= nv) continue;
              float xv[N], gv[N], wv[N], o[N];
              load_vec16<T>(sx + c * N, xv);
              load_vec16<T>(sdy + c * N, gv);
              load_vec16<T>(sw + c * N, wv);
#pragma unroll
              for (int e = 0; e < N; ++e) {
                o[e] = r * (gv[e] * wv[e]) - xv[e] * a;
                dwa[kk][i][e] = fmaf(
                    gv[e], to_float(from_float<T>(xv[e] * r)), dwa[kk][i][e]);
              }
              store_vec16<T>(orow + c * N, o);
            }
        } else {
          r = rsqrtf(total / (float)d + eps);
          if (rstd && p == 0 && lane == 0) rstd[row] = r;
#pragma unroll
          for (int kk = 0; kk < KMAX; ++kk)
#pragma unroll
            for (int i = 0; i < VWN; ++i) {
              const int c = lane + 32 * (p + GW * i) + 32 * VWARPS * kk;
              if (c >= nv) continue;
              float xv[N], wv[N], o[N];
              load_vec16<T>(sx + c * N, xv);
              load_vec16<T>(sw + c * N, wv);
#pragma unroll
              for (int e = 0; e < N; ++e)
                o[e] = to_float(from_float<T>(xv[e] * r)) * wv[e];
              store_vec16<T>(orow + c * N, o);
            }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }
  }

  if constexpr (BWD) {
    // the block's dw partial: its groups' partials added in group order,
    // through the drained ring ([ng][d] f32 fits in it)
    __syncthreads();
    float* buf = reinterpret_cast<float*>(smem);
    if (warp < ncw) {
      const int g = warp / GW, p = warp % GW;
#pragma unroll
      for (int kk = 0; kk < KMAX; ++kk)
#pragma unroll
        for (int i = 0; i < VWN; ++i) {
          const int c = lane + 32 * (p + GW * i) + 32 * VWARPS * kk;
          if (c >= nv) continue;
#pragma unroll
          for (int e = 0; e < N; ++e)
            buf[(size_t)g * d + c * N + e] = dwa[kk][i][e];
        }
    }
    __syncthreads();
    for (int col = threadIdx.x; col < d; col += blockDim.x) {
      float t = 0.f;
      for (int q = 0; q < ng; ++q) t += buf[(size_t)q * d + col];
      dw_part[(size_t)blockIdx.x * d + col] = t;
    }
  }
}

// dw[col] = the sum of the blocks' partials: warp j of a block adds
// partials j, j + DW_WARPS, ... of its 32 columns, then warp 0 adds the
// warps' sums in warp order.
template <typename T>
__global__ void __launch_bounds__(DW_WARPS * 32)
rmsnorm_dw_kernel(const float* __restrict__ dw_part, T* __restrict__ dw,
                  int blocks, int d) {
  __shared__ float sums[DW_WARPS][32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (col < d) {
#pragma unroll 4
    for (int b = warp; b < blocks; b += DW_WARPS)
      s += dw_part[(size_t)b * d + col];
  }
  sums[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && col < d) {
    float t = 0.f;
#pragma unroll
    for (int j = 0; j < DW_WARPS; ++j) t += sums[j][lane];
    dw[col] = from_float<T>(t);
  }
}

template <typename T, bool BWD, int GW>
cudaError_t launch_gw(const void* x, const void* w, const void* dy,
                      float* rstd, void* out, float* dw_part, int rows, int d,
                      float eps, const Plan& p, cudaStream_t stream) {
  auto kern = rmsnorm_kernel<T, BWD, GW>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) return err;
  kern<<<p.blocks, (p.ng * GW + 1) * 32, p.smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(dy), rstd, static_cast<T*>(out), dw_part, rows,
      d, eps, p.ng, p.stages);
  return cudaGetLastError();
}

template <typename T, bool BWD>
cudaError_t launch(const void* x, const void* w, const void* dy, float* rstd,
                   void* out, float* dw_part, int rows, int d, float eps,
                   const Plan& p, cudaStream_t stream) {
  switch (p.gw) {
    case 1:   // f32 only: a bf16 row group has at least 2 warps
      if constexpr (sizeof(T) == 4)
        return launch_gw<T, BWD, 1>(x, w, dy, rstd, out, dw_part, rows, d,
                                    eps, p, stream);
      break;
    case 2:
      return launch_gw<T, BWD, 2>(x, w, dy, rstd, out, dw_part, rows, d, eps,
                                  p, stream);
    case 4:
      return launch_gw<T, BWD, 4>(x, w, dy, rstd, out, dw_part, rows, d, eps,
                                  p, stream);
    case 8:
      return launch_gw<T, BWD, 8>(x, w, dy, rstd, out, dw_part, rows, d, eps,
                                  p, stream);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_bwd(const void* x, const void* w, const void* dy,
                       const float* rstd, void* dx, void* dw, float* dw_part,
                       int rows, int d, int max_blocks, cudaStream_t stream) {
  const Plan p = make_plan(rows, d, sizeof(T), true, max_blocks);
  cudaError_t err = launch<T, true>(x, w, dy, const_cast<float*>(rstd), dx,
                                    dw_part, rows, d, 0.f, p, stream);
  if (err != cudaSuccess) return err;
  rmsnorm_dw_kernel<T><<<(d + 31) / 32, DW_WARPS * 32, 0, stream>>>(
      dw_part, static_cast<T*>(dw), p.blocks, d);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// C entries bound with ctypes. dtype: 0 = float32, 1 = bfloat16. x, w, y,
// dy, dx are contiguous and 16-byte aligned, d a multiple of 8 and at
// most 8192. rstd (rows,) f32 may be null in the forward (not stored).
// At most `max_blocks` persistent blocks run (one per SM is the
// design); dw_part is (max_blocks, d) f32 scratch. Return a cudaError_t;
// 0 on a successful launch.
extern "C" int rmsnorm_fwd(const void* x, const void* w, void* y,
                           float* rstd, int rows, int d, float eps,
                           int max_blocks, int dtype, void* stream) {
  using namespace repro_torch;
  if (rows == 0) return 0;
  if (d <= 0 || d % 8 || d > MAX_D || max_blocks < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float, false>(
        x, w, nullptr, rstd, y, nullptr, rows, d, eps,
        make_plan(rows, d, 4, false, max_blocks), s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16, false>(
        x, w, nullptr, rstd, y, nullptr, rows, d, eps,
        make_plan(rows, d, 2, false, max_blocks), s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int rmsnorm_bwd(const void* x, const void* w, const void* dy,
                           const float* rstd, void* dx, void* dw,
                           float* dw_part, int rows, int d, int max_blocks,
                           int dtype, void* stream) {
  using namespace repro_torch;
  if (rows == 0) return 0;
  if (d <= 0 || d % 8 || d > MAX_D || max_blocks < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_bwd<float>(x, w, dy, rstd, dx, dw, dw_part, rows, d,
                                  max_blocks, s);
  if (dtype == 1)
    return (int)launch_bwd<__nv_bfloat16>(x, w, dy, rstd, dx, dw, dw_part,
                                          rows, d, max_blocks, s);
  return (int)cudaErrorInvalidValue;
}
