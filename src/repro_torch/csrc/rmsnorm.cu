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
// per row in f32, with g = dy * w:
//   dx = r * g - x * r^3 * mean(g * x)
//   dw = sum over rows of dy * T(x * r)
// `dw` is reduced without atomics: each block sums its rows into f32
// partials in shared memory and writes them to a (blocks, d) buffer; a
// second kernel sums the partials per column in block order, so the
// result does not depend on scheduling.
//
// Bound on the H100: bytes. Each row is read once from device memory and
// written once (the second pass over a row hits L1); the f32 sums stay
// in registers. One block per row in the forward; the backward's blocks
// each take a run of rows so the dw partials stay few.
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int THREADS = 256;

// Sum of `v` over the block, the same value in every thread (the warp
// partials are added in one fixed order). `scratch` holds THREADS / 32
// floats; the leading barrier lets a call reuse it right after another.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  __syncthreads();
  if (threadIdx.x % 32 == 0) scratch[threadIdx.x / 32] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int i = 0; i < THREADS / 32; ++i) t += scratch[i];
  return t;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
rmsnorm_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   T* __restrict__ y, float* __restrict__ rstd, int d,
                   float eps) {
  constexpr int N = Vec16<T>::N;
  __shared__ float scratch[THREADS / 32];
  const int nv = d / N;
  const T* xr = x + (size_t)blockIdx.x * d;
  T* yr = y + (size_t)blockIdx.x * d;
  float ss = 0.f;
  for (int c = threadIdx.x; c < nv; c += THREADS) {
    float xv[N];
    load_vec16<T>(xr + c * N, xv);
#pragma unroll
    for (int i = 0; i < N; ++i) ss = fmaf(xv[i], xv[i], ss);
  }
  const float r = rsqrtf(block_sum(ss, scratch) / (float)d + eps);
  if (rstd && threadIdx.x == 0) rstd[blockIdx.x] = r;
  for (int c = threadIdx.x; c < nv; c += THREADS) {
    float xv[N], wv[N], out[N];
    load_vec16<T>(xr + c * N, xv);
    load_vec16<T>(w + c * N, wv);
#pragma unroll
    for (int i = 0; i < N; ++i)
      out[i] = to_float(from_float<T>(xv[i] * r)) * wv[i];
    store_vec16<T>(yr + c * N, out);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
rmsnorm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const T* __restrict__ dy, const float* __restrict__ rstd,
                   T* __restrict__ dx, float* __restrict__ dw_part, int rows,
                   int d, int rows_per_block) {
  constexpr int N = Vec16<T>::N;
  extern __shared__ float dw_acc[];   // [d]: this block's dw partial
  __shared__ float scratch[THREADS / 32];
  const int nv = d / N;
  // each thread owns the columns of its vectors c = tid + k * THREADS,
  // in dw_acc as in every row, so no two threads touch one entry
  for (int c = threadIdx.x; c < nv; c += THREADS)
#pragma unroll
    for (int i = 0; i < N; ++i) dw_acc[c * N + i] = 0.f;
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(rows, r0 + rows_per_block);
  const float inv_d = 1.f / (float)d;
  for (int row = r0; row < r1; ++row) {
    const T* xr = x + (size_t)row * d;
    const T* dyr = dy + (size_t)row * d;
    const float r = rstd[row];
    float gx = 0.f;
    for (int c = threadIdx.x; c < nv; c += THREADS) {
      float xv[N], wv[N], gv[N];
      load_vec16<T>(xr + c * N, xv);
      load_vec16<T>(w + c * N, wv);
      load_vec16<T>(dyr + c * N, gv);
#pragma unroll
      for (int i = 0; i < N; ++i) gx = fmaf(gv[i] * wv[i], xv[i], gx);
    }
    const float a = r * r * r * block_sum(gx, scratch) * inv_d;
    for (int c = threadIdx.x; c < nv; c += THREADS) {
      float xv[N], wv[N], gv[N], out[N];
      load_vec16<T>(xr + c * N, xv);
      load_vec16<T>(w + c * N, wv);
      load_vec16<T>(dyr + c * N, gv);
#pragma unroll
      for (int i = 0; i < N; ++i) {
        out[i] = r * (gv[i] * wv[i]) - xv[i] * a;
        dw_acc[c * N + i] =
            fmaf(gv[i], to_float(from_float<T>(xv[i] * r)), dw_acc[c * N + i]);
      }
      store_vec16<T>(dx + (size_t)row * d + c * N, out);
    }
  }
  float* part = dw_part + (size_t)blockIdx.x * d;
  for (int c = threadIdx.x; c < nv; c += THREADS)
#pragma unroll
    for (int i = 0; i < N; ++i) part[c * N + i] = dw_acc[c * N + i];
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
rmsnorm_dw_kernel(const float* __restrict__ dw_part, T* __restrict__ dw,
                  int blocks, int d) {
  const int col = blockIdx.x * THREADS + threadIdx.x;
  if (col >= d) return;
  float s = 0.f;
  for (int b = 0; b < blocks; ++b) s += dw_part[(size_t)b * d + col];
  dw[col] = from_float<T>(s);
}

template <typename T>
cudaError_t launch_fwd(const void* x, const void* w, void* y, float* rstd,
                       int rows, int d, float eps, cudaStream_t stream) {
  rmsnorm_fwd_kernel<T><<<rows, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y),
      rstd, d, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* x, const void* w, const void* dy,
                       const float* rstd, void* dx, void* dw, float* dw_part,
                       int rows, int d, int blocks, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)d;
  auto kern = rmsnorm_bwd_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int rows_per_block = (rows + blocks - 1) / blocks;
  kern<<<blocks, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(dy), rstd, static_cast<T*>(dx), dw_part, rows, d,
      rows_per_block);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rmsnorm_dw_kernel<T><<<(d + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
      dw_part, static_cast<T*>(dw), blocks, d);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// C entries bound with ctypes. dtype: 0 = float32, 1 = bfloat16. x, w, y,
// dy, dx are contiguous and 16-byte aligned, d a multiple of 8. rstd
// (rows,) f32 may be null in the forward (not stored). dw_part is
// (blocks, d) f32 scratch, 1 <= blocks <= rows. Return a cudaError_t; 0
// on a successful launch.
extern "C" int rmsnorm_fwd(const void* x, const void* w, void* y,
                           float* rstd, int rows, int d, float eps, int dtype,
                           void* stream) {
  using namespace repro_torch;
  if (rows == 0) return 0;
  if (d <= 0 || d % 8) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_fwd<float>(x, w, y, rstd, rows, d, eps, s);
  if (dtype == 1)
    return (int)launch_fwd<__nv_bfloat16>(x, w, y, rstd, rows, d, eps, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int rmsnorm_bwd(const void* x, const void* w, const void* dy,
                           const float* rstd, void* dx, void* dw,
                           float* dw_part, int rows, int d, int blocks,
                           int dtype, void* stream) {
  using namespace repro_torch;
  if (rows == 0) return 0;
  if (d <= 0 || d % 8 || blocks < 1 || blocks > rows)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_bwd<float>(x, w, dy, rstd, dx, dw, dw_part, rows, d,
                                  blocks, s);
  if (dtype == 1)
    return (int)launch_bwd<__nv_bfloat16>(x, w, dy, rstd, dx, dw, dw_part,
                                          rows, d, blocks, s);
  return (int)cudaErrorInvalidValue;
}
