// Helpers shared by the port's kernels: 16-byte vector loads and stores
// of bf16 / f32 rows converted to and from f32, the f32 tile loader of
// the flash kernels, and the dtype codes the ctypes wrappers pass
// (0 = float32, 1 = bfloat16).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

constexpr float kNegInf = -1e30f;  // the reference's mask value, never -inf

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Elements of T in one 16-byte load.
template <typename T>
struct Vec16 {
  static constexpr int N = 16 / sizeof(T);
};

// Load Vec16<T>::N consecutive elements at `src` (16-byte aligned) and
// widen them to f32.
template <typename T>
__device__ __forceinline__ void load_vec16(const T* src, float* dst) {
  uint4 raw = *reinterpret_cast<const uint4*>(src);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < Vec16<T>::N; ++i) dst[i] = to_float(e[i]);
}

// Round Vec16<T>::N f32 values to T and store them at `dst` (16-byte
// aligned) in one 16-byte store.
template <typename T>
__device__ __forceinline__ void store_vec16(T* dst, const float* src) {
  uint4 raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int i = 0; i < Vec16<T>::N; ++i) e[i] = from_float<T>(src[i]);
  *reinterpret_cast<uint4*>(dst) = raw;
}

// Copy rows [row0, row0 + nrows) of a (.., rows, heads, D) tensor's head
// (at `base`, rows `row_stride` elements apart) into a f32 shared tile
// with row pitch `pitch`, each value times `mul`; rows >= valid are
// zero-filled. Called by all NT threads of the block.
template <typename T, int D, int NT>
__device__ __forceinline__ void load_tile(const T* base, int row0, int nrows,
                                          int valid, int row_stride,
                                          float* tile, int pitch, float mul) {
  constexpr int N = Vec16<T>::N;
  constexpr int VPR = D / N;  // vectors per row
  for (int idx = threadIdx.x; idx < nrows * VPR; idx += NT) {
    const int r = idx / VPR;
    const int c = (idx % VPR) * N;
    float vals[N];
    if (row0 + r < valid) {
      load_vec16<T>(base + (size_t)(row0 + r) * row_stride + c, vals);
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) vals[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < N; ++i) tile[r * pitch + c + i] = vals[i] * mul;
  }
}

}  // namespace repro_torch
