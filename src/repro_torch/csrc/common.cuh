// Helpers shared by the port's kernels: 16-byte vector loads and stores
// of bf16 / f32 rows converted to and from f32, and the dtype codes the
// ctypes wrappers pass (0 = float32, 1 = bfloat16).
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

}  // namespace repro_torch
