// Flash-attention prefill (causal / sliding-window GQA) for Hopper, sm_90a.
//
// Replaces the TPU kernel `flash_attention_pallas` (`_flash_kernel`,
// src/repro/kernels/flash_prefill.py). Computes, for q (B,Sq,H,D) and
// k/v (B,Skv,KV,D) with H % KV == 0:
//   out[b,i,h] = softmax_j(scale * q[b,i,h] . k[b,j,h/G]) v[b,j,h/G]
// over keys j that are causal (q_pos >= j, q_pos = q_offset[b] + i),
// inside the window (j > q_pos - window, when window > 0) and valid
// (j < kv_len[b]). Unlike the Pallas kernel, `kv_len` and `q_offset` are
// runtime values (a pointer to (B,) int32, or null / a scalar), so both
// engine callers -- whole-prompt prefill (kv_len = prompt_len) and the
// two-call chunk path (runtime q_offset) -- run on this kernel.
//
// Bound on the H100: at serving shapes (one prompt of 256-1024 tokens,
// D = 64 / 128) the arithmetic intensity of the tensor-core version would
// put this above the ridge; this first version runs the two products on
// the f32 CUDA cores (no mma / wgmma yet), so it is bound by CUDA-core
// FMA issue and shared-memory reads, not by bytes. The design keeps every
// intermediate on chip: one block per (q-tile of 64 rows, head, batch),
// a loop over 64-key tiles in place of the TPU's sequential grid axis,
// online-softmax state (m, l) and the output accumulator in registers,
// f32 accumulation throughout, and key tiles above the causal diagonal,
// past kv_len or before the window skipped outright. Scores go to
// shared memory only to turn the row-split QK^T into the column-split PV.
//
// Semantics follow `ref.flash_attention_reference`: q is scaled before
// QK^T, masked scores are -1e30 (not -inf), and the final normaliser is
// clamped at 1e-30. A row with no valid key at all comes out finite (0
// when every tile is skipped); its value is not otherwise specified.
//
// With a non-null `lse` (f32, (B, H, Sq)) each row's log-sum-exp of its
// scaled, masked scores, m + log(max(l, 1e-30)), is written too: the
// backward kernels (flash_backward.cu) recompute P from it.
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 256;  // 16 x 16 thread grid
constexpr int RPT = BQ / 16;  // rows per thread (row ty + 16 i)
constexpr int CPT = BK / 16;  // score columns per thread (col tx + 16 j)

template <int D>
constexpr size_t smem_bytes() {
  // Qs[BQ][D+1], Ks[BK][D+1], Vs[BK][D], Ps[BQ][BK+1], all f32
  return sizeof(float) *
         (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, const int* __restrict__ kv_len,
                 const int* __restrict__ q_offset, int q_offset_scalar,
                 int Sq, int Skv, int H, int KV, int causal, int window,
                 float scale) {
  constexpr int OPT = D / 16;  // output columns per thread (col tx + 16 j)
  extern __shared__ float smem[];
  float* Qs = smem;                  // [BQ][D+1]
  float* Ks = Qs + BQ * (D + 1);     // [BK][D+1]
  float* Vs = Ks + BK * (D + 1);     // [BK][D]
  float* Ps = Vs + BK * D;           // [BQ][BK+1]

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const int kvh = h / G;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  const int q0 = qt * BQ;                        // first local q row
  const int q_rows = min(BQ, Sq - q0);
  const int qoff = q_offset ? q_offset[b] : q_offset_scalar;
  const int kvl = kv_len ? min(kv_len[b], Skv) : Skv;

  // key range any row of this tile can see: tiles outside it are dead
  const int q_first = qoff + q0, q_last = qoff + q0 + q_rows - 1;
  int k_end = kvl;
  if (causal) k_end = min(k_end, q_last + 1);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q_first - window + 1);
  const int kt_begin = k_begin / BK;
  const int kt_end = k_end > 0 ? (k_end + BK - 1) / BK : 0;

  const T* qb = q + ((size_t)b * Sq * H + h) * D;        // row stride H*D
  const T* kb = k + ((size_t)b * Skv * KV + kvh) * D;    // row stride KV*D
  const T* vb = v + ((size_t)b * Skv * KV + kvh) * D;

  load_tile<T, D, THREADS>(qb, q0, BQ, Sq, H * D, Qs, D + 1, scale);

  float m[RPT], l[RPT], o[RPT][OPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < OPT; ++j) o[i][j] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // previous tile's PV is done with Vs / Ps
    load_tile<T, D, THREADS>(kb, k0, BK, Skv, KV * D, Ks, D + 1, 1.f);
    load_tile<T, D, THREADS>(vb, k0, BK, Skv, KV * D, Vs, D, 1.f);
    __syncthreads();

    // S = (q * scale) K^T for rows ty + 16 i, cols tx + 16 j
    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = Qs[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = Ks[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // mask, then the online-softmax update; the 16 threads that share a
    // row (same ty, one half-warp) reduce over their columns by shuffle
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int qpos = qoff + q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int kpos = k0 + tx + 16 * j;
        bool ok = kpos < kvl;
        if (causal) ok = ok && (qpos >= kpos);
        if (window > 0) ok = ok && (kpos > qpos - window);
        if (!ok) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        Ps[(ty + 16 * i) * (BK + 1) + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < OPT; ++j) o[i][j] *= corr;
    }
    __syncthreads();

    // O += P V for rows ty + 16 i, output columns tx + 16 j
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[RPT], vv[OPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = Ps[(ty + 16 * i) * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < OPT; ++j) vv[j] = Vs[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < OPT; ++j) o[i][j] = fmaf(pv[i], vv[j], o[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = ty + 16 * i;
    if (r >= q_rows) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    if (lse && tx == 0)
      lse[((size_t)b * H + h) * Sq + q0 + r] =
          m[i] + logf(fmaxf(l[i], 1e-30f));
    T* orow = out + (((size_t)b * Sq + q0 + r) * H + h) * D;
#pragma unroll
    for (int j = 0; j < OPT; ++j)
      orow[tx + 16 * j] = from_float<T>(o[i][j] * inv);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, const int* kv_len, const int* q_offset,
                   int q_offset_scalar, int B, int Sq, int Skv, int H,
                   int KV, int causal, int window, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kern = flash_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, kv_len, q_offset,
      q_offset_scalar, Sq, Skv, H, KV, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// C entry bound with ctypes. dtype: 0 = float32, 1 = bfloat16. lse,
// kv_len and q_offset may be null (no log-sum-exp / all keys valid / use
// q_offset_scalar). Returns a cudaError_t; 0 on a successful launch.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, float* lse,
                                   const int* kv_len, const int* q_offset,
                                   int q_offset_scalar, int B, int Sq,
                                   int Skv, int H, int KV, int D, int causal,
                                   int window, float scale, int dtype,
                                   void* stream) {
  using namespace repro_torch;
  if (B == 0 || Sq == 0 || H == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_FLASH_CASE(T, DD)                                             \
  return (int)launch<T, DD>(q, k, v, out, lse, kv_len, q_offset,            \
                            q_offset_scalar, B, Sq, Skv, H, KV, causal,     \
                            window, scale, s)
  if (dtype == 0 && D == 64) REPRO_FLASH_CASE(float, 64);
  if (dtype == 0 && D == 128) REPRO_FLASH_CASE(float, 128);
  if (dtype == 1 && D == 64) REPRO_FLASH_CASE(__nv_bfloat16, 64);
  if (dtype == 1 && D == 128) REPRO_FLASH_CASE(__nv_bfloat16, 128);
#undef REPRO_FLASH_CASE
  return (int)cudaErrorInvalidValue;
}
