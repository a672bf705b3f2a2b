// Flash-attention backward (causal / sliding-window GQA) for Hopper, sm_90a.
//
// The gradient of the port's flash attention (csrc/flash_prefill.cu,
// which replaces `flash_attention_pallas`, src/repro/kernels/
// flash_prefill.py). The JAX package has no Pallas backward: its training
// differentiates the jnp reference. For q (B,Sq,H,D), k/v (B,Skv,KV,D),
// the forward's output o and per-row log-sum-exp lse (B,H,Sq) and the
// output gradient dout, with s = (scale q) . k:
//   P     = exp(s - lse)              (0 where masked)
//   Delta = rowsum(dout * o)
//   dS    = P * (dout v^T - Delta)
//   dq    = scale * dS k,   dk = dS^T (scale q),   dv = P^T dout
// P is recomputed from q, k and lse, never stored. Masking is the
// forward's: causal (q_offset + i >= j) and, with window > 0,
// j > q_offset + i - window; every key j < Skv is valid. s is formed
// with the forward's f32 FMA order, so exp(s - lse) is the P the
// forward normalised.
//
// Two kernels, in stream order:
//   dq    one block per (q-tile of 64 rows, head, batch): loops over the
//         key tiles the tile can see; also writes Delta (B,H,Sq) f32.
//   dkdv  one block per (key tile of 64, KV head, batch): loops over the
//         G query heads of its group and the q tiles that can see the
//         key tile, so every dk / dv row has one writer and GQA needs no
//         atomics.
// Bound on the H100: like the forward, this first version runs its
// products on the f32 CUDA cores (no mma / wgmma yet): five 64 x 64 x D
// products per (q tile, key tile) pair against the forward's two, so it
// is bound by FMA issue and shared-memory reads, not by bytes. Every
// intermediate (P, dS, the accumulators) stays on chip; f32 throughout.
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 256;  // 16 x 16 thread grid
constexpr int RPT = 4;        // tile rows per thread (row ty + 16 i)
constexpr int CPT = 4;        // tile columns per thread (col tx + 16 j)

__device__ __forceinline__ bool visible(int qpos, int kpos, int causal,
                                        int window) {
  return (!causal || qpos >= kpos) && (window <= 0 || kpos > qpos - window);
}

template <int D>
constexpr size_t dq_smem_bytes() {
  // Qs, dOs, Ks, Vs [64][D+1]; Ss [BQ][BK+1]; Ls, Dl [BQ]; all f32
  return sizeof(float) * (4 * 64 * (D + 1) + BQ * (BK + 1) + 2 * BQ);
}

template <int D>
constexpr size_t dkdv_smem_bytes() {
  // Ks, Vs, Qs, dOs [64][D+1]; Pt, dSt [BK][BQ+1]; Ls, Dl [BQ]; all f32
  return sizeof(float) * (4 * 64 * (D + 1) + 2 * BK * (BQ + 1) + 2 * BQ);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    float* __restrict__ delta, T* __restrict__ dq, int Sq,
                    int Skv, int H, int KV, int q_offset, int causal,
                    int window, float scale) {
  constexpr int OPT = D / 16;  // head-dim columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                  // [BQ][D+1], q * scale
  float* dOs = Qs + BQ * (D + 1);    // [BQ][D+1]
  float* Ks = dOs + BQ * (D + 1);    // [BK][D+1]
  float* Vs = Ks + BK * (D + 1);     // [BK][D+1]
  float* Ss = Vs + BK * (D + 1);     // [BQ][BK+1], dS
  float* Ls = Ss + BQ * (BK + 1);    // [BQ], lse
  float* Dl = Ls + BQ;               // [BQ], Delta

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = qt * BQ;
  const int q_rows = min(BQ, Sq - q0);
  const int q_first = q_offset + q0, q_last = q_first + q_rows - 1;
  int k_end = Skv;
  if (causal) k_end = min(k_end, q_last + 1);
  const int k_begin = window > 0 ? max(0, q_first - window + 1) : 0;
  const int kt_begin = k_begin / BK;
  const int kt_end = k_end > 0 ? (k_end + BK - 1) / BK : 0;

  const size_t qhead = ((size_t)b * Sq * H + h) * D;   // row stride H*D
  const T* kb = k + ((size_t)b * Skv * KV + kvh) * D;  // row stride KV*D
  const T* vb = v + ((size_t)b * Skv * KV + kvh) * D;
  const size_t lrow = ((size_t)b * H + h) * Sq + q0;

  load_tile<T, D, THREADS>(q + qhead, q0, BQ, Sq, H * D, Qs, D + 1, scale);
  load_tile<T, D, THREADS>(dout + qhead, q0, BQ, Sq, H * D, dOs, D + 1, 1.f);
  __syncthreads();

  // Delta = rowsum(dout * o): the 16 threads of a row (one half-warp)
  // reduce over their columns by shuffle
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = ty + 16 * i;
    float acc = 0.f;
    if (r < q_rows) {
      const T* orow = o + qhead + (size_t)(q0 + r) * H * D;
#pragma unroll
      for (int j = 0; j < OPT; ++j)
        acc = fmaf(dOs[r * (D + 1) + tx + 16 * j], to_float(orow[tx + 16 * j]),
                   acc);
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (tx == 0) {
      Dl[r] = acc;
      Ls[r] = r < q_rows ? lse[lrow + r] : 0.f;
      if (r < q_rows) delta[lrow + r] = acc;
    }
  }

  float acc[RPT][OPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < OPT; ++j) acc[i][j] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // previous tile's dS K is done with Ks / Ss
    load_tile<T, D, THREADS>(kb, k0, BK, Skv, KV * D, Ks, D + 1, 1.f);
    load_tile<T, D, THREADS>(vb, k0, BK, Skv, KV * D, Vs, D + 1, 1.f);
    __syncthreads();

    // S = (q * scale) K^T and dP = dout V^T, rows ty + 16 i, cols tx + 16 j
    float s[RPT][CPT], dp[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      float qv[RPT], ov[RPT], kv[CPT], vv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        qv[i] = Qs[(ty + 16 * i) * (D + 1) + d];
        ov[i] = dOs[(ty + 16 * i) * (D + 1) + d];
      }
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        kv[j] = Ks[(tx + 16 * j) * (D + 1) + d];
        vv[j] = Vs[(tx + 16 * j) * (D + 1) + d];
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int c = tx + 16 * j;
        const bool ok = r < q_rows && k0 + c < Skv &&
                        visible(q_first + r, k0 + c, causal, window);
        const float p = ok ? expf(s[i][j] - Ls[r]) : 0.f;
        Ss[r * (BK + 1) + c] = p * (dp[i][j] - Dl[r]);
      }
    }
    __syncthreads();

    // dq += dS K
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float sv[RPT], kv[OPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) sv[i] = Ss[(ty + 16 * i) * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < OPT; ++j) kv[j] = Ks[c * (D + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < OPT; ++j) acc[i][j] = fmaf(sv[i], kv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = ty + 16 * i;
    if (r >= q_rows) continue;
    T* row = dq + qhead + (size_t)(q0 + r) * H * D;
#pragma unroll
    for (int j = 0; j < OPT; ++j)
      row[tx + 16 * j] = from_float<T>(acc[i][j] * scale);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int Sq, int Skv, int H, int KV,
                      int q_offset, int causal, int window, float scale) {
  constexpr int OPT = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;                  // [BK][D+1]
  float* Vs = Ks + BK * (D + 1);     // [BK][D+1]
  float* Qs = Vs + BK * (D + 1);     // [BQ][D+1], q * scale
  float* dOs = Qs + BQ * (D + 1);    // [BQ][D+1]
  float* Pt = dOs + BQ * (D + 1);    // [BK][BQ+1], P^T
  float* dSt = Pt + BK * (BQ + 1);   // [BK][BQ+1], dS^T
  float* Ls = dSt + BK * (BQ + 1);   // [BQ]
  float* Dl = Ls + BQ;               // [BQ]

  const int kt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int k0 = kt * BK;
  const int k_rows = min(BK, Skv - k0);
  const size_t khead = ((size_t)b * Skv * KV + kvh) * D;  // row stride KV*D

  load_tile<T, D, THREADS>(k + khead, k0, BK, Skv, KV * D, Ks, D + 1, 1.f);
  load_tile<T, D, THREADS>(v + khead, k0, BK, Skv, KV * D, Vs, D + 1, 1.f);

  // query rows i (position q_offset + i) that can see a key of this tile
  const int i_begin = causal ? max(0, k0 - q_offset) : 0;
  int i_end = Sq;
  if (window > 0) i_end = min(i_end, k0 + k_rows - 1 + window - q_offset);
  const int qt_begin = i_begin / BQ;
  const int qt_end = i_end > i_begin ? (i_end + BQ - 1) / BQ : qt_begin;

  float dka[RPT][OPT], dva[RPT][OPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < OPT; ++j) dka[i][j] = dva[i][j] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const size_t qhead = ((size_t)b * Sq * H + h) * D;   // row stride H*D
    const size_t lhead = ((size_t)b * H + h) * Sq;
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q0 = qt * BQ;
      const int q_rows = min(BQ, Sq - q0);
      __syncthreads();  // previous products are done with Qs, dOs, Pt, dSt
      load_tile<T, D, THREADS>(q + qhead, q0, BQ, Sq, H * D, Qs, D + 1,
                               scale);
      load_tile<T, D, THREADS>(dout + qhead, q0, BQ, Sq, H * D, dOs, D + 1,
                               1.f);
      for (int r = threadIdx.x; r < BQ; r += THREADS) {
        Ls[r] = r < q_rows ? lse[lhead + q0 + r] : 0.f;
        Dl[r] = r < q_rows ? delta[lhead + q0 + r] : 0.f;
      }
      __syncthreads();

      // S^T = K (q * scale)^T and dP^T = V dout^T: rows are keys
      // ty + 16 i, columns queries tx + 16 j
      float st[RPT][CPT], dpt[RPT][CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 2
      for (int d = 0; d < D; ++d) {
        float kv[RPT], vv[RPT], qv[CPT], ov[CPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          kv[i] = Ks[(ty + 16 * i) * (D + 1) + d];
          vv[i] = Vs[(ty + 16 * i) * (D + 1) + d];
        }
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          qv[j] = Qs[(tx + 16 * j) * (D + 1) + d];
          ov[j] = dOs[(tx + 16 * j) * (D + 1) + d];
        }
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < CPT; ++j) {
            st[i][j] = fmaf(qv[j], kv[i], st[i][j]);
            dpt[i][j] = fmaf(ov[j], vv[i], dpt[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int kc = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const int qc = tx + 16 * j;
          const bool ok = kc < k_rows && qc < q_rows &&
                          visible(q_offset + q0 + qc, k0 + kc, causal, window);
          const float p = ok ? expf(st[i][j] - Ls[qc]) : 0.f;
          Pt[kc * (BQ + 1) + qc] = p;
          dSt[kc * (BQ + 1) + qc] = p * (dpt[i][j] - Dl[qc]);
        }
      }
      __syncthreads();

      // dv += P^T dout, dk += dS^T (q * scale)
#pragma unroll 2
      for (int c = 0; c < BQ; ++c) {
        float pv[RPT], sv[RPT], ov[OPT], qv[OPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          pv[i] = Pt[(ty + 16 * i) * (BQ + 1) + c];
          sv[i] = dSt[(ty + 16 * i) * (BQ + 1) + c];
        }
#pragma unroll
        for (int j = 0; j < OPT; ++j) {
          ov[j] = dOs[c * (D + 1) + tx + 16 * j];
          qv[j] = Qs[c * (D + 1) + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < OPT; ++j) {
            dva[i][j] = fmaf(pv[i], ov[j], dva[i][j]);
            dka[i][j] = fmaf(sv[i], qv[j], dka[i][j]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int kc = ty + 16 * i;
    if (kc >= k_rows) continue;
    const size_t off = khead + (size_t)(k0 + kc) * KV * D;
#pragma unroll
    for (int j = 0; j < OPT; ++j) {
      dk[off + tx + 16 * j] = from_float<T>(dka[i][j]);
      dv[off + tx + 16 * j] = from_float<T>(dva[i][j]);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const float* lse,
                   float* delta, void* dq, void* dk, void* dv, int B, int Sq,
                   int Skv, int H, int KV, int q_offset, int causal,
                   int window, float scale, cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  if (Sq > 0) {
    constexpr size_t smem = dq_smem_bytes<D>();
    auto kern = flash_bwd_dq_kernel<T, D>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid((Sq + BQ - 1) / BQ, H, B);
    kern<<<grid, THREADS, smem, stream>>>(
        qt, kt, vt, static_cast<const T*>(o), dot, lse, delta,
        static_cast<T*>(dq), Sq, Skv, H, KV, q_offset, causal, window, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (Skv > 0) {
    constexpr size_t smem = dkdv_smem_bytes<D>();
    auto kern = flash_bwd_dkdv_kernel<T, D>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid((Skv + BK - 1) / BK, KV, B);
    kern<<<grid, THREADS, smem, stream>>>(
        qt, kt, vt, dot, lse, delta, static_cast<T*>(dk),
        static_cast<T*>(dv), Sq, Skv, H, KV, q_offset, causal, window, scale);
    return cudaGetLastError();
  }
  return cudaSuccess;
}

}  // namespace
}  // namespace repro_torch

// C entry bound with ctypes. dtype: 0 = float32, 1 = bfloat16. lse is the
// forward's (B, H, Sq) f32 log-sum-exp; delta is (B, H, Sq) f32 scratch.
// Returns a cudaError_t; 0 on a successful launch.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const float* lse,
                                   float* delta, void* dq, void* dk,
                                   void* dv, int B, int Sq, int Skv, int H,
                                   int KV, int D, int q_offset, int causal,
                                   int window, float scale, int dtype,
                                   void* stream) {
  using namespace repro_torch;
  if (B == 0 || H == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_FLASH_BWD_CASE(T, DD)                                          \
  return (int)launch<T, DD>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, \
                            Skv, H, KV, q_offset, causal, window, scale, s)
  if (dtype == 0 && D == 64) REPRO_FLASH_BWD_CASE(float, 64);
  if (dtype == 0 && D == 128) REPRO_FLASH_BWD_CASE(float, 128);
  if (dtype == 1 && D == 64) REPRO_FLASH_BWD_CASE(__nv_bfloat16, 64);
  if (dtype == 1 && D == 128) REPRO_FLASH_BWD_CASE(__nv_bfloat16, 128);
#undef REPRO_FLASH_BWD_CASE
  return (int)cudaErrorInvalidValue;
}
