// Paged GQA decode attention for Hopper, sm_90a.
//
// Replaces the TPU kernel `paged_attention_pallas` (`_paged_kernel`,
// src/repro/kernels/paged_attention.py). One query token per sequence
// attends over KV kept in ONE pooled tensor of fixed-size blocks,
// pool (NB, BS, 2, KV, D) with [..., 0, :, :] = K and [..., 1, :, :] = V,
// addressed through block_table (B, MAXB) int32 and kv_len (B,) int32:
//   out[b,h] = softmax_t(scale * q[b,h] . K[t, h/G]) V[t, h/G],
//   t < kv_len[b], token t at pool[table[b, t / BS], t % BS].
//
// Bound on the H100: bytes. Each (sequence, KV head) streams its
// kv_len x D keys and values once and does 4 G flops per element, far
// below the card's ~295 flops/byte ridge at G <= 16. The design makes the
// one pass over the cache the only traffic: one block per (KV head,
// sequence) so the G query heads of a group share every K/V row it
// loads (the point of the TPU's (G, D) tile); the block reads its own
// table row and chases it in the kernel (the TPU prefetched it as
// scalars); rows are read as 16-byte vectors, 64 tokens per step, into
// shared memory; the online-softmax state stays on chip; and only tokens
// below kv_len are touched -- blocks at or past ceil(kv_len / BS) are
// never read. A row with kv_len = 0 (the executor's power-of-two pad rows,
// whose tables point at the trash block) reads nothing and writes 0, as
// the Pallas kernel's max(l, 1e-30) clamp does. Splitting the KV axis
// across blocks (flash-decoding) for small batches is later work.
//
// Semantics follow `ref.paged_attention_reference`: q scaled before the
// product, f32 accumulation, output in q's dtype.
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int TT = 64;        // tokens per step
constexpr int THREADS = 128;  // 4 warps
constexpr int MAX_G = 16;     // query heads per KV head held in registers

template <int D>
size_t smem_bytes(int G) {
  // Qs[G][D], Ks[TT][D+1], Vs[TT][D], Ss[G][TT], m/l/corr[G], all f32
  return sizeof(float) *
         ((size_t)G * D + TT * (D + 1) + TT * D + (size_t)G * TT + 3 * G);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ pool,
                    const int* __restrict__ table,
                    const int* __restrict__ kv_len, T* __restrict__ out,
                    int H, int KV, int BS, int MAXB, float scale) {
  constexpr int N = Vec16<T>::N;
  constexpr int VPR = D / N;               // 16-byte vectors per row
  constexpr int ACC = MAX_G * D / THREADS; // accumulators per thread
  extern __shared__ float smem[];
  const int G = H / KV;
  float* Qs = smem;                        // [G][D]
  float* Ks = Qs + G * D;                  // [TT][D+1]
  float* Vs = Ks + TT * (D + 1);           // [TT][D]
  float* Ss = Vs + TT * D;                 // [G][TT]
  float* Ms = Ss + G * TT;                 // [G] running max
  float* Ls = Ms + G;                      // [G] running normaliser
  float* Cs = Ls + G;                      // [G] this step's correction

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int kvl = kv_len[b];
  const int* trow = table + (size_t)b * MAXB;
  // element offsets inside one pool block: token stride, K/V stride
  const size_t tok_stride = (size_t)2 * KV * D;
  const size_t blk_stride = (size_t)BS * tok_stride;

  // the G query heads of this group: heads kvh*G .. kvh*G + G - 1
  const T* qg = q + ((size_t)b * H + (size_t)kvh * G) * D;
  for (int idx = tid; idx < G * VPR; idx += THREADS) {
    float vals[N];
    load_vec16<T>(qg + (size_t)idx * N, vals);
#pragma unroll
    for (int i = 0; i < N; ++i) Qs[idx * N + i] = vals[i] * scale;
  }
  for (int g = tid; g < G; g += THREADS) {
    Ms[g] = kNegInf;
    Ls[g] = 0.f;
  }
  float acc[ACC];
#pragma unroll
  for (int a = 0; a < ACC; ++a) acc[a] = 0.f;
  __syncthreads();  // Qs / Ms / Ls visible (also when kv_len == 0)

  for (int t0 = 0; t0 < kvl; t0 += TT) {
    __syncthreads();  // previous step is done with Ks / Vs / Ss
    // gather TT tokens' K and V rows of this KV head through the table
    for (int idx = tid; idx < TT * VPR; idx += THREADS) {
      const int r = idx / VPR, c = (idx % VPR) * N;
      const int t = t0 + r;
      float kv_[N], vv_[N];
      if (t < kvl) {
        const T* row = pool + (size_t)trow[t / BS] * blk_stride +
                       (size_t)(t % BS) * tok_stride + (size_t)kvh * D + c;
        load_vec16<T>(row, kv_);
        load_vec16<T>(row + (size_t)KV * D, vv_);
      } else {
#pragma unroll
        for (int i = 0; i < N; ++i) kv_[i] = vv_[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < N; ++i) {
        Ks[r * (D + 1) + c + i] = kv_[i];
        Vs[r * D + c + i] = vv_[i];
      }
    }
    __syncthreads();

    // scores for every (query head, token) pair of the step
    for (int idx = tid; idx < G * TT; idx += THREADS) {
      const int g = idx / TT, r = idx % TT;
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d)
        s = fmaf(Qs[g * D + d], Ks[r * (D + 1) + d], s);
      Ss[g * TT + r] = (t0 + r < kvl) ? s : kNegInf;
    }
    __syncthreads();

    // online softmax, one warp per query head
    for (int g = warp; g < G; g += THREADS / 32) {
      const float s0 = Ss[g * TT + lane], s1 = Ss[g * TT + lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = Ms[g];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      Ss[g * TT + lane] = p0;
      Ss[g * TT + lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        Cs[g] = corr;
        Ls[g] = Ls[g] * corr + sum;
        Ms[g] = m_new;
      }
    }
    __syncthreads();

    // acc[g, d] = acc * corr[g] + sum_t p[g, t] V[t, d]
#pragma unroll
    for (int a = 0; a < ACC; ++a) {
      const int idx = tid + a * THREADS;
      if (idx < G * D) {
        const int g = idx / D, d = idx % D;
        float o = acc[a] * Cs[g];
#pragma unroll 8
        for (int r = 0; r < TT; ++r) o = fmaf(Ss[g * TT + r], Vs[r * D + d], o);
        acc[a] = o;
      }
    }
  }

  T* og = out + ((size_t)b * H + (size_t)kvh * G) * D;
#pragma unroll
  for (int a = 0; a < ACC; ++a) {
    const int idx = tid + a * THREADS;
    if (idx < G * D) {
      const int g = idx / D;
      og[idx] = from_float<T>(acc[a] / fmaxf(Ls[g], 1e-30f));
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* pool, const int* table,
                   const int* kv_len, void* out, int B, int H, int KV,
                   int BS, int MAXB, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>(H / KV);
  auto kern = paged_decode_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(KV, B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pool), table, kv_len,
      static_cast<T*>(out), H, KV, BS, MAXB, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// C entry bound with ctypes. dtype: 0 = float32, 1 = bfloat16. Needs
// G = H / KV <= 16 and D in {32, 64, 128}. Returns a cudaError_t; 0 on a
// successful launch.
extern "C" int paged_attention_fwd(const void* q, const void* pool,
                                   const int* table, const int* kv_len,
                                   void* out, int B, int H, int KV, int D,
                                   int BS, int MAXB, float scale, int dtype,
                                   void* stream) {
  using namespace repro_torch;
  if (B == 0) return 0;
  if (KV <= 0 || H % KV != 0 || H / KV > MAX_G)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_PAGED_CASE(T, DD)                                       \
  return (int)launch<T, DD>(q, pool, table, kv_len, out, B, H, KV, BS, \
                            MAXB, scale, s)
  if (dtype == 0 && D == 32) REPRO_PAGED_CASE(float, 32);
  if (dtype == 0 && D == 64) REPRO_PAGED_CASE(float, 64);
  if (dtype == 0 && D == 128) REPRO_PAGED_CASE(float, 128);
  if (dtype == 1 && D == 32) REPRO_PAGED_CASE(__nv_bfloat16, 32);
  if (dtype == 1 && D == 64) REPRO_PAGED_CASE(__nv_bfloat16, 64);
  if (dtype == 1 && D == 128) REPRO_PAGED_CASE(__nv_bfloat16, 128);
#undef REPRO_PAGED_CASE
  return (int)cudaErrorInvalidValue;
}
