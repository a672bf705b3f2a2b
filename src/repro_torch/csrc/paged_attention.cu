// Paged GQA decode attention for Hopper, sm_90a, split over the context.
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
// below the card's ~295 flops/byte ridge at G <= 16. So the design is
// about keeping enough bytes in flight:
//
// - The context is split: one block per (KV head, sequence, split of
//   SPLIT tokens). Split boundaries depend only on the token position,
//   never on B or on how full the grid is, so a row's result has the same
//   bits alone as in any batch. A block whose split starts at or past
//   kv_len exits at once; split 0 always runs, so a row with kv_len = 0
//   (the executor's power-of-two pad rows on the trash block) writes 0, as
//   the Pallas kernel's max(l, 1e-30) clamp does.
// - Inside a block each of the NW warps owns every NW-th step of TW
//   tokens and streams them through its own STAGES-deep cp.async ring of
//   bf16 (or f32) K and V rows in shared memory: the next step's loads are
//   issued before this step's math, and a warp waits only on its own
//   copies (no block-wide barrier inside the loop).
// - Four lanes share a token: each takes a quarter of the head dim, the
//   dot product closes with two shuffles, and the online softmax runs over
//   the warp's TW tokens with shuffles. The G query heads of a group share
//   every K/V row loaded; K rows are XOR-swizzled by the token's parity so
//   the four lanes of two neighbouring tokens hit distinct banks.
// - The warps' (m, l, acc) merge in shared memory in warp order. A row
//   that fits in one split writes its output directly. A longer row's
//   split blocks write f32 partials (m, l, acc), fence them and take a
//   ticket on a counter per (row, KV head); the block that draws the last
//   ticket resets the counter to 0 for the next call, reads every split's
//   partials through L2 (`__ldcg`, several splits' loads in flight) and
//   merges them in split order.
//   The merge's order is the split index, never the ticket order, so the
//   result is deterministic and batch-invariant; no second launch re-reads
//   the partials.
//
// Semantics follow `ref.paged_attention_reference`: q scaled before the
// product, masked scores -1e30 (never -inf), f32 accumulation, the final
// normaliser clamped at 1e-30, output in q's dtype; kv_len is clamped to
// the table's MAXB * BS tokens.
#include "common.cuh"
#include "hopper.cuh"

namespace repro_torch {
namespace {

constexpr int SPLIT = 256;   // tokens per split (the wrapper passes it too)
constexpr int NW = 4;        // warps per block
constexpr int TW = 8;        // tokens per warp step: 4 lanes per token
constexpr int STAGES = 3;    // cp.async ring depth of each warp
constexpr int THREADS = NW * 32;
constexpr int MAX_G = 16;    // query heads per KV head
static_assert(SPLIT % (NW * TW) == 0, "a warp step never crosses a split");

template <typename T, int D>
struct Geo {
  static constexpr int N = Vec16<T>::N;        // elements per 16 bytes
  static constexpr int VPR = D / N;            // 16-byte chunks per row
  static constexpr int CPL = VPR / 4;          // K chunks per lane
  static constexpr int EPL = D / 32;           // V columns per lane
  static constexpr int ROW = D * (int)sizeof(T);
  static constexpr int STAGE = 2 * TW * ROW;   // TW K rows, then TW V rows
  static constexpr int SWZ = VPR >= 8 ? 4 : 0; // chunk XOR for odd tokens
};

template <typename T, int D, int GMAX>
constexpr size_t smem_bytes() {
  // ring [NW][STAGES][STAGE] bytes; Qs [GMAX][D], Os [NW][GMAX][D],
  // Ms / Ls [NW][GMAX] f32; Tb [SPLIT + 4] int
  return (size_t)NW * STAGES * Geo<T, D>::STAGE +
         sizeof(float) * ((size_t)GMAX * D + (size_t)NW * GMAX * D +
                          2 * NW * GMAX) +
         sizeof(int) * (SPLIT + 4);
}

// E consecutive elements at `src` (E * sizeof(T) bytes, aligned to that)
// widened to f32, in one load.
template <typename T, int E>
__device__ __forceinline__ void load_row_part(const T* src, float* dst) {
  constexpr int BYTES = E * (int)sizeof(T);
  if constexpr (BYTES == 16) {
    load_vec16<T>(src, dst);
  } else if constexpr (BYTES == 8) {
    uint2 raw = *reinterpret_cast<const uint2*>(src);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < E; ++i) dst[i] = to_float(e[i]);
  } else if constexpr (BYTES == 4) {
    uint32_t raw = *reinterpret_cast<const uint32_t*>(src);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < E; ++i) dst[i] = to_float(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < E; ++i) dst[i] = to_float(src[i]);
  }
}

// *p += v, returning the old value, as an acquire-release atomic at GPU
// scope (one instruction; __threadfence's sequentially consistent fence
// plus a relaxed atomic cost more)
__device__ __forceinline__ int atomic_add_acq_rel_gpu(int* p, int v) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], %2;"
               : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

template <typename T, int D, int GMAX>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ pool,
                    const int* __restrict__ table,
                    const int* __restrict__ kv_len, T* __restrict__ out,
                    float* __restrict__ part_o, float* __restrict__ part_ml,
                    int* __restrict__ tickets, int H, int KV, int BS,
                    int MAXB, int nsplit, float scale) {
  using Gm = Geo<T, D>;
  constexpr int N = Gm::N;
  const int kvh = blockIdx.x, b = blockIdx.y, sp = blockIdx.z;
  const int G = H / KV;
  const int kvl = min(kv_len[b], MAXB * BS);
  const int s0 = sp * SPLIT;
  if (sp > 0 && s0 >= kvl) return;        // no token of this row here
  const int s1 = min(s0 + SPLIT, kvl);    // the split's tokens: [s0, s1)
  const int row_splits = (kvl + SPLIT - 1) / SPLIT;

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;
  float* Qs = reinterpret_cast<float*>(ring + (size_t)NW * STAGES * Gm::STAGE);
  float* Os = Qs + GMAX * D;              // [NW][GMAX][D] warp accumulators
  float* Ms = Os + NW * GMAX * D;         // [NW][GMAX] warp running max
  float* Ls = Ms + NW * GMAX;             // [NW][GMAX] warp normaliser
  int* Tb = reinterpret_cast<int*>(Ls + NW * GMAX);  // the split's block ids

  const int tid = threadIdx.x, lane = tid % 32, w = tid / 32;
  const int tr = lane / 4, j = lane % 4;  // token of the step, its quarter
  const size_t tok_stride = (size_t)2 * KV * D;
  const size_t blk_stride = (size_t)BS * tok_stride;

  // the G query heads of this group (heads kvh*G .. kvh*G + G - 1), scaled,
  // and the block ids the split's tokens live in
  const T* qg = q + ((size_t)b * H + (size_t)kvh * G) * D;
  for (int idx = tid; idx < G * (D / N); idx += THREADS) {
    float vals[N];
    load_vec16<T>(qg + (size_t)idx * N, vals);
#pragma unroll
    for (int i = 0; i < N; ++i) Qs[idx * N + i] = vals[i] * scale;
  }
  const int jb0 = s0 / BS;
  const int nblk = s1 > s0 ? (s1 - 1) / BS - jb0 + 1 : 0;
  for (int i = tid; i < nblk; i += THREADS)
    Tb[i] = table[(size_t)b * MAXB + jb0 + i];
  __syncthreads();

  // this warp's steps: tokens s0 + (k * NW + w) * TW + [0, TW)
  const int n = s1 - s0;
  const int nsteps = n > w * TW ? (n - w * TW + NW * TW - 1) / (NW * TW) : 0;
  unsigned char* wring = ring + (size_t)w * STAGES * Gm::STAGE;

  auto load_step = [&](int k) {
    const int t0 = s0 + (k * NW + w) * TW;
    unsigned char* st = wring + (k % STAGES) * Gm::STAGE;
#pragma unroll
    for (int idx = lane; idx < 2 * TW * Gm::VPR; idx += 32) {
      const int row = idx / Gm::VPR, c = idx % Gm::VPR;
      const int kv = row / TW, r = row % TW;  // kv: 0 = K, 1 = V
      const int t = t0 + r;
      const bool ok = t < s1;
      const int tt = ok ? t : s0;             // a valid address when masked
      const T* src = pool + (size_t)Tb[tt / BS - jb0] * blk_stride +
                     (size_t)(tt % BS) * tok_stride + (size_t)kv * KV * D +
                     (size_t)kvh * D + c * N;
      const int pc = kv == 0 ? (c ^ ((r & 1) * Gm::SWZ)) : c;
      cp_async16(smem_u32(st + row * Gm::ROW + pc * 16), src, ok);
    }
    cp_async_commit();
  };

  float m[GMAX], l[GMAX], acc[GMAX][Gm::EPL];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < Gm::EPL; ++e) acc[g][e] = 0.f;
  }

#pragma unroll
  for (int k = 0; k < STAGES - 1; ++k) {
    if (k < nsteps) load_step(k);
    else cp_async_commit();
  }
  for (int k = 0; k < nsteps; ++k) {
    __syncwarp();   // every lane is done with the slot step k - 1 used
    if (k + STAGES - 1 < nsteps) load_step(k + STAGES - 1);
    else cp_async_commit();
    cp_async_wait<STAGES - 1>();
    __syncwarp();   // step k's rows are in shared memory for the warp

    const unsigned char* st = wring + (k % STAGES) * Gm::STAGE;
    const T* Kr = reinterpret_cast<const T*>(st + tr * Gm::ROW);
    const T* Vs = reinterpret_cast<const T*>(st + TW * Gm::ROW);
    const bool live = s0 + (k * NW + w) * TW + tr < s1;

    // this lane's quarter of its token's K row: chunks j, j + 4, ...
    float kf[Gm::CPL][N];
#pragma unroll
    for (int i = 0; i < Gm::CPL; ++i) {
      const int c = j + 4 * i;
      load_vec16<T>(Kr + (c ^ ((tr & 1) * Gm::SWZ)) * N, kf[i]);
    }
    float p[GMAX];
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g >= G) break;
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < Gm::CPL; ++i) {
        const float* qc = Qs + g * D + (j + 4 * i) * N;
#pragma unroll
        for (int e = 0; e < N; ++e) s = fmaf(qc[e], kf[i][e], s);
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if (!live) s = kNegInf;
      // online softmax over the step's TW tokens (lanes 4 apart)
      float mx = s;
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[g], mx);
      const float pg = expf(s - m_new);
      float sum = pg;
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float corr = expf(m[g] - m_new);
      l[g] = l[g] * corr + sum;
      m[g] = m_new;
#pragma unroll
      for (int e = 0; e < Gm::EPL; ++e) acc[g][e] *= corr;
      p[g] = pg;
    }
    // acc[g, lane's columns] += p[g, r] V[r, lane's columns]
#pragma unroll
    for (int r = 0; r < TW; ++r) {
      float v[Gm::EPL];
      load_row_part<T, Gm::EPL>(Vs + r * D + lane * Gm::EPL, v);
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g >= G) break;
        const float pr = __shfl_sync(0xffffffffu, p[g], r * 4);
#pragma unroll
        for (int e = 0; e < Gm::EPL; ++e) acc[g][e] = fmaf(pr, v[e], acc[g][e]);
      }
    }
  }
  cp_async_wait<0>();

  // merge the warps' states in warp order
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g >= G) break;
    if (lane == 0) {
      Ms[w * GMAX + g] = m[g];
      Ls[w * GMAX + g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < Gm::EPL; ++e)
      Os[(w * GMAX + g) * D + lane * Gm::EPL + e] = acc[g][e];
  }
  __syncthreads();
  for (int idx = tid; idx < G * D; idx += THREADS) {
    const int g = idx / D, d = idx % D;
    float M = kNegInf;
#pragma unroll
    for (int ww = 0; ww < NW; ++ww) M = fmaxf(M, Ms[ww * GMAX + g]);
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int ww = 0; ww < NW; ++ww) {
      const float c = expf(Ms[ww * GMAX + g] - M);
      L += Ls[ww * GMAX + g] * c;
      O += Os[(ww * GMAX + g) * D + d] * c;
    }
    const size_t h = (size_t)b * H + (size_t)kvh * G + g;
    if (row_splits <= 1) {
      out[h * D + d] = from_float<T>(O / fmaxf(L, 1e-30f));
    } else {
      const size_t pi = h * nsplit + sp;
      part_o[pi * D + d] = O;
      if (d == 0) {
        part_ml[pi * 2] = M;
        part_ml[pi * 2 + 1] = L;
      }
    }
  }
  if (row_splits <= 1) return;

  // A row of several splits: the last of its split blocks to finish merges
  // them. After the barrier, thread 0 takes the block's ticket with an
  // acquire-release atomic at GPU scope: its release covers the whole
  // block's partials (ordered before it by the barrier), and the block
  // that draws the last ticket acquires every other split's.
  __shared__ int merge;
  __syncthreads();
  if (tid == 0) {
    int* ticket = tickets + (size_t)b * KV + kvh;
    merge = atomic_add_acq_rel_gpu(ticket, 1) == row_splits - 1;
    if (merge) *ticket = 0;  // every split has drawn: ready for the next call
  }
  __syncthreads();
  if (!merge) return;
  // out[b, h] = sum_s acc_s e^(m_s - M) / max(sum_s l_s e^(m_s - M), 1e-30)
  // over the row's splits, summed in split order; the partials are read
  // through L2, MU splits' loads issued together
  constexpr int MU = 8;
  for (int idx = tid; idx < G * D; idx += THREADS) {
    const int g = idx / D, d = idx % D;
    const size_t h = (size_t)b * H + (size_t)kvh * G + g;
    const float2* ml = reinterpret_cast<const float2*>(part_ml) + h * nsplit;
    const float* po = part_o + h * nsplit * D + d;
    float M = kNegInf;
    for (int s0 = 0; s0 < row_splits; s0 += MU) {
      float2 v[MU];
#pragma unroll
      for (int i = 0; i < MU; ++i)
        if (s0 + i < row_splits) v[i] = __ldcg(ml + s0 + i);
#pragma unroll
      for (int i = 0; i < MU; ++i)
        if (s0 + i < row_splits) M = fmaxf(M, v[i].x);
    }
    float L = 0.f, O = 0.f;
    for (int s0 = 0; s0 < row_splits; s0 += MU) {
      float2 v[MU];
      float o[MU];
#pragma unroll
      for (int i = 0; i < MU; ++i)
        if (s0 + i < row_splits) {
          v[i] = __ldcg(ml + s0 + i);
          o[i] = __ldcg(po + (size_t)(s0 + i) * D);
        }
#pragma unroll
      for (int i = 0; i < MU; ++i)
        if (s0 + i < row_splits) {
          const float c = expf(v[i].x - M);
          L += v[i].y * c;
          O += o[i] * c;
        }
    }
    out[h * D + d] = from_float<T>(O / fmaxf(L, 1e-30f));
  }
}

template <typename T, int D, int GMAX>
cudaError_t launch(const void* q, const void* pool, const int* table,
                   const int* kv_len, void* out, float* part_o,
                   float* part_ml, int* tickets, int B, int H, int KV,
                   int BS, int MAXB, int nsplit, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, D, GMAX>();
  auto kern = paged_decode_kernel<T, D, GMAX>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(KV, B, nsplit);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pool), table, kv_len,
      static_cast<T*>(out), part_o, part_ml, tickets, H, KV, BS, MAXB, nsplit,
      scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_g(const void* q, const void* pool, const int* table,
                     const int* kv_len, void* out, float* part_o,
                     float* part_ml, int* tickets, int B, int H, int KV,
                     int BS, int MAXB, int nsplit, float scale,
                     cudaStream_t stream) {
  const int G = H / KV;
#define REPRO_PAGED_G(GG)                                                 \
  return launch<T, D, GG>(q, pool, table, kv_len, out, part_o, part_ml,   \
                          tickets, B, H, KV, BS, MAXB, nsplit, scale, stream)
  if (G == 1) REPRO_PAGED_G(1);
  if (G <= 4) REPRO_PAGED_G(4);
  REPRO_PAGED_G(MAX_G);
#undef REPRO_PAGED_G
}

}  // namespace
}  // namespace repro_torch

// C entries bound with ctypes. dtype: 0 = float32, 1 = bfloat16. Each
// returns a cudaError_t; 0 on a successful launch.
//
// paged_attention_fwd launches the split kernel: G = H / KV <= 16, D in
// {32, 64, 128}, `split` must equal the compiled SPLIT, and nsplit =
// ceil(MAXB * BS / split). With nsplit > 1, part_o (B, H, nsplit, D) and
// part_ml (B, H, nsplit, 2) are f32 scratch that rows longer than one
// split fill, and `tickets` is B * KV ints, all 0 on entry (the kernel
// leaves them 0): the last split block of each such row merges its
// partials into `out`. Calls that share `tickets` must not overlap.
extern "C" int paged_attention_fwd(const void* q, const void* pool,
                                   const int* table, const int* kv_len,
                                   void* out, float* part_o, float* part_ml,
                                   int* tickets, int B, int H, int KV, int D,
                                   int BS, int MAXB, int split, int nsplit,
                                   float scale, int dtype, void* stream) {
  using namespace repro_torch;
  if (B == 0) return 0;
  if (KV <= 0 || H % KV != 0 || H / KV > MAX_G || BS <= 0 || MAXB <= 0 ||
      split != SPLIT || nsplit != (MAXB * BS + SPLIT - 1) / SPLIT ||
      (nsplit > 1 &&
       (part_o == nullptr || part_ml == nullptr || tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_PAGED_CASE(T, DD)                                             \
  return (int)launch_g<T, DD>(q, pool, table, kv_len, out, part_o, part_ml, \
                              tickets, B, H, KV, BS, MAXB, nsplit, scale, s)
  if (dtype == 0 && D == 32) REPRO_PAGED_CASE(float, 32);
  if (dtype == 0 && D == 64) REPRO_PAGED_CASE(float, 64);
  if (dtype == 0 && D == 128) REPRO_PAGED_CASE(float, 128);
  if (dtype == 1 && D == 32) REPRO_PAGED_CASE(__nv_bfloat16, 32);
  if (dtype == 1 && D == 64) REPRO_PAGED_CASE(__nv_bfloat16, 64);
  if (dtype == 1 && D == 128) REPRO_PAGED_CASE(__nv_bfloat16, 128);
#undef REPRO_PAGED_CASE
  return (int)cudaErrorInvalidValue;
}
