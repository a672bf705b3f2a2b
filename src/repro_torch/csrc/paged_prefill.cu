// Segmented paged chunk-prefill attention (GQA) for Hopper, sm_90a, with
// an optional second (host) pool staged to the device first.
//
// Replaces the TPU kernel `paged_prefill_pallas` in both its forms
// (src/repro/kernels/paged_prefill.py: `_paged_prefill_kernel` and
// `_paged_prefill_kernel_tiered`, with `_prefill_body` /
// `_init_finalize`). It computes what `ref.paged_prefill_reference`
// computes. The flat token batch q (T, H, D) is a concatenation of
// per-request segments (a prefill chunk, a one-token decode, a kv_len = 0
// dummy), each padded to a multiple of the query tile tq, so a tile never
// straddles two segments. Row t of segment s = seg_ids[t] attends
//   out[t,h] = softmax_j(scale * q[t,h] . K[j, h/G]) V[j, h/G]
// over keys j < kv_len[s] with j <= q_pos[t] (causal against absolute
// positions, so the cached prefix and the chunk's own freshly written
// keys are handled by one mask), key j read at
// pool[table[s, j / BS], j % BS] from the pool of (NB, BS, 2, KV, D)
// blocks that tier[s] selects: the device pool, or, when tier[s] != 0,
// the host pool (pinned host memory; ids there may exceed the device
// pool's size).
//
// Two kernels, launched by one call on one stream:
//
// `stage_host_blocks_kernel` (two pools only) copies, for every segment
// with tier[s] != 0, its live host blocks table[s, j], j <
// ceil(min(kv_len[s], MAXB * BS) / BS), each whole (all KV heads, K and
// V: one contiguous BS * 2 * KV * D run), from the pinned pool's
// device-mapped address into a device staging buffer at slot s * MAXB +
// j, with 16-byte loads, several in flight per thread, spread over
// several blocks per pool block. Bound: PCIe (each live host byte crosses
// it exactly once per call). Out-of-range ids are clamped into
// [0, nb_host - 1], as the reference does.
//
// `paged_prefill_kernel`, the attention body. Bound on the H100: at the
// fused step's shapes (a 512-token llama2-7b chunk over a 1024-token
// prefix, G = 1) attention is ~6.4 GFLOP against ~25 MB of q, out and K/V
// per layer, well above the card's ridge, so a tensor-core kernel would be
// bound by operations. This version runs both products on the f32 CUDA
// cores (no mma / wgmma yet), so it is bound by FMA issue and
// shared-memory reads. What the design keeps from the TPU kernel: one
// block per (query tile, KV head) pair, split along the tile's tq x G
// (query, head) rows into blocks of BQ rows, so the G query heads of a
// group share every K/V row the block loads; the block reads its own tile
// metadata (segment and positions, from the tile's rows -- the TPU's
// scalar prefetch) and chases its segment's table row; it loops only over
// keys below min(kv_len, max q_pos + 1) -- blocks past kv_len or wholly
// above the causal diagonal are never read (the TPU's `pl.when(live)`);
// the online-softmax state and the accumulator stay on chip. A host
// segment reads its staged blocks (slot s * MAXB + j) in place of the
// device pool, with the same arithmetic, so the two-pool form gives the
// same bits as the one-pool form on the same blocks. Every query tile of
// a segment reads the whole prefix: from device memory, never again over
// PCIe.
//
// Semantics follow `ref.paged_prefill_reference`: q is scaled before
// QK^T, masked scores are -1e30 (not -inf), f32 accumulation, the final
// normaliser is clamped at 1e-30, and out-of-range block ids are clamped
// into the selected pool. A segment with kv_len = 0 reads nothing and
// writes 0 (finite), as the Pallas kernel's skipped tiles do.
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int BQ = 32;        // (query, head) rows per block
constexpr int BK = 64;        // keys per step
constexpr int THREADS = 128;  // 8 x 16 thread grid
constexpr int TY = THREADS / 16;
constexpr int RPT = BQ / TY;  // rows per thread (row ty + TY i)
constexpr int CPT = BK / 16;  // score columns per thread (col tx + 16 j)
constexpr int MAX_G = 16;     // query heads per KV head

template <int D>
constexpr size_t smem_bytes() {
  // Qs[BQ][D+1], Ks[BK][D+1], Vs[BK][D], Ps[BQ][BK+1] f32; Qp[BQ] int
  return sizeof(float) *
             (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1)) +
         sizeof(int) * BQ;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
paged_prefill_kernel(const T* __restrict__ q, const T* __restrict__ dpool,
                     const T* __restrict__ staged,
                     const int* __restrict__ table,
                     const int* __restrict__ seg_ids,
                     const int* __restrict__ q_pos,
                     const int* __restrict__ kv_len,
                     const int* __restrict__ tier, T* __restrict__ out,
                     int H, int KV, int BS, int S, int MAXB, int tq,
                     int nb_dev, float scale) {
  constexpr int N = Vec16<T>::N;
  constexpr int VPR = D / N;   // 16-byte vectors per row
  constexpr int OPT = D / 16;  // output columns per thread (col tx + 16 j)
  extern __shared__ float smem[];
  float* Qs = smem;                  // [BQ][D+1]
  float* Ks = Qs + BQ * (D + 1);     // [BK][D+1]
  float* Vs = Ks + BK * (D + 1);     // [BK][D]
  float* Ps = Vs + BK * D;           // [BQ][BK+1]
  int* Qp = reinterpret_cast<int*>(Ps + BQ * (BK + 1));  // [BQ] q_pos

  const int kvh = blockIdx.x, it = blockIdx.y, rz = blockIdx.z;
  const int G = H / KV;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int t0 = it * tq;                 // first token of the tile
  const int r0 = rz * BQ;                 // first (query, head) row
  const int rows = min(BQ, tq * G - r0);  // valid rows of this block

  // tile metadata from the tile's first row (a tile is inside one segment)
  const int seg = seg_ids[t0];
  const bool seg_ok = seg >= 0 && seg < S;
  const int kvl = seg_ok ? kv_len[seg] : 0;
  const bool host = seg_ok && tier != nullptr && tier[seg] != 0;
  const T* pool = host ? staged : dpool;
  const int* trow = table + (size_t)(seg_ok ? seg : 0) * MAXB;
  const int slot0 = (seg_ok ? seg : 0) * MAXB;  // the segment's staged run
  const size_t tok_stride = (size_t)2 * KV * D;  // elements per token slot
  const size_t blk_stride = (size_t)BS * tok_stride;

  // the block's q rows, scaled, and their absolute positions; row r is
  // query i = (r0 + r) / G of the tile at head kvh * G + (r0 + r) % G
  for (int idx = tid; idx < BQ * VPR; idx += THREADS) {
    const int r = idx / VPR, c = (idx % VPR) * N;
    float vals[N];
    if (r < rows) {
      const int rr = r0 + r;
      const size_t t = (size_t)t0 + rr / G;
      const int h = kvh * G + rr % G;
      load_vec16<T>(q + (t * H + h) * D + c, vals);
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) vals[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < N; ++i) Qs[r * (D + 1) + c + i] = vals[i] * scale;
  }
  for (int r = tid; r < BQ; r += THREADS)
    Qp[r] = r < rows ? q_pos[t0 + (r0 + r) / G] : -1;
  __syncthreads();

  // live keys: below kv_len (and inside the table row) and not above the
  // block's last query position
  int qmax = -1;
  for (int r = 0; r < rows; ++r) qmax = max(qmax, Qp[r]);
  const int k_end = min(min(kvl, MAXB * BS), qmax + 1);

  float m[RPT], l[RPT], o[RPT][OPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < OPT; ++j) o[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // previous step's PV is done with Vs / Ps
    // gather BK tokens' K and V rows of this KV head through the table
    for (int idx = tid; idx < BK * VPR; idx += THREADS) {
      const int r = idx / VPR, c = (idx % VPR) * N;
      const int tok = k0 + r;
      float kv_[N], vv_[N];
      if (tok < k_end) {
        const int b = host ? slot0 + tok / BS
                           : min(max(trow[tok / BS], 0), nb_dev - 1);
        const T* row = pool + (size_t)b * blk_stride +
                       (size_t)(tok % BS) * tok_stride + (size_t)kvh * D + c;
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

    // S = (q * scale) K^T for rows ty + TY i, cols tx + 16 j
    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = Qs[(ty + TY * i) * (D + 1) + d];
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
      const int qpos = Qp[ty + TY * i];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int kpos = k0 + tx + 16 * j;
        if (!(kpos < kvl && kpos <= qpos)) s[i][j] = kNegInf;
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
        Ps[(ty + TY * i) * (BK + 1) + tx + 16 * j] = p;
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

    // O += P V for rows ty + TY i, output columns tx + 16 j
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[RPT], vv[OPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = Ps[(ty + TY * i) * (BK + 1) + c];
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
    const int r = ty + TY * i;
    if (r >= rows) continue;
    const int rr = r0 + r;
    const size_t t = (size_t)t0 + rr / G;
    const int h = kvh * G + rr % G;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* orow = out + (t * H + h) * D;
#pragma unroll
    for (int j = 0; j < OPT; ++j)
      orow[tx + 16 * j] = from_float<T>(o[i][j] * inv);
  }
}

// The staging kernel's threads per block, 16-byte loads in flight per
// thread, and at most this many blocks per pool block copied.
constexpr int ST_THREADS = 256;
constexpr int ST_UNROLL = 4;
constexpr int ST_MAX_PARTS = 16;

__global__ void __launch_bounds__(ST_THREADS)
stage_host_blocks_kernel(const uint4* __restrict__ hpool,
                         const int* __restrict__ table,
                         const int* __restrict__ kv_len,
                         const int* __restrict__ tier,
                         uint4* __restrict__ staged, int MAXB, int BS,
                         int nb_host, int vpb) {
  const int slot = blockIdx.x;            // s * MAXB + j
  const int s = slot / MAXB, j = slot % MAXB;
  if (tier[s] == 0) return;
  const int kvl = min(kv_len[s], MAXB * BS);
  if (j * BS >= kvl) return;              // j >= ceil(kvl / BS): not live
  const int hb = min(max(table[slot], 0), nb_host - 1);
  const uint4* src = hpool + (size_t)hb * vpb;
  uint4* dst = staged + (size_t)slot * vpb;
  constexpr int PER = ST_THREADS * ST_UNROLL;
  for (int base = blockIdx.y * PER; base < vpb; base += gridDim.y * PER) {
    uint4 r[ST_UNROLL];
#pragma unroll
    for (int u = 0; u < ST_UNROLL; ++u) {
      const int i = base + u * ST_THREADS + threadIdx.x;
      if (i < vpb) r[u] = src[i];
    }
#pragma unroll
    for (int u = 0; u < ST_UNROLL; ++u) {
      const int i = base + u * ST_THREADS + threadIdx.x;
      if (i < vpb) dst[i] = r[u];
    }
  }
}

// Launch the staging kernel: `host_pool` is pinned host memory, looked up
// for its device-mapped address (fails, launching nothing, if it has
// none); `block_bytes` = BS * 2 * KV * D * sizeof(T), a multiple of 16.
cudaError_t launch_stage(const void* host_pool, const int* table,
                         const int* kv_len, const int* tier, void* staged,
                         int S, int MAXB, int BS, int nb_host,
                         size_t block_bytes, cudaStream_t stream) {
  if (host_pool == nullptr || staged == nullptr || tier == nullptr ||
      nb_host <= 0 || block_bytes % 16 != 0)
    return cudaErrorInvalidValue;
  if (S * MAXB == 0) return cudaSuccess;
  void* hdev = nullptr;
  cudaError_t err =
      cudaHostGetDevicePointer(&hdev, const_cast<void*>(host_pool), 0);
  if (err != cudaSuccess) return err;
  const int vpb = (int)(block_bytes / 16);
  constexpr int PER = ST_THREADS * ST_UNROLL;
  const int need = (vpb + PER - 1) / PER;
  const int parts = need < ST_MAX_PARTS ? need : ST_MAX_PARTS;
  dim3 grid(S * MAXB, parts);
  stage_host_blocks_kernel<<<grid, ST_THREADS, 0, stream>>>(
      static_cast<const uint4*>(hdev), table, kv_len, tier,
      static_cast<uint4*>(staged), MAXB, BS, nb_host, vpb);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* dpool, const void* staged,
                   const int* table, const int* seg_ids, const int* q_pos,
                   const int* kv_len, const int* tier, void* out, int T_,
                   int H, int KV, int BS, int S, int MAXB, int tq,
                   int nb_dev, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kern = paged_prefill_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int G = H / KV;
  dim3 grid(KV, T_ / tq, (tq * G + BQ - 1) / BQ);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(dpool),
      static_cast<const T*>(staged), table, seg_ids, q_pos, kv_len, tier,
      static_cast<T*>(out), H, KV, BS, S, MAXB, tq, nb_dev, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// C entries bound with ctypes. dtype: 0 = float32, 1 = bfloat16. Each
// returns a cudaError_t; 0 on a successful launch.
//
// paged_prefill_fwd needs T % tq == 0, G = H / KV <= 16 and D in {32, 64,
// 128}. `tier` null selects the single pool. Otherwise `host_pool` is
// pinned host memory (PyTorch's pinned allocator) and `staged` a device
// buffer of S * MAXB pool blocks: the call first launches the staging
// kernel into it, then the body, on `stream`.
extern "C" int paged_prefill_fwd(const void* q, const void* dpool,
                                 const void* host_pool, void* staged,
                                 const int* table, const int* seg_ids,
                                 const int* q_pos, const int* kv_len,
                                 const int* tier, void* out, int T_, int H,
                                 int KV, int D, int BS, int S, int MAXB,
                                 int tq, int nb_dev, int nb_host,
                                 float scale, int dtype, void* stream) {
  using namespace repro_torch;
  if (T_ == 0 || H == 0) return 0;
  if (tq <= 0 || T_ % tq != 0 || KV <= 0 || H % KV != 0 ||
      H / KV > MAX_G || nb_dev <= 0 || (dtype != 0 && dtype != 1) ||
      (D != 32 && D != 64 && D != 128))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tier != nullptr) {
    const size_t esize = dtype == 0 ? 4 : 2;
    cudaError_t err =
        launch_stage(host_pool, table, kv_len, tier, staged, S, MAXB, BS,
                     nb_host, (size_t)BS * 2 * KV * D * esize, s);
    if (err != cudaSuccess) return (int)err;
  }
#define REPRO_PP_CASE(TT, DD)                                                \
  return (int)launch<TT, DD>(q, dpool, staged, table, seg_ids, q_pos,       \
                             kv_len, tier, out, T_, H, KV, BS, S, MAXB, tq, \
                             nb_dev, scale, s)
  if (dtype == 0 && D == 32) REPRO_PP_CASE(float, 32);
  if (dtype == 0 && D == 64) REPRO_PP_CASE(float, 64);
  if (dtype == 0 && D == 128) REPRO_PP_CASE(float, 128);
  if (dtype == 1 && D == 32) REPRO_PP_CASE(__nv_bfloat16, 32);
  if (dtype == 1 && D == 64) REPRO_PP_CASE(__nv_bfloat16, 64);
  if (dtype == 1 && D == 128) REPRO_PP_CASE(__nv_bfloat16, 128);
#undef REPRO_PP_CASE
  return (int)cudaErrorInvalidValue;
}

// The staging kernel alone (what paged_prefill_fwd runs first with two
// pools): `staged` receives S * MAXB blocks of `block_bytes` each, the
// live host blocks of host segments copied, every other slot untouched.
extern "C" int stage_host_blocks_fwd(const void* host_pool,
                                     const int* table, const int* kv_len,
                                     const int* tier, void* staged, int S,
                                     int MAXB, int BS, int nb_host,
                                     long long block_bytes, void* stream) {
  using namespace repro_torch;
  if (S == 0 || MAXB == 0) return 0;
  return (int)launch_stage(host_pool, table, kv_len, tier, staged, S, MAXB,
                           BS, nb_host, (size_t)block_bytes,
                           static_cast<cudaStream_t>(stream));
}
