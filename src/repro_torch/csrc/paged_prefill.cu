// Segmented paged chunk-prefill attention (GQA) for Hopper, sm_90a, with
// an optional second (host) pool, staged to the device by the copy engine.
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
// Host staging (`stage_host_runs_fwd`, two pools only). The Pallas kernel
// fetched host blocks by DMA inside its grid; on this card the copy
// engine is that DMA. The caller lists, on the host, the live host blocks
// table[s, j], j < ceil(min(kv_len[s], MAXB * BS) / BS), of every segment
// with tier[s] != 0 as runs consecutive in both the host pool and the
// staging buffer (slot s * MAXB + j), and one call hands every run to the
// copy engine as one batch (`cudaMemcpyBatchAsync`, CUDA >= 12.8) on the
// caller's stream: no SM spends a cycle on it, and each live host byte
// crosses PCIe once. The serving executor issues a layer's staging on a
// side stream one layer ahead, so it overlaps the compute of the layer
// before (PCIe bound: ~0.26 ms per 16.8 MB at the Gen5 x16 spec).
//
// The attention body, in two kernels picked by dtype and head dim (a
// dispatch by shape, never a fallback: nothing retries another kernel
// when a launch fails). Bound on the H100: at the fused step's shapes (a
// 512-token llama2-7b chunk over a 1024-token prefix, G = 1) attention
// is ~6.4 GFLOP against ~25 MB of q, out and K/V per layer, above the
// card's ridge, so the bound is tensor-core operations (0.0065 ms) about
// as much as bytes (0.0075 ms). What both keep from the TPU kernel: one
// block per (query tile, KV head) pair, split along the tile's tq x G
// (query, head) rows, so the G query heads of a group share every K/V row
// the block loads; the block reads its own tile metadata (segment and
// positions, from the tile's rows -- the TPU's scalar prefetch) and
// chases its segment's table row; it loops only over keys below
// min(kv_len, MAXB * BS, max q_pos + 1) -- blocks past kv_len or wholly
// above the causal diagonal are never read (the TPU's `pl.when(live)`);
// the online-softmax state and the accumulator stay on chip. A host
// segment reads its staged blocks (slot s * MAXB + j of the staging
// buffer) in place of the device pool, with the same arithmetic, so the
// two-pool form gives the same bits as the one-pool form on the same
// blocks. Every query tile of a segment reads the whole prefix: from
// device memory (mostly L2), never again over PCIe.
//
// `tc::paged_prefill_mma` (bf16, D = 64 and 128: every main path). Both
// products on the tensor cores as mma.sync m16n8k16 (bf16 in, f32
// accumulate). Each warp owns 16 (query, head) rows. A block of up to
// MAX_NWR warps takes a span of consecutive tiles, up to 64 rows (two
// 32-token tiles at G = 1), and walks it in groups of tiles of one
// segment, so one K/V step read from L2 serves 64 rows, not 32 (PERF.md
// has the sweep that chose it); a tile of
// more rows (G up to 16: 512 rows at tq 32) takes several blocks, and
// rows past a group's are padded with zero q rows that are never
// stored. Each step, the block reads the table entries of its BK keys
// first, then gathers K and V with cp.async into a STAGES-deep ring of
// bf16 tiles swizzled by 16-byte chunk (`swz<D>`), so the gather of the
// next step overlaps the products of this one (a table read between two
// copies would wait for the copy before it); Q passes through the ring's last
// slot once and stays in registers as A fragments. S = Q K^T comes from
// ldmatrix'd K, the mask and the online softmax run in registers (quad
// shuffles, exp2 with the scale folded in, -1e30 masking), P is rounded
// to bf16 in registers as the A operand of P V, with V read by
// ldmatrix.trans, and O stays in f32 registers. Spans launch heaviest
// first (`TileOrder`, last span of the batch first). BK, STAGES and
// MAX_NWR are the fastest of `tools/paged_sweep.py`'s variants. A row's
// result depends only on its q, its segment's keys and the key steps,
// fixed at multiples of BK from 0: a step in which all of a warp's rows
// are masked is skipped, and a row masked in a step its warp computes
// gets p = 0 and a correction of exactly 1 (it saw key 0 in step 0), so
// its (m, l, O) stay bit-unchanged. So a row gives the same bits
// whatever else the call holds and wherever its chunk starts.
//
// `paged_prefill_kernel` (f32 at every D, and bf16 at D = 32, where
// `swz<D>` lacks the 8 chunks per row it XORs over): both products on
// the f32 CUDA cores, bound by FMA issue and shared-memory reads; K/V
// widened to f32 in shared memory, BQ rows per block.
//
// Semantics follow `ref.paged_prefill_reference`: the scores are scale *
// q . k (the CUDA-core kernel scales q first, the tensor-core kernel
// folds the scale into exp2), masked scores are -1e30 (not -inf), f32
// accumulation, the final
// normaliser is clamped at 1e-30, and out-of-range block ids are clamped
// into the selected pool. A segment with kv_len = 0 reads nothing and
// writes 0 (finite), as the Pallas kernel's skipped tiles do.
#include <cstring>
#include <vector>

#include "common.cuh"
#include "hopper.cuh"

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

// ------------------------------------ bf16, D = 64 / 128: mma.sync m16n8k16 --

namespace tc {

constexpr int WARP_ROWS = 16;  // (query, head) rows per warp: one m16 tile
constexpr int MAX_NWR = 4;     // warps per block: spans of 64 rows
constexpr int BK = 64;         // keys per step: four 16-token pool blocks
constexpr int STAGES = 2;      // depth of the K/V ring
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Smem {
  static constexpr int TILE = BK * D * 2;  // one step of K or V, bf16
  static constexpr int STAGE = 2 * TILE;   // K, then V
  static constexpr int BYTES = STAGES * STAGE;
  // a group's Q rows pass through the last slot before its loop
  static_assert(MAX_NWR * WARP_ROWS * D * 2 <= STAGE, "Q fits one slot");
};

template <int D, int NWR>
__global__ void __launch_bounds__(NWR * 32)
paged_prefill_mma(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ dpool,
                  const __nv_bfloat16* __restrict__ staged,
                  const int* __restrict__ table,
                  const int* __restrict__ seg_ids,
                  const int* __restrict__ q_pos,
                  const int* __restrict__ kv_len,
                  const int* __restrict__ tier,
                  __nv_bfloat16* __restrict__ out, int H, int KV, int BS,
                  int bs_log2, int S, int MAXB, int tq, int nb_dev,
                  int n_tiles, int tpb, int n_spans, float scale) {
  static_assert(D % 64 == 0, "swz<D> needs 8 chunks per row");
  using L = Smem<D>;
  constexpr int NT = NWR * 32;
  constexpr int CPR = D / 8;                   // 16-byte chunks per row
  constexpr int RSTEP = NT / CPR;              // rows between a thread's chunks
  constexpr int NQ = NWR * WARP_ROWS / RSTEP;  // Q chunks per thread
  constexpr int NI = BK / RSTEP;               // K (and V) chunks per thread
  static_assert(NT % CPR == 0 && NQ * RSTEP == NWR * WARP_ROWS &&
                NI * RSTEP == BK, "whole chunks per thread");
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ int warp_qmax[NWR];
  const uint32_t s0 = smem_u32(smem);
  const uint32_t sQ = s0 + (STAGES - 1) * L::STAGE;
  // heaviest first: a chunk's last spans see the most keys
  const TileOrder to = tile_order(n_spans, KV, true);
  const int kvh = to.head;
  const int G = H / KV;
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const int r0 = to.batch * NWR * WARP_ROWS;  // row group (tpb == 1 only)
  const int tile_hi = min((to.tile + 1) * tpb, n_tiles);
  const size_t tok_stride = (size_t)2 * KV * D;  // elements per token slot
  const size_t blk_stride = (size_t)BS * tok_stride;
  const float sl2 = scale * kLog2e;
  // this thread's 16-byte column and first row of every copy
  const int ch = threadIdx.x % CPR, rbase = threadIdx.x / CPR;
  const size_t col = (size_t)kvh * D + ch * 8;

  // the span's tiles in groups of consecutive tiles of one segment; a
  // group's rows share every K/V step the block loads
  for (int ta = to.tile * tpb; ta < tile_hi;) {
    const int seg = seg_ids[ta * tq];
    int tb = ta + 1;
    while (tb < tile_hi && seg_ids[tb * tq] == seg) ++tb;
    const int t0 = ta * tq;               // the group's first token
    const int rows = (tb - ta) * tq * G;  // its (query, head) rows
    ta = tb;
    __syncthreads();   // the previous group is done with the ring

    const bool seg_ok = seg >= 0 && seg < S;
    const int kvl = seg_ok ? kv_len[seg] : 0;
    const bool host = seg_ok && tier != nullptr && tier[seg] != 0;
    const __nv_bfloat16* pool = host ? staged : dpool;
    const int* trow = table + (size_t)(seg_ok ? seg : 0) * MAXB;
    const int slot0 = (seg_ok ? seg : 0) * MAXB;  // the segment's staged run
    const int k_lim = min(kvl, MAXB * BS);

    // the block's q rows into the ring's last slot; row r is query
    // (r0 + r) / G of the group at head kvh * G + (r0 + r) % G
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      const int r = rbase + i * RSTEP, rr = r0 + r;
      const bool ok = rr < rows;
      const size_t t = (size_t)t0 + (ok ? rr / G : 0);
      const int h = kvh * G + (ok ? rr % G : 0);
      cp_async16(sQ + swz<D>(r, ch * 8), q + (t * H + h) * D + ch * 8, ok);
    }
    cp_async_commit();

    // this thread's rows rq, rq + 8 and their positions (-1: a pad row,
    // masked everywhere and never stored); the warp's and block's last
    // live key
    const int rq = r0 + w * WARP_ROWS + g;
    int qp[2];
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int rr = rq + 8 * hi;
      qp[hi] = rr < rows ? q_pos[t0 + rr / G] : -1;
    }
    int wmax = max(qp[0], qp[1]), wmin = min(qp[0], qp[1]);
#pragma unroll
    for (int sh = 16; sh > 0; sh >>= 1) {
      wmax = max(wmax, __shfl_xor_sync(0xffffffffu, wmax, sh));
      wmin = min(wmin, __shfl_xor_sync(0xffffffffu, wmin, sh));
    }
    if (lane == 0) warp_qmax[w] = wmax;
    __syncthreads();
    int qmax = -1;
#pragma unroll
    for (int i = 0; i < NWR; ++i) qmax = max(qmax, warp_qmax[i]);
    const int k_end = min(k_lim, qmax + 1);   // the block's live keys
    const int w_end = min(k_lim, wmax + 1);   // this warp's
    // keys from here on need the mask for some row of the warp (past the
    // first row's diagonal, or past the segment's keys)
    const int w_edge = min(k_lim, wmin + 1);
    const int nsteps = k_end > 0 ? (k_end + BK - 1) / BK : 0;

    // gather step `st`'s BK keys of K and V through the table row into
    // ring slot `slot`: every table read first, then the copies; keys >=
    // k_end are zero-filled and never read
    auto load_step = [&](int st, int slot) {
      const uint32_t sK = s0 + slot * L::STAGE, sV = sK + L::TILE;
      const int k0 = st * BK;
      int blk[NI];
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        const int tok = k0 + rbase + i * RSTEP;
        const int j = bs_log2 >= 0 ? tok >> bs_log2 : tok / BS;
        blk[i] = tok >= k_end ? -1
                 : host       ? slot0 + j
                              : min(max(trow[j], 0), nb_dev - 1);
      }
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        const int r = rbase + i * RSTEP, tok = k0 + r;
        const bool ok = blk[i] >= 0;
        const int off = bs_log2 >= 0 ? tok & (BS - 1) : tok % BS;
        const __nv_bfloat16* src =
            ok ? pool + (size_t)blk[i] * blk_stride +
                     (size_t)off * tok_stride + col
               : pool;
        cp_async16(sK + swz<D>(r, ch * 8), src, ok);
        cp_async16(sV + swz<D>(r, ch * 8), ok ? src + (size_t)KV * D : pool,
                   ok);
      }
    };
#pragma unroll
    for (int st = 0; st < STAGES - 1; ++st) {
      if (st < nsteps) load_step(st, st);
      cp_async_commit();
    }

    // Q as A fragments, held for the whole loop
    cp_async_wait<STAGES - 1>();   // the Q group is the oldest
    __syncthreads();
    uint32_t qa[D / 16][4];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      ldsm_x4(qa[kk], a_addr<D>(sQ, w * WARP_ROWS, kk * 16, lane));

    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    float o[D / 8][4];
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) o[i][j] = 0.f;

    for (int st = 0; st < nsteps; ++st) {
      cp_async_wait<STAGES - 2>();   // step st landed (this thread's part)
      __syncthreads();   // ... every thread's; slot st - 1 (or Q) is free
      if (st + STAGES - 1 < nsteps)
        load_step(st + STAGES - 1, (st + STAGES - 1) % STAGES);
      cp_async_commit();
      const int k0 = st * BK;
      if (k0 >= w_end) continue;   // every row of this warp is masked
      const uint32_t sK = s0 + (st % STAGES) * L::STAGE, sV = sK + L::TILE;

      // S = Q K^T, this warp's 16 rows x BK keys
      float s[BK / 8][4];
#pragma unroll
      for (int i = 0; i < BK / 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
        for (int nn = 0; nn < BK / 16; ++nn) {
          uint32_t kf[4];
          ldsm_x4(kf, b_nk_addr<D>(sK, nn * 16, kk * 16, lane));
          mma_bf16(s[2 * nn], qa[kk], kf[0], kf[1]);
          mma_bf16(s[2 * nn + 1], qa[kk], kf[2], kf[3]);
        }

      // mask: key k0 + 8i + 2c + (j & 1) of row rq + 8 (j >> 1) is live
      // below k_lim and at or before the row's position
      if (k0 + BK > w_edge) {
#pragma unroll
        for (int i = 0; i < BK / 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int kp = k0 + 8 * i + 2 * c + (j & 1);
            if (!(kp < k_lim && kp <= qp[j >> 1])) s[i][j] = kNegInf;
          }
      }

      // online softmax in the log2 domain; a row's 4 lanes share it by
      // quad shuffles
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < BK / 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mx[j >> 1] = fmaxf(mx[j >> 1], s[i][j]);
      float ms[2], corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        mx[hi] = fmaxf(mx[hi], __shfl_xor_sync(0xffffffffu, mx[hi], 1));
        mx[hi] = fmaxf(mx[hi], __shfl_xor_sync(0xffffffffu, mx[hi], 2));
        ms[hi] = mx[hi] * sl2;
        corr[hi] = ex2_approx(m[hi] * sl2 - ms[hi]);
        m[hi] = mx[hi];
      }
#pragma unroll
      for (int i = 0; i < BK / 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = ex2_approx(fmaf(s[i][j], sl2, -ms[j >> 1]));
          rs[j >> 1] += s[i][j];
        }
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        rs[hi] += __shfl_xor_sync(0xffffffffu, rs[hi], 1);
        rs[hi] += __shfl_xor_sync(0xffffffffu, rs[hi], 2);
        l[hi] = l[hi] * corr[hi] + rs[hi];
      }
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        o[i][0] *= corr[0];
        o[i][1] *= corr[0];
        o[i][2] *= corr[1];
        o[i][3] *= corr[1];
      }

      // O += P V, P rounded to bf16 A fragments, V read transposed
      uint32_t pa[BK / 16][4];
      acc_to_a<BK / 8>(s, pa);
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc)
#pragma unroll
        for (int dn = 0; dn < D / 16; ++dn) {
          uint32_t vf[4];
          ldsm_x4_t(vf, b_kn_addr<D>(sV, kc * 16, dn * 16, lane));
          mma_bf16(o[2 * dn], pa[kc], vf[0], vf[1]);
          mma_bf16(o[2 * dn + 1], pa[kc], vf[2], vf[3]);
        }
    }
    cp_async_wait<0>();

    // rows with no live key (kv_len = 0) have l = 0, O = 0 and write 0
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int rr = rq + 8 * hi;
      if (rr >= rows) continue;
      const size_t t = (size_t)t0 + rr / G;
      const int h = kvh * G + rr % G;
      const float inv = 1.f / fmaxf(l[hi], 1e-30f);
      __nv_bfloat16* orow = out + (t * H + h) * D;
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
        *reinterpret_cast<uint32_t*>(orow + 8 * i + 2 * c) =
            pack_bf16(o[i][2 * hi] * inv, o[i][2 * hi + 1] * inv);
    }
  }
}

template <int D, int NWR>
cudaError_t launch_nwr(const void* q, const void* dpool, const void* staged,
                       const int* table, const int* seg_ids,
                       const int* q_pos, const int* kv_len, const int* tier,
                       void* out, int n_blocks, int H, int KV, int BS,
                       int S, int MAXB, int tq, int nb_dev, int n_tiles,
                       int tpb, int n_spans, float scale,
                       cudaStream_t stream) {
  using T = __nv_bfloat16;
  constexpr int smem = Smem<D>::BYTES;
  auto kern = paged_prefill_mma<D, NWR>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int bs_log2 = (BS & (BS - 1)) == 0 ? __builtin_ctz(BS) : -1;
  kern<<<n_blocks, NWR * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(dpool),
      static_cast<const T*>(staged), table, seg_ids, q_pos, kv_len, tier,
      static_cast<T*>(out), H, KV, BS, bs_log2, S, MAXB, tq, nb_dev,
      n_tiles, tpb, n_spans, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const void* q, const void* dpool, const void* staged,
                   const int* table, const int* seg_ids, const int* q_pos,
                   const int* kv_len, const int* tier, void* out, int T_,
                   int H, int KV, int BS, int S, int MAXB, int tq,
                   int nb_dev, float scale, cudaStream_t stream) {
  // a block takes a span of tpb consecutive tiles, up to MAX_NWR * 16
  // rows; a tile of more rows (tq x G > 64) takes nz blocks of 64 rows
  const int rows = tq * (H / KV);
  constexpr int span = MAX_NWR * WARP_ROWS;
  const int tpb = rows < span ? span / rows : 1;
  const int nwr = min(MAX_NWR, (tpb * rows + WARP_ROWS - 1) / WARP_ROWS);
  const int nz = (rows + span - 1) / span;
  const int n_tiles = T_ / tq;
  const int n_spans = (n_tiles + tpb - 1) / tpb;
  // 1-d, span-major: (span, KV head, row group), see `tile_order`
  const int n_blocks = n_spans * KV * nz;
#define REPRO_PP_NWR(N)                                                    \
  return launch_nwr<D, N>(q, dpool, staged, table, seg_ids, q_pos, kv_len, \
                          tier, out, n_blocks, H, KV, BS, S, MAXB, tq,    \
                          nb_dev, n_tiles, tpb, n_spans, scale, stream)
  if (nwr == 1) REPRO_PP_NWR(1);
  if (nwr == 2) REPRO_PP_NWR(2);
  REPRO_PP_NWR(MAX_NWR);
#undef REPRO_PP_NWR
}

}  // namespace tc

}  // namespace
}  // namespace repro_torch

// C entries bound with ctypes. dtype: 0 = float32, 1 = bfloat16. Each
// returns a cudaError_t; 0 on success.
//
// paged_prefill_fwd launches the body: T % tq == 0, G = H / KV <= 16 and
// D in {32, 64, 128}. `tier` null selects the single pool. Otherwise
// `staged` is a device buffer of at least S * MAXB pool blocks whose slot
// s * MAXB + j holds the live block j of every host segment s
// (`stage_host_runs_fwd`), which the body reads in place of the device
// pool.
extern "C" int paged_prefill_fwd(const void* q, const void* dpool,
                                 const void* staged, const int* table,
                                 const int* seg_ids, const int* q_pos,
                                 const int* kv_len, const int* tier,
                                 void* out, int T_, int H, int KV, int D,
                                 int BS, int S, int MAXB, int tq, int nb_dev,
                                 float scale, int dtype, void* stream) {
  using namespace repro_torch;
  if (T_ == 0 || H == 0) return 0;
  if (tq <= 0 || T_ % tq != 0 || KV <= 0 || H % KV != 0 ||
      H / KV > MAX_G || nb_dev <= 0 || (dtype != 0 && dtype != 1) ||
      (D != 32 && D != 64 && D != 128) ||
      (tier != nullptr && staged == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_PP_ARGS                                                      \
  q, dpool, staged, table, seg_ids, q_pos, kv_len, tier, out, T_, H, KV, BS, \
      S, MAXB, tq, nb_dev, scale, s
  if (dtype == 0 && D == 32) return (int)launch<float, 32>(REPRO_PP_ARGS);
  if (dtype == 0 && D == 64) return (int)launch<float, 64>(REPRO_PP_ARGS);
  if (dtype == 0 && D == 128) return (int)launch<float, 128>(REPRO_PP_ARGS);
  // bf16 at D = 32: the CUDA-core kernel, by shape (paged_prefill_route)
  if (dtype == 1 && D == 32)
    return (int)launch<__nv_bfloat16, 32>(REPRO_PP_ARGS);
  if (dtype == 1 && D == 64) return (int)tc::launch<64>(REPRO_PP_ARGS);
  if (dtype == 1 && D == 128) return (int)tc::launch<128>(REPRO_PP_ARGS);
#undef REPRO_PP_ARGS
  return (int)cudaErrorInvalidValue;
}

// The body kernel paged_prefill_fwd launches for (D, dtype): 1 for the
// tensor-core kernel (bf16 at D = 64 and 128), 0 for the CUDA-core one
// (f32 at every D, bf16 at D = 32).
extern "C" int paged_prefill_route(int D, int dtype) {
  return dtype == 1 && (D == 64 || D == 128) ? 1 : 0;
}

// Host staging on the copy engine: for each of the n_runs rows (src, dst,
// n) of `runs` (host memory, int64), copy host-pool blocks [src, src + n)
// of `block_bytes` each from pinned `host_pool` to blocks [dst, dst + n)
// of the device buffer `staged`, all in one cudaMemcpyBatchAsync on
// `stream` (in stream order; not the legacy default stream, which the
// batch call refuses). The caller checks the ranges.
extern "C" int stage_host_runs_fwd(const void* host_pool, void* staged,
                                   const long long* runs, int n_runs,
                                   long long block_bytes, void* stream) {
#if CUDART_VERSION < 12080
#error "stage_host_runs_fwd needs cudaMemcpyBatchAsync (CUDA 12.8 or later)"
#endif
  if (n_runs == 0) return 0;
  if (host_pool == nullptr || staged == nullptr || runs == nullptr ||
      n_runs < 0 || block_bytes <= 0 || stream == nullptr)
    return (int)cudaErrorInvalidValue;
  std::vector<void*> dsts(n_runs), srcs(n_runs);
  std::vector<size_t> sizes(n_runs);
  for (int i = 0; i < n_runs; ++i) {
    const long long* r = runs + 3 * (size_t)i;
    srcs[i] = const_cast<char*>(static_cast<const char*>(host_pool)) +
              r[0] * block_bytes;
    dsts[i] = static_cast<char*>(staged) + r[1] * block_bytes;
    sizes[i] = (size_t)(r[2] * block_bytes);
  }
  cudaMemcpyAttributes attr;
  std::memset(&attr, 0, sizeof(attr));
  attr.srcAccessOrder = cudaMemcpySrcAccessOrderStream;
  attr.flags = cudaMemcpyFlagPreferOverlapWithCompute;
  size_t first = 0, fail = 0;
  return (int)cudaMemcpyBatchAsync(dsts.data(), srcs.data(), sizes.data(),
                                   (size_t)n_runs, &attr, &first, 1, &fail,
                                   static_cast<cudaStream_t>(stream));
}
