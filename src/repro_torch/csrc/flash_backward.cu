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
// j > q_offset + i - window; every key j < Skv is valid.
//
// Two kernels, in stream order, so every dq / dk / dv row has one
// writer (no atomics; the result is deterministic; the bf16 layout):
//   dq    one block per (q tile, head, batch): loops over the key tiles
//         the tile can see; also writes Delta (B,H,Sq) f32.
//   dkdv  one block per (key tile of 64, KV head, batch): loops over the
//         G query heads of its group and the q tiles that can see the
//         key tile, so GQA needs no atomics.
//
// bf16 at D = 64 / 80 / 128 (the train paths): every product on the
// tensor cores, as mma.sync m16n8k16 (bf16 in, f32 accumulate). The
// backward needs five
// products per (q tile, key tile) pair -- S and dP recomputed, dV, dK,
// dQ -- with operands in both orientations; ldmatrix gives each
// orientation from one row-major bf16 tile (.trans for Q, dout and K as
// the k x n operand), so no transposed copy is stored. The work is
// 10 * D operations per visible (query, key) pair; at the train shape
// (S = 1024, causal) that is ~300 per byte of q/k/v/o/dout/dq/dk/dv
// moved, above the H100's ridge: the bound is tensor-core issue and the
// shared-memory reads that feed it (the dq kernel recomputes S and dP,
// seven products in all against the minimum five). So:
// each warp owns 16 rows (dq: queries; dkdv: keys) and computes S^T =
// K Q^T directly in dkdv, so that P^T and dS^T leave the accumulators in
// the A-fragment layout of dV = P^T dout and dK = dS^T q without a trip
// through shared memory (likewise dS for dq = dS K); tiles are bf16 in
// shared memory, laid out so that ldmatrix is conflict-free
// (`tile_row_bytes`, hopper.cuh: at D = 64 / 128 XOR-swizzled by 16-byte
// chunk, at D = 80 -- 10 chunks, too few to XOR over 8 -- rows padded to
// 176 bytes), and double-buffered with cp.async (K/V in dq, q/dout and
// their lse / Delta rows in dkdv). Nothing else depends on D: a row is
// D / 16 k16 steps and D / 8 n8 accumulator tiles (5 and 10 at D = 80).
// Both grids are 1-d and
// tile-major, heaviest tiles first under a causal mask (the last q
// tiles for dq, the first key tiles for dkdv), so the long blocks do not
// land in the last wave; at D = 64 the register caps leave room for 4
// (dq) and 3 (dkdv) blocks per SM. At D = 80 the dq kernel takes 67,584
// bytes of shared memory and dkdv 68,608 (64 query rows a tile), so 3
// blocks of each fit an SM; the D = 80 constants (kBq80, kMinDq80,
// kMinDkdv80) come from a sweep on the card (below). P is
// recomputed as exp2(s * scale * log2e - lse * log2e); P and dS are
// rounded to bf16 as the A operands of dV, dK and dq, and every sum is
// f32. That P is not bit-identical to the one the forward normalised
// (the forward's S comes from wgmma, in another order); the card checks
// hold dq, dk and dv to autograd through the plain f32 version within
// atol = 2e-2 * max|grad|, rtol = 2e-2.
//
// f32 at every D (the examples' training: train_tiny, quickstart) and
// bf16 at D = 32 (the smoke configs): the same five products in 3xTF32
// on the tensor cores (`tf::flash_bwd_{dq,dkdv}_tf32`; hopper.cuh: each
// f32 product is three mma.sync m16n8k8 .tf32 passes on the operands'
// TF32 pairs, ~2^-22 relative, at a third of TF32's 495 TFLOP/s). The
// CUDA-core pair they replace was bound by scalar shared-memory reads of
// padded f32 tiles (two FMAs a load), loaded tiles synchronously between
// barriers, took 84-149 KB of shared memory, and its dk/dv grid of
// (Skv / 64) x KV x B blocks left half the card idle at train_tiny's
// shape (64 blocks). Here dq keeps the bf16 layout (four warps of 16
// query rows) over K/V tiles of 32 keys in a two-stage cp.async ring,
// each tile split into its TF32 hi and lo once as it lands (the other
// operands are split in registers as they are read); dk/dv takes 16 keys
// a block, split once, and its eight warps split the query loop (each
// warp 8 of a stage's 64 rows), so the grid is (Skv / 16) x KV x B (256
// blocks at train_tiny's shape) and a block's longest chain an eighth of
// the 64-key layout's; the warps' partial dk / dv are summed through
// shared memory in warp order (no atomics,
// deterministic). Tiles are f32, XOR-swizzled by 16-byte chunk
// (`f32_off`) so that fragments read both ways ([n][k] and [k][n]) are
// free of bank conflicts; the k index of every product is permuted so
// that S, P and dS leave the accumulators as A fragments. A warp skips
// the tiles its rows all mask. bf16 inputs are widened to f32 as their
// tiles land and take no lo passes (exact in TF32). That is a dispatch
// by dtype and shape, not a fallback: nothing retries another kernel
// when a launch fails.
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace repro_torch {
namespace {

__device__ __forceinline__ bool visible(int qpos, int kpos, int causal,
                                        int window) {
  return (!causal || qpos >= kpos) && (window <= 0 || kpos > qpos - window);
}

// ------------------------------------------------ bf16: mma.sync m16n8k16 --

namespace tc {

constexpr int BQ = 64;        // dq kernel: query rows per block
constexpr int BK = 64;        // keys per tile (both kernels)
constexpr int THREADS = 128;  // four warps, 16 rows each
constexpr float kLog2e = 1.4426950408889634f;

// D = 80's dkdv query rows per tile and blocks per SM of both kernels,
// from `tools/flash_ab.py d80 --sweep` on the card at B 4, S 1024,
// H = KV = 32: dq capped to 168 registers for 3 blocks beat 2 or 1 by
// 13-15 %; dkdv at 64 query rows (232 registers, 2 blocks) beat 32 rows
// by 4-14 %
constexpr int kBq80 = 64, kMinDq80 = 3, kMinDkdv80 = 2;

// dkdv kernel: query rows per tile (fewer at D = 128, where the dk / dv
// accumulators take twice the registers)
template <int D>
constexpr int dkdv_bq() { return D == 64 ? 64 : D == 80 ? kBq80 : 32; }

// Blocks per SM the register allocation must leave room for. At D = 64
// more resident warps hide ldmatrix / mma latency better (measured on
// the card: dq at 4 blocks and dkdv at 3 beat the unconstrained
// allocation); at D = 128 the cap would spill the accumulators.
template <int D>
constexpr int min_blocks_dq() { return D == 64 ? 4 : D == 80 ? kMinDq80 : 1; }
template <int D>
constexpr int min_blocks_dkdv() {
  return D == 64 ? 3 : D == 80 ? kMinDkdv80 : 1;
}

// Tiles are [rows][D] bf16 at tile_row_bytes<D>() a row (hopper.cuh:
// XOR-swizzled at D % 64 == 0, padded by 16 bytes at D = 80).
template <int D>
struct DqSmem {
  static constexpr int TQ = BQ * tile_row_bytes<D>();
  static constexpr int TK = BK * tile_row_bytes<D>();
  static constexpr int Q = 0, DO = TQ, KV = 2 * TQ;   // KV: 2 x (K, V)
  static constexpr int BYTES = KV + 4 * TK;
};

template <int D>
struct KvSmem {
  static constexpr int BQ2 = dkdv_bq<D>();
  static constexpr int TQ = BQ2 * tile_row_bytes<D>();
  static constexpr int TK = BK * tile_row_bytes<D>();
  static constexpr int K = 0, V = TK, ST = 2 * TK;
  // one stage: q tile, dout tile, lse[BQ2], delta[BQ2]
  static constexpr int STAGE = 2 * TQ + 2 * BQ2 * 4;
  static constexpr int BYTES = ST + 2 * STAGE;
};

// cp.async rows [row0, row0 + ROWS) of one head (rows `stride` elements
// apart) into a swizzled or padded bf16 tile; rows >= valid are
// zero-filled.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile_async(uint32_t dst,
                                                const __nv_bfloat16* base,
                                                int row0, int valid,
                                                int stride) {
  constexpr int CPR = D / 8;   // 16-byte chunks per row
  for (int idx = threadIdx.x; idx < ROWS * CPR; idx += THREADS) {
    const int r = idx / CPR, ch = idx % CPR;
    const bool ok = row0 + r < valid;
    cp_async16(dst + swz<D>(r, ch * 8),
               base + (size_t)(ok ? row0 + r : 0) * stride + ch * 8, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, min_blocks_dq<D>())
flash_bwd_dq_mma(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const __nv_bfloat16* __restrict__ o,
                 const __nv_bfloat16* __restrict__ dout,
                 const float* __restrict__ lse, float* __restrict__ delta,
                 __nv_bfloat16* __restrict__ dq, int Sq, int Skv, int H,
                 int KV, int q_offset, int causal, int window,
                 float scale) {
  using L = DqSmem<D>;
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t s0 = smem_u32(smem);
  const TileOrder to = tile_order((Sq + BQ - 1) / BQ, H, causal);
  const int qt = to.tile, h = to.head, b = to.batch;
  const int kvh = h / (H / KV);
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const int q0 = qt * BQ;
  const int q_rows = min(BQ, Sq - q0);
  const int q_first = q_offset + q0, q_last = q_first + q_rows - 1;
  int k_end = Skv;
  if (causal) k_end = min(k_end, q_last + 1);
  const int k_begin = window > 0 ? max(0, q_first - window + 1) : 0;
  const int kt_begin = k_begin / BK;
  const int kt_end = k_end > 0 ? (k_end + BK - 1) / BK : 0;

  const size_t qhead = ((size_t)b * Sq * H + h) * D;   // row stride H*D
  const __nv_bfloat16* kb = k + ((size_t)b * Skv * KV + kvh) * D;
  const __nv_bfloat16* vb = v + ((size_t)b * Skv * KV + kvh) * D;
  const size_t lrow = ((size_t)b * H + h) * Sq + q0;

  load_tile_async<D, BQ>(s0 + L::Q, q + qhead, q0, Sq, H * D);
  load_tile_async<D, BQ>(s0 + L::DO, dout + qhead, q0, Sq, H * D);
  if (kt_begin < kt_end) {
    load_tile_async<D, BK>(s0 + L::KV, kb, kt_begin * BK, Skv, KV * D);
    load_tile_async<D, BK>(s0 + L::KV + L::TK, vb, kt_begin * BK, Skv,
                           KV * D);
  }
  cp_async_commit();

  // Delta = rowsum(dout * o) for this thread's two rows (rq, rq + 8),
  // each warp over its 16 rows, and the rows' lse in log2 units
  const int rq = w * 16 + g;
  float dl[2], ls[2];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int rr = w * 16 + i;
    float acc = 0.f;
    if (rr < q_rows) {
      const size_t off = qhead + (size_t)(q0 + rr) * H * D;
#pragma unroll
      for (int col = 2 * lane; col < D; col += 64) {
        const float2 a = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(o + off + col));
        const float2 d = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(dout + off + col));
        acc = fmaf(a.x, d.x, fmaf(a.y, d.y, acc));
      }
    }
#pragma unroll
    for (int sh = 16; sh > 0; sh >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, sh);
    if (lane == 0 && rr < q_rows) delta[lrow + rr] = acc;
    if (i == g) dl[0] = acc;
    if (i == g + 8) dl[1] = acc;
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
    ls[j] = rq + 8 * j < q_rows ? lse[lrow + rq + 8 * j] * kLog2e : 0.f;
  const float scale_log2 = scale * kLog2e;

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int st = (kt - kt_begin) & 1;
    if (kt + 1 < kt_end) {     // prefetch the next K / V tile
      const uint32_t nx = s0 + L::KV + (st ^ 1) * 2 * L::TK;
      load_tile_async<D, BK>(nx, kb, (kt + 1) * BK, Skv, KV * D);
      load_tile_async<D, BK>(nx + L::TK, vb, (kt + 1) * BK, Skv, KV * D);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const uint32_t sK = s0 + L::KV + st * 2 * L::TK, sV = sK + L::TK;

    // S = Q K^T and dP = dout V^T, this warp's 16 rows x BK keys
    float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int i = 0; i < BK / 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4], da[4];
      ldsm_x4(qa, a_addr<D>(s0 + L::Q, w * 16, kk * 16, lane));
      ldsm_x4(da, a_addr<D>(s0 + L::DO, w * 16, kk * 16, lane));
#pragma unroll
      for (int nn = 0; nn < BK / 16; ++nn) {
        uint32_t kf[4], vf[4];
        ldsm_x4(kf, b_nk_addr<D>(sK, nn * 16, kk * 16, lane));
        ldsm_x4(vf, b_nk_addr<D>(sV, nn * 16, kk * 16, lane));
        mma_bf16(s[2 * nn], qa, kf[0], kf[1]);
        mma_bf16(s[2 * nn + 1], qa, kf[2], kf[3]);
        mma_bf16(dp[2 * nn], da, vf[0], vf[1]);
        mma_bf16(dp[2 * nn + 1], da, vf[2], vf[3]);
      }
    }

    // P = exp2(s * scale * log2e - lse * log2e), dS = P (dP - Delta)
    const int k0 = kt * BK;
    const bool edge = k0 + BK > Skv || (causal && k0 + BK - 1 > q_first) ||
                      (window > 0 && k0 <= q_last - window);
#pragma unroll
    for (int i = 0; i < BK / 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int hi = j >> 1;
        float p = ex2_approx(fmaf(s[i][j], scale_log2, -ls[hi]));
        if (edge) {
          const int kp = k0 + 8 * i + 2 * c + (j & 1);
          if (!(kp < Skv && visible(q_first + rq + 8 * hi, kp, causal,
                                    window)))
            p = 0.f;
        }
        s[i][j] = p * (dp[i][j] - dl[hi]);
      }
    uint32_t dsa[BK / 16][4];
    acc_to_a<BK / 8>(s, dsa);

    // dq += dS K, K read transposed ([key][d] is k x n)
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc)
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        uint32_t kf[4];
        ldsm_x4_t(kf, b_kn_addr<D>(sK, kc * 16, dn * 16, lane));
        mma_bf16(acc[2 * dn], dsa[kc], kf[0], kf[1]);
        mma_bf16(acc[2 * dn + 1], dsa[kc], kf[2], kf[3]);
      }
    __syncthreads();   // the next prefetch overwrites this stage
  }
  cp_async_wait<0>();

#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int row = rq + 8 * hi;
    if (row >= q_rows) continue;
    __nv_bfloat16* drow = dq + qhead + (size_t)(q0 + row) * H * D;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<uint32_t*>(drow + 8 * i + 2 * c) = pack_bf16(
          acc[i][2 * hi] * scale, acc[i][2 * hi + 1] * scale);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, min_blocks_dkdv<D>())
flash_bwd_dkdv_mma(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   const __nv_bfloat16* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   __nv_bfloat16* __restrict__ dk,
                   __nv_bfloat16* __restrict__ dv, int Sq, int Skv, int H,
                   int KV, int q_offset, int causal, int window,
                   float scale) {
  using L = KvSmem<D>;
  constexpr int BQ2 = L::BQ2;
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t s0 = smem_u32(smem);
  // causal: key tile 0 is seen by the most q tiles, so rank 0 = tile 0
  const TileOrder to = tile_order((Skv + BK - 1) / BK, KV, false);
  const int kt = to.tile, kvh = to.head, b = to.batch;
  const int G = H / KV;
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const int k0 = kt * BK;
  const int k_rows = min(BK, Skv - k0);
  const size_t khead = ((size_t)b * Skv * KV + kvh) * D;  // row stride KV*D

  load_tile_async<D, BK>(s0 + L::K, k + khead, k0, Skv, KV * D);
  load_tile_async<D, BK>(s0 + L::V, v + khead, k0, Skv, KV * D);

  // query rows i (position q_offset + i) that can see a key of this tile
  const int i_begin = causal ? max(0, k0 - q_offset) : 0;
  int i_end = Sq;
  if (window > 0) i_end = min(i_end, k0 + k_rows - 1 + window - q_offset);
  const int qt_begin = i_begin / BQ2;
  const int qt_end = i_end > i_begin ? (i_end + BQ2 - 1) / BQ2 : qt_begin;
  const int nqt = qt_end - qt_begin;
  const int n_it = G * nqt;    // (head of the group, q tile) pairs

  auto load_stage = [&](int it, int st) {
    const int h = kvh * G + it / nqt;
    const int q0 = (qt_begin + it % nqt) * BQ2;
    const size_t qhead = ((size_t)b * Sq * H + h) * D;
    const size_t lhead = ((size_t)b * H + h) * Sq;
    const uint32_t sq = s0 + L::ST + st * L::STAGE;
    load_tile_async<D, BQ2>(sq, q + qhead, q0, Sq, H * D);
    load_tile_async<D, BQ2>(sq + L::TQ, dout + qhead, q0, Sq, H * D);
    for (int i = threadIdx.x; i < BQ2; i += THREADS) {
      const bool ok = q0 + i < Sq;
      const size_t at = lhead + (ok ? q0 + i : 0);
      cp_async4(sq + 2 * L::TQ + 4 * i, lse + at, ok);
      cp_async4(sq + 2 * L::TQ + 4 * BQ2 + 4 * i, delta + at, ok);
    }
  };
  if (n_it > 0) load_stage(0, 0);
  cp_async_commit();

  const int rk = w * 16 + g;    // this thread's key rows rk, rk + 8
  const float scale_log2 = scale * kLog2e;
  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dka[i][j] = dva[i][j] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1;
    if (it + 1 < n_it) load_stage(it + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int q0 = (qt_begin + it % nqt) * BQ2;
    const uint32_t sQ = s0 + L::ST + st * L::STAGE, sO = sQ + L::TQ;
    const float* ls = reinterpret_cast<const float*>(
        smem + L::ST + st * L::STAGE + 2 * L::TQ);
    const float* dl = ls + BQ2;

    // S^T = K Q^T and dP^T = V dout^T: rows are this warp's 16 keys
    float s[BQ2 / 8][4], dp[BQ2 / 8][4];
#pragma unroll
    for (int i = 0; i < BQ2 / 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ka[4], va[4];
      ldsm_x4(ka, a_addr<D>(s0 + L::K, w * 16, kk * 16, lane));
      ldsm_x4(va, a_addr<D>(s0 + L::V, w * 16, kk * 16, lane));
#pragma unroll
      for (int nn = 0; nn < BQ2 / 16; ++nn) {
        uint32_t qf[4], of[4];
        ldsm_x4(qf, b_nk_addr<D>(sQ, nn * 16, kk * 16, lane));
        ldsm_x4(of, b_nk_addr<D>(sO, nn * 16, kk * 16, lane));
        mma_bf16(s[2 * nn], ka, qf[0], qf[1]);
        mma_bf16(s[2 * nn + 1], ka, qf[2], qf[3]);
        mma_bf16(dp[2 * nn], va, of[0], of[1]);
        mma_bf16(dp[2 * nn + 1], va, of[2], of[3]);
      }
    }

    // P^T and dS^T = P^T (dP^T - Delta), masked to 0
    const int qp_first = q_offset + q0;
    const bool edge = q0 + BQ2 > Sq || k0 + BK > Skv ||
                      (causal && k0 + BK - 1 > qp_first) ||
                      (window > 0 && k0 <= qp_first + BQ2 - 1 - window);
#pragma unroll
    for (int i = 0; i < BQ2 / 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qc = 8 * i + 2 * c + (j & 1);
        float p = ex2_approx(
            fmaf(s[i][j], scale_log2, -ls[qc] * kLog2e));
        if (edge) {
          const int kp = k0 + rk + 8 * (j >> 1);
          if (!(kp < Skv && q0 + qc < Sq &&
                visible(qp_first + qc, kp, causal, window)))
            p = 0.f;
        }
        s[i][j] = p;
        dp[i][j] = p * (dp[i][j] - dl[qc]);
      }
    uint32_t pa[BQ2 / 16][4], dsa[BQ2 / 16][4];
    acc_to_a<BQ2 / 8>(s, pa);
    acc_to_a<BQ2 / 8>(dp, dsa);

    // dv += P^T dout, dk += dS^T q; dout and q read transposed
#pragma unroll
    for (int kc = 0; kc < BQ2 / 16; ++kc)
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        uint32_t of[4], qf[4];
        ldsm_x4_t(of, b_kn_addr<D>(sO, kc * 16, dn * 16, lane));
        ldsm_x4_t(qf, b_kn_addr<D>(sQ, kc * 16, dn * 16, lane));
        mma_bf16(dva[2 * dn], pa[kc], of[0], of[1]);
        mma_bf16(dva[2 * dn + 1], pa[kc], of[2], of[3]);
        mma_bf16(dka[2 * dn], dsa[kc], qf[0], qf[1]);
        mma_bf16(dka[2 * dn + 1], dsa[kc], qf[2], qf[3]);
      }
    __syncthreads();   // the next prefetch overwrites this stage
  }
  cp_async_wait<0>();

#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int row = rk + 8 * hi;
    if (row >= k_rows) continue;
    const size_t off = khead + (size_t)(k0 + row) * KV * D;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      *reinterpret_cast<uint32_t*>(dk + off + 8 * i + 2 * c) = pack_bf16(
          dka[i][2 * hi] * scale, dka[i][2 * hi + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + off + 8 * i + 2 * c) =
          pack_bf16(dva[i][2 * hi], dva[i][2 * hi + 1]);
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const float* lse,
                   float* delta, void* dq, void* dk, void* dv, int B, int Sq,
                   int Skv, int H, int KV, int q_offset, int causal,
                   int window, float scale, cudaStream_t stream) {
  using T = __nv_bfloat16;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  if (Sq > 0) {
    constexpr int smem = DqSmem<D>::BYTES;
    auto kern = flash_bwd_dq_mma<D>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const int grid = (Sq + BQ - 1) / BQ * H * B;   // tile-major, 1-d
    kern<<<grid, THREADS, smem, stream>>>(
        qt, kt, vt, static_cast<const T*>(o), dot, lse, delta,
        static_cast<T*>(dq), Sq, Skv, H, KV, q_offset, causal, window, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (Skv > 0) {
    constexpr int smem = KvSmem<D>::BYTES;
    auto kern = flash_bwd_dkdv_mma<D>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const int grid = (Skv + BK - 1) / BK * KV * B;
    kern<<<grid, THREADS, smem, stream>>>(
        qt, kt, vt, dot, lse, delta, static_cast<T*>(dk),
        static_cast<T*>(dv), Sq, Skv, H, KV, q_offset, causal, window, scale);
    return cudaGetLastError();
  }
  return cudaSuccess;
}

}  // namespace tc

// ------------------------------------ f32 and bf16 at D = 32: 3xTF32 --

namespace tf {

constexpr int THREADS = 128;   // four warps
constexpr float kLog2e = 1.4426950408889634f;

// dq's keys per tile below D = 128; dk/dv's warps a block (each takes
// 64 / kWarpsKv of a stage's 64 query rows) and the blocks per SM its
// register allocation must leave room for up to D = 64; from
// `tools/flash_ab.py f32 --sweep` on the card
constexpr int kBkDq = 32, kWarpsKv = 8, kMinKv = 2;

// dq: query rows per block (16 a warp) and keys per tile (32 at D = 128,
// where two stages of 64 f32 keys would leave room for one block an SM)
constexpr int BQ = 64;
template <int D>
constexpr int dq_bk() { return D == 128 ? 32 : kBkDq; }
template <int D>
constexpr int min_kv() { return D <= 64 ? kMinKv : 1; }
// dkdv: keys per block (the 16 rows of each warp's S^T), query rows per
// stage, and threads
constexpr int BKV = 16, BQ2 = 64, THREADS_KV = 32 * kWarpsKv;

// Shared memory in floats, every tile f32 at f32_pitch<D>() a row.
template <int D>
struct DqSmem {
  static constexpr int BK = dq_bk<D>();
  static constexpr int TQ = BQ * f32_pitch<D>();
  static constexpr int TK = BK * f32_pitch<D>();
  static constexpr int Q = 0, DO = TQ, KV = 2 * TQ;   // KV: 2 x (K, V)
  static constexpr int LO = KV + 4 * TK;   // f32: the tile's K, V lo
  static constexpr int BYTES = 4 * (LO + 2 * TK);
};
// K and V (their TF32 hi, split once as they land) and their lo, then
// the stages
template <int D>
struct KvSmem {
  static constexpr int TK = BKV * f32_pitch<D>();
  static constexpr int TQ = BQ2 * f32_pitch<D>();
  static constexpr int K = 0, V = TK, LO = 2 * TK, ST = 4 * TK;
  // one stage: q tile, dout tile, lse[BQ2], delta[BQ2]
  static constexpr int STAGE = 2 * TQ + 2 * BQ2;
  static constexpr int BYTES = 4 * (ST + 2 * STAGE);
  static_assert(kWarpsKv * 2 * BKV * D <= 2 * STAGE,
                "the warps' partial dk / dv fit in the stages");
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_tf32(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ o,
                  const T* __restrict__ dout, const float* __restrict__ lse,
                  float* __restrict__ delta, T* __restrict__ dq, int Sq,
                  int Skv, int H, int KV, int q_offset, int causal,
                  int window, float scale) {
  constexpr bool EXACT = !std::is_same<T, float>::value;
  using L = DqSmem<D>;
  constexpr int BK = L::BK;
  extern __shared__ __align__(16) float fsmem[];
  const TileOrder to = tile_order((Sq + BQ - 1) / BQ, H, causal);
  const int qt = to.tile, h = to.head, b = to.batch;
  const int kvh = h / (H / KV);
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
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
  auto load_kv = [&](int kt, int st) {
    float* sk = fsmem + L::KV + 2 * st * L::TK;
    load_tile_f32<D, BK, THREADS>(sk, kb, kt * BK, Skv, KV * D);
    load_tile_f32<D, BK, THREADS>(sk + L::TK, vb, kt * BK, Skv, KV * D);
  };

  load_tile_f32<D, BQ, THREADS>(fsmem + L::Q, q + qhead, q0, Sq, H * D);
  load_tile_f32<D, BQ, THREADS>(fsmem + L::DO, dout + qhead, q0, Sq, H * D);
  if (kt_begin < kt_end) load_kv(kt_begin, 0);
  cp_async_commit();

  // Delta = rowsum(dout * o) for this thread's two rows (rq, rq + 8),
  // each warp over its 16 rows, and the rows' lse in log2 units
  const int rq = w * 16 + g;
  float dl[2], ls[2];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int rr = w * 16 + i;
    float acc = 0.f;
    if (rr < q_rows) {
      const size_t off = qhead + (size_t)(q0 + rr) * H * D;
      for (int col = 2 * lane; col < D; col += 64) {
        const float2 a = load2(o + off + col), d = load2(dout + off + col);
        acc = fmaf(a.x, d.x, fmaf(a.y, d.y, acc));
      }
    }
#pragma unroll
    for (int sh = 16; sh > 0; sh >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, sh);
    if (lane == 0 && rr < q_rows) delta[lrow + rr] = acc;
    if (i == g) dl[0] = acc;
    if (i == g + 8) dl[1] = acc;
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
    ls[j] = rq + 8 * j < q_rows ? lse[lrow + rq + 8 * j] * kLog2e : 0.f;
  const float scale_log2 = scale * kLog2e;
  const int wq_first = q_first + w * 16, wq_last = wq_first + 15;
  const bool live = w * 16 < q_rows;

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int st = (kt - kt_begin) & 1;
    if (kt + 1 < kt_end) load_kv(kt + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    float* sK = fsmem + L::KV + 2 * st * L::TK;
    const float* sV = sK + L::TK;
    const float* kLo = fsmem + L::LO;   // f32: K lo, then V lo
    if constexpr (!EXACT) {   // K and V (adjacent) to hi and lo, once
      split_tile<THREADS>(sK, fsmem + L::LO, 2 * L::TK);
      __syncthreads();
    }
    const int k0 = kt * BK;
    const bool skip = !live || (causal && k0 > wq_last) ||
                      (window > 0 && k0 + BK - 1 <= wq_first - window);
    if (!skip) {
      // S = Q K^T and dP = dout V^T, this warp's 16 rows x BK keys
      float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
      for (int i = 0; i < BK / 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        FragA qa, da;
        ld_a<D, EXACT>(qa, fsmem + L::Q, w * 16, kk * 8, lane);
        ld_a<D, EXACT>(da, fsmem + L::DO, w * 16, kk * 8, lane);
#pragma unroll
        for (int nn = 0; nn < BK / 8; ++nn) {
          FragB kf, vf;
          if constexpr (EXACT) {
            ld_b_nk<D, true>(kf, sK, nn * 8, kk * 8, lane);
            ld_b_nk<D, true>(vf, sV, nn * 8, kk * 8, lane);
          } else {
            ld_b_nk<D>(kf, sK, kLo, nn * 8, kk * 8, lane);
            ld_b_nk<D>(vf, sV, kLo + L::TK, nn * 8, kk * 8, lane);
          }
          mma3<EXACT, EXACT>(s[nn], qa, kf);
          mma3<EXACT, EXACT>(dp[nn], da, vf);
        }
      }
      // P = exp2(s * scale * log2e - lse * log2e), dS = P (dP - Delta)
      const bool edge = k0 + BK > Skv ||
                        (causal && k0 + BK - 1 > wq_first) ||
                        (window > 0 && k0 <= wq_last - window);
#pragma unroll
      for (int i = 0; i < BK / 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int hi = j >> 1;
          float p = ex2_approx(fmaf(s[i][j], scale_log2, -ls[hi]));
          if (edge) {
            const int kp = k0 + 8 * i + 2 * c + (j & 1);
            if (!(kp < Skv && visible(q_first + rq + 8 * hi, kp, causal,
                                      window)))
              p = 0.f;
          }
          s[i][j] = p * (dp[i][j] - dl[hi]);
        }
      // dq += dS K: dS's n8 tile kc is the A fragment of k8 step kc
#pragma unroll
      for (int kc = 0; kc < BK / 8; ++kc) {
        FragA dsa;
        acc_a(dsa, s[kc]);
#pragma unroll
        for (int dn = 0; dn < D / 8; ++dn) {
          FragB kf;
          if constexpr (EXACT)
            ld_b_kn<D, true>(kf, sK, kc * 8, dn * 8, lane);
          else
            ld_b_kn<D>(kf, sK, kLo, kc * 8, dn * 8, lane);
          mma3<false, EXACT>(acc[dn], dsa, kf);
        }
      }
    }
    __syncthreads();   // the next prefetch overwrites this stage
  }
  cp_async_wait<0>();

#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int row = rq + 8 * hi;
    if (row >= q_rows) continue;
    T* drow = dq + qhead + (size_t)(q0 + row) * H * D;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      store2(drow + 8 * i + 2 * c, acc[i][2 * hi] * scale,
             acc[i][2 * hi + 1] * scale);
  }
}

// dk / dv of 16 keys: every warp computes S^T = K Q^T for the 16 keys
// over its own RW of the stage's 64 query rows, so the query loop (the G
// heads of the group x the q tiles that see the keys) is split kWarpsKv
// ways; the warps' partial dk / dv are summed through shared memory in
// warp order at the end (no atomics: the result is deterministic).
template <typename T, int D>
__global__ void __launch_bounds__(THREADS_KV, min_kv<D>())
flash_bwd_dkdv_tf32(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dk,
                    T* __restrict__ dv, int Sq, int Skv, int H, int KV,
                    int q_offset, int causal, int window, float scale) {
  constexpr bool EXACT = !std::is_same<T, float>::value;
  constexpr int RW = BQ2 / kWarpsKv;   // query rows a warp: RW / 8 n8 tiles
  using L = KvSmem<D>;
  extern __shared__ __align__(16) float fsmem[];
  // causal: key tile 0 is seen by the most q tiles, so rank 0 = tile 0
  const TileOrder to = tile_order((Skv + BKV - 1) / BKV, KV, false);
  const int kt = to.tile, kvh = to.head, b = to.batch;
  const int G = H / KV;
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const int k0 = kt * BKV;
  const int k_rows = min(BKV, Skv - k0);
  const size_t khead = ((size_t)b * Skv * KV + kvh) * D;  // row stride KV*D

  load_tile_f32<D, BKV, THREADS_KV>(fsmem + L::K, k + khead, k0, Skv,
                                    KV * D);
  load_tile_f32<D, BKV, THREADS_KV>(fsmem + L::V, v + khead, k0, Skv,
                                    KV * D);

  // query rows i (position q_offset + i) that can see a key of this tile
  const int i_begin = causal ? max(0, k0 - q_offset) : 0;
  int i_end = Sq;
  if (window > 0) i_end = min(i_end, k0 + k_rows - 1 + window - q_offset);
  const int qt_begin = i_begin / BQ2;
  const int qt_end = i_end > i_begin ? (i_end + BQ2 - 1) / BQ2 : qt_begin;
  const int nqt = qt_end - qt_begin;
  const int n_it = G * nqt;    // (head of the group, q tile) pairs

  auto load_stage = [&](int it, int st) {
    const int h = kvh * G + it / nqt;
    const int q0 = (qt_begin + it % nqt) * BQ2;
    const size_t qhead = ((size_t)b * Sq * H + h) * D;
    const size_t lhead = ((size_t)b * H + h) * Sq;
    float* sq = fsmem + L::ST + st * L::STAGE;
    load_tile_f32<D, BQ2, THREADS_KV>(sq, q + qhead, q0, Sq, H * D);
    load_tile_f32<D, BQ2, THREADS_KV>(sq + L::TQ, dout + qhead, q0, Sq,
                                      H * D);
    for (int i = threadIdx.x; i < BQ2; i += THREADS_KV) {
      const bool ok = q0 + i < Sq;
      const size_t at = lhead + (ok ? q0 + i : 0);
      cp_async4(smem_u32(sq + 2 * L::TQ + i), lse + at, ok);
      cp_async4(smem_u32(sq + 2 * L::TQ + BQ2 + i), delta + at, ok);
    }
  };
  if (n_it > 0) load_stage(0, 0);
  cp_async_commit();
  // K and V are every iteration's A operands: split them once (the
  // first iteration's barrier publishes the split)
  if constexpr (!EXACT) {
    cp_async_wait<0>();
    __syncthreads();
    split_tile<THREADS_KV>(fsmem + L::K, fsmem + L::LO, 2 * L::TK);
  }

  const float scale_log2 = scale * kLog2e;
  const int k_last = k0 + k_rows - 1;
  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dka[i][j] = dva[i][j] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1;
    if (it + 1 < n_it) load_stage(it + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int q0 = (qt_begin + it % nqt) * BQ2;
    const float* sQ = fsmem + L::ST + st * L::STAGE;
    const float* sO = sQ + L::TQ;
    const float* ls = sQ + 2 * L::TQ;
    const float* dl = ls + BQ2;
    // this warp's query rows wr .. wr + RW - 1 of the stage
    const int wr = w * RW;
    const int wq_first = q_offset + q0 + wr, wq_last = wq_first + RW - 1;
    const bool skip = q0 + wr >= Sq || (causal && wq_last < k0) ||
                      (window > 0 && wq_first >= k_last + window);
    if (!skip) {
      // S^T = K Q^T and dP^T = V dout^T: 16 keys x this warp's RW rows
      float s[RW / 8][4], dp[RW / 8][4];
#pragma unroll
      for (int i = 0; i < RW / 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        FragA ka, va;
        if constexpr (EXACT) {
          ld_a<D, true>(ka, fsmem + L::K, 0, kk * 8, lane);
          ld_a<D, true>(va, fsmem + L::V, 0, kk * 8, lane);
        } else {
          ld_a<D>(ka, fsmem + L::K, fsmem + L::LO, 0, kk * 8, lane);
          ld_a<D>(va, fsmem + L::V, fsmem + L::LO + L::TK, 0, kk * 8, lane);
        }
#pragma unroll
        for (int nn = 0; nn < RW / 8; ++nn) {
          FragB qf, of;
          ld_b_nk<D, EXACT>(qf, sQ, wr + nn * 8, kk * 8, lane);
          ld_b_nk<D, EXACT>(of, sO, wr + nn * 8, kk * 8, lane);
          mma3<EXACT, EXACT>(s[nn], ka, qf);
          mma3<EXACT, EXACT>(dp[nn], va, of);
        }
      }
      // P^T and dS^T = P^T (dP^T - Delta), masked to 0
      const bool edge = q0 + wr + RW > Sq || k0 + BKV > Skv ||
                        (causal && k_last > wq_first) ||
                        (window > 0 && k0 <= wq_last - window);
#pragma unroll
      for (int i = 0; i < RW / 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qc = wr + 8 * i + 2 * c + (j & 1);
          float p = ex2_approx(fmaf(s[i][j], scale_log2, -ls[qc] * kLog2e));
          if (edge) {
            const int kp = k0 + g + 8 * (j >> 1);
            if (!(kp < Skv && q0 + qc < Sq &&
                  visible(q_offset + q0 + qc, kp, causal, window)))
              p = 0.f;
          }
          s[i][j] = p;
          dp[i][j] = p * (dp[i][j] - dl[qc]);
        }
      // dv += P^T dout, dk += dS^T q over this warp's rows (k8 step kc:
      // rows wr + 8 kc ..), dout and q read [k][n]
#pragma unroll
      for (int kc = 0; kc < RW / 8; ++kc) {
        FragA pa, dsa;
        acc_a(pa, s[kc]);
        acc_a(dsa, dp[kc]);
#pragma unroll
        for (int dn = 0; dn < D / 8; ++dn) {
          FragB of, qf;
          ld_b_kn<D, EXACT>(of, sO, wr + kc * 8, dn * 8, lane);
          ld_b_kn<D, EXACT>(qf, sQ, wr + kc * 8, dn * 8, lane);
          mma3<false, EXACT>(dva[dn], pa, of);
          mma3<false, EXACT>(dka[dn], dsa, qf);
        }
      }
    }
    __syncthreads();   // the next prefetch overwrites this stage
  }
  cp_async_wait<0>();
  __syncthreads();

  // the warps' partial sums, in the stages: part[w][dk | dv][key][D]
  float* part = fsmem + L::ST;
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int at = (g + 8 * hi) * D + 8 * i + 2 * c;
      float* pk = part + (2 * w) * BKV * D + at;
      float* pv = part + (2 * w + 1) * BKV * D + at;
      *reinterpret_cast<float2*>(pk) =
          make_float2(dka[i][2 * hi], dka[i][2 * hi + 1]);
      *reinterpret_cast<float2*>(pv) =
          make_float2(dva[i][2 * hi], dva[i][2 * hi + 1]);
    }
  __syncthreads();
  for (int e = 2 * threadIdx.x; e < BKV * D; e += 2 * THREADS_KV) {
    const int row = e / D, col = e % D;
    if (row >= k_rows) continue;
    float2 sk = make_float2(0.f, 0.f), sv = sk;
#pragma unroll
    for (int ww = 0; ww < kWarpsKv; ++ww) {
      const float2 a = *reinterpret_cast<const float2*>(
          part + 2 * ww * BKV * D + e);
      const float2 bb = *reinterpret_cast<const float2*>(
          part + (2 * ww + 1) * BKV * D + e);
      sk.x += a.x;
      sk.y += a.y;
      sv.x += bb.x;
      sv.y += bb.y;
    }
    const size_t off = khead + (size_t)(k0 + row) * KV * D + col;
    store2(dk + off, sk.x * scale, sk.y * scale);
    store2(dv + off, sv.x, sv.y);
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
    constexpr int smem = DqSmem<D>::BYTES;
    auto kern = flash_bwd_dq_tf32<T, D>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const int grid = (Sq + BQ - 1) / BQ * H * B;   // tile-major, 1-d
    kern<<<grid, THREADS, smem, stream>>>(
        qt, kt, vt, static_cast<const T*>(o), dot, lse, delta,
        static_cast<T*>(dq), Sq, Skv, H, KV, q_offset, causal, window, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (Skv > 0) {
    constexpr int smem = KvSmem<D>::BYTES;
    auto kern = flash_bwd_dkdv_tf32<T, D>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const int grid = (Skv + BKV - 1) / BKV * KV * B;
    kern<<<grid, THREADS_KV, smem, stream>>>(
        qt, kt, vt, dot, lse, delta, static_cast<T*>(dk),
        static_cast<T*>(dv), Sq, Skv, H, KV, q_offset, causal, window, scale);
    return cudaGetLastError();
  }
  return cudaSuccess;
}

}  // namespace tf

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
#define REPRO_FLASH_BWD_TF32_CASE(T, DD)                                    \
  return (int)tf::launch<T, DD>(q, k, v, o, dout, lse, delta, dq, dk, dv,   \
                                B, Sq, Skv, H, KV, q_offset, causal,        \
                                window, scale, s)
  if (dtype == 0 && D == 32) REPRO_FLASH_BWD_TF32_CASE(float, 32);
  if (dtype == 0 && D == 64) REPRO_FLASH_BWD_TF32_CASE(float, 64);
  if (dtype == 0 && D == 80) REPRO_FLASH_BWD_TF32_CASE(float, 80);
  if (dtype == 0 && D == 128) REPRO_FLASH_BWD_TF32_CASE(float, 128);
  // bf16 at D = 32 (only the smoke configs have it): the 3xTF32 pair,
  // widened to f32, by shape
  if (dtype == 1 && D == 32) REPRO_FLASH_BWD_TF32_CASE(__nv_bfloat16, 32);
#undef REPRO_FLASH_BWD_TF32_CASE
#define REPRO_FLASH_BWD_TC_CASE(DD)                                         \
  return (int)tc::launch<DD>(q, k, v, o, dout, lse, delta, dq, dk, dv, B,   \
                             Sq, Skv, H, KV, q_offset, causal, window,      \
                             scale, s)
  if (dtype == 1 && D == 64) REPRO_FLASH_BWD_TC_CASE(64);
  if (dtype == 1 && D == 80) REPRO_FLASH_BWD_TC_CASE(80);
  if (dtype == 1 && D == 128) REPRO_FLASH_BWD_TC_CASE(128);
#undef REPRO_FLASH_BWD_TC_CASE
  return (int)cudaErrorInvalidValue;
}
