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
// Semantics follow `ref.flash_attention_reference`: scores are
// scale * (q . k) in f32 (q is never rounded after scaling), masked
// scores are -1e30 (not -inf), and the final normaliser is clamped at
// 1e-30. A row with no valid key at all comes out finite (0 when every
// tile is skipped); its value is not otherwise specified. With a
// non-null `lse` (f32, (B, H, Sq)) each row's log-sum-exp of its scaled,
// masked scores, m + log(max(l, 1e-30)), is written too: the backward
// kernels (flash_backward.cu) recompute P from it.
//
// Two kernels, picked by dtype and head dim:
//
// bf16 at D = 64 / 80 / 128 (the serve and train paths): warpgroup MMA
// fed by TMA. At serving and
// training shapes (256-1024 tokens, D = 64 / 80 / 128) the two products
// do about 2 * 128 operations per byte of q/k/v/out moved, close to the
// H100's ridge (~295), so the bound is the tensor cores' issue rate and
// keeping them fed; at D = 64 and 80 the softmax's exponentials (one per
// score, 16 per clock per SM) take about as long as the products. One
// block per (128-row q tile, head, batch), three warpgroups: a producer
// whose one thread issues TMA loads (out-of-bounds rows arrive as zeros)
// of the q tile once and of 128-key K/V tiles into a ring of 3
// (D = 128) or 4 (D = 64, 80) stages guarded by mbarrier full/empty
// pairs, and two consumer warpgroups of 64 query rows each that run
// S = Q K^T as wgmma m64n128k16 from shared memory (both K-major) and
// O += P V as wgmma m64n64k16 with P converted in registers from the S
// accumulator (its layout is wgmma's A fragment) and V read MN-major.
// `setmaxnreg` moves registers from the producer to the consumers. Each
// consumer issues tile j's QK^T together with tile j-1's PV and runs
// tile j's softmax while that PV is on the tensor cores; the two
// consumers also fill each other's gaps. Online-softmax state stays in
// registers, in the log2 domain (scale * log2(e) folded into one FMA
// before the SFU's ex2); only tiles that straddle the diagonal, kv_len
// or the window are masked, and key tiles outside every row's range
// are never loaded. The grid is tile-major and causal grids start at
// the last q tile, so the heaviest blocks of every head go first and
// the long tiles do not land in the last wave.
//
// A tile row is stored as 64-column blocks of 128-byte rows under TMA's
// 128-byte swizzle. D = 80 (zamba2's shared attention, 2560 / 32 heads;
// 160-byte rows) adds a 16-column tail block of 32-byte rows under the
// 32-byte swizzle, loaded by a second tensor map per operand (a box of
// 16 columns at column 64): QK^T runs 4 k16 steps on the first block and
// 1 on the tail (`sw32_desc`), and PV runs m64n64k16 on the first block
// and m64n16k16 on the tail, so the products are exactly those of D = 80.
// A stage is 2 x 128 x 80 x 2 = 40 KB; q (20 KB) and 4 stages take
// 185,416 bytes of shared memory. The other design, padding D to two
// 64-column blocks (TMA zero-fills columns 80-127), would cost D = 128's
// shared memory (3 stages) and 1.3x the products (PV at N = 128).
//
// f32 at every D (the examples' path: train_tiny, quickstart's training
// and the f32 engine runs of the smoke configs; the f32 teacher-forcing
// checks) and bf16 at D = 32 (the smoke configs): 3xTF32 on the tensor
// cores (`tf::flash_fwd_tf32`; hopper.cuh). The CUDA-core kernel it
// replaces kept a 4 x 4 register tile per thread fed by scalar loads
// from padded f32 tiles (two FMAs per shared load: bound by shared-memory
// reads, at 12 % of the f32 FMA bound at train_tiny's shape), loaded K/V
// synchronously between two barriers, and took expf. Here each f32
// product is three mma.sync m16n8k8 .tf32 passes on the TF32 pair (hi,
// lo) of its operands (~2^-22 relative a product, inside the f32 TOL) at a
// third of TF32's 495 TFLOP/s. One block of four warps per (64-row q
// tile, head, batch), each warp 16 query rows; K/V tiles of 64 keys (32
// at D = 128) in a two-stage cp.async ring, each split into its TF32 hi
// (in place) and lo (a second tile) once as it lands, which the card
// measured 15 % faster than splitting each use in registers (q and P
// are split in registers); f32 tiles XOR-swizzled by 16-byte chunk
// (`f32_off`) so that both fragment reads are free of bank conflicts;
// the k index of every product permuted so that S's accumulator is P's
// A fragment as it stands (no trip through shared memory); the online
// softmax in registers in the log2 domain (the wgmma kernel's
// `softmax_step`). A warp skips a tile its rows all mask, and its whole
// loop when its rows are past Sq (a decode call's one row). bf16 inputs
// (D = 32, narrower than the wgmma kernel's 64-column block) are widened
// to f32 as their tiles land; they are exact in TF32, so only P, which
// the kernel computes, takes the lo passes. That is a dispatch by dtype
// and shape, not a fallback: nothing retries another kernel when a
// launch fails.
#include <cuda.h>

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace repro_torch {
namespace {

// ------------------------------------------------- bf16: wgmma + TMA --

namespace tc {

constexpr int BQ = 128;       // query rows per block: two consumers x 64
constexpr int BK = 128;       // keys per tile
constexpr int THREADS = 384;  // producer + two consumer warpgroups
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

constexpr int kMaxSmem = 232448;   // a block's shared memory on sm_90

// Shared memory, from a 1024-byte aligned base: the q tile, then STAGES
// x (K tile, V tile), then the mbarriers. Every tile is stored as D / 64
// column blocks of [rows][64] bf16 (128-byte rows, TMA's 128-byte
// swizzle) and, where D % 64 == 16 (D = 80), one tail block of
// [rows][16] (32-byte rows, TMA's 32-byte swizzle); each block is
// 1024-byte aligned. The K/V ring is as deep as 227 KB allows, at most 4
// (3 stages at D = 128, 4 at D = 64 and 80, where a fifth fits but
// measured no faster on the card): a stage is held from its tile's QK^T
// until its PV, issued beside the next tile's QK^T, is done.
template <int D>
struct Smem {
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;    // one K or V tile
  static constexpr int FIT =
      (kMaxSmem - Q_BYTES - 1024 - 8 * 9) / (2 * KV_BYTES);
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  static constexpr int KV_OFF = Q_BYTES;
  static constexpr int BAR_OFF = KV_OFF + STAGES * 2 * KV_BYTES;
  // barriers: q, full[STAGES], empty[STAGES]; + slack to align the base
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;
  static_assert(STAGES >= 2 && BYTES <= kMaxSmem,
                "the q tile and a ring of two stages must fit");
};

// One online-softmax step of a consumer thread's two rows over a tile's
// raw scores `sc` (its part of the warpgroup's 64 x BK accumulator).
// EDGE tiles (straddling the diagonal, kv_len or the window) mask their
// scores to -1e30 first. Updates the running max m (log2 domain, the
// scale folded in) and the per-thread partial sums l, turns sc into P in
// place -- P = 0 where masked, so a row with no valid key yet adds
// nothing -- and returns each row's correction exp2(m_old - m_new) for O.
template <bool EDGE, int NS>
__device__ __forceinline__ void softmax_step(
    float (&sc)[NS], float (&m)[2], float (&l)[2], float (&corr)[2],
    int k0, int c, int qp0, int kvl, int causal, int window,
    float scale_log2) {
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int i = 0; i < NS / 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (EDGE) {
        const int kp = k0 + 8 * i + 2 * c + (j & 1);
        const int qp = qp0 + 8 * (j >> 1);
        const bool ok = kp < kvl && (!causal || qp >= kp) &&
                        (window <= 0 || kp > qp - window);
        if (!ok) sc[4 * i + j] = kNegInf;
      }
      mx[j >> 1] = fmaxf(mx[j >> 1], sc[4 * i + j]);
    }
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1)
      mx[hi] = fmaxf(mx[hi], __shfl_xor_sync(0xffffffffu, mx[hi], off));
    const float m_new = fmaxf(m[hi], mx[hi] * scale_log2);
    corr[hi] = ex2_approx(m[hi] - m_new);
    m[hi] = m_new;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < NS / 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float p = ex2_approx(fmaf(sc[4 * i + j], scale_log2, -m[j >> 1]));
      if (EDGE && sc[4 * i + j] == kNegInf) p = 0.f;
      sc[4 * i + j] = p;
      sum[j >> 1] += p;
    }
  l[0] = l[0] * corr[0] + sum[0];   // per-thread partials: reduced at the end
  l[1] = l[1] * corr[1] + sum[1];
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                const __grid_constant__ CUtensorMap tq16,
                const __grid_constant__ CUtensorMap tk16,
                const __grid_constant__ CUtensorMap tv16,
                __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                const int* __restrict__ kv_len,
                const int* __restrict__ q_offset, int q_offset_scalar,
                int Sq, int Skv, int H, int KV, int causal, int window,
                float scale_log2) {
  // 64-column blocks, and at D = 80 a 16-column tail block (tq16, tk16,
  // tv16 load it; unused otherwise)
  constexpr int HALVES = D / 64, TAIL = D % 64;
  static_assert(HALVES >= 1 && (TAIL == 0 || TAIL == 16),
                "tiles are 64-column blocks and at most one 16-column tail");
  using L = Smem<D>;
  constexpr int STAGES = L::STAGES;
  constexpr int BLOCK_Q = BQ * 128;   // bytes of one 64-column block
  constexpr int BLOCK_K = BK * 128;
  constexpr int TAIL_Q = HALVES * BLOCK_Q;   // offset of the tail block
  constexpr int TAIL_K = HALVES * BLOCK_K;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sKV = base + L::KV_OFF;
  const uint32_t bar_q = base + L::BAR_OFF;
  const uint32_t bar_full = bar_q + 8;                 // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * STAGES;    // + 8 * stage

  const TileOrder to = tile_order((Sq + BQ - 1) / BQ, H, causal);
  const int qt = to.tile, h = to.head, b = to.batch;
  const int kvh = h / (H / KV);
  const int q0 = qt * BQ;
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
  const int n_tiles = max(0, kt_end - kt_begin);

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 8);   // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread keeps the TMA loads in flight
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, L::Q_BYTES);
#pragma unroll
      for (int hf = 0; hf < HALVES; ++hf)
        tma_load_4d(sQ + hf * BLOCK_Q, &tq, bar_q, hf * 64, h, q0, b);
      if constexpr (TAIL > 0)
        tma_load_4d(sQ + TAIL_Q, &tq16, bar_q, HALVES * 64, h, q0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % STAGES;
        if (it >= STAGES)   // consumers released this stage's last use
          mbar_wait(bar_empty + 8 * s, (it / STAGES - 1) & 1);
        const uint32_t full = bar_full + 8 * s;
        const uint32_t sk = sKV + s * 2 * L::KV_BYTES;
        const int k0 = (kt_begin + it) * BK;
        mbar_expect_tx(full, 2 * L::KV_BYTES);
#pragma unroll
        for (int hf = 0; hf < HALVES; ++hf) {
          tma_load_4d(sk + hf * BLOCK_K, &tk, full, hf * 64, kvh, k0, b);
          tma_load_4d(sk + L::KV_BYTES + hf * BLOCK_K, &tv, full, hf * 64,
                      kvh, k0, b);
        }
        if constexpr (TAIL > 0) {
          tma_load_4d(sk + TAIL_K, &tk16, full, HALVES * 64, kvh, k0, b);
          tma_load_4d(sk + L::KV_BYTES + TAIL_K, &tv16, full, HALVES * 64,
                      kvh, k0, b);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows each. Tile j's QK^T is issued
    // together with tile j-1's PV, and tile j's softmax runs while that
    // PV is still on the tensor cores.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cw = wg - 1;
    const int t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32;
    const int g = lane / 4, c = lane % 4;
    // this thread's two rows (accumulator elements 0,1 and 2,3 of every
    // 8-column chunk): local rows r and r + 8
    const int r = cw * 64 + warp * 16 + g;
    const int qp0 = qoff + q0 + r;
    const int wq_first = qoff + q0 + cw * 64, wq_last = wq_first + 63;
    const uint32_t qa = sQ + cw * 64 * 128;    // this warpgroup's rows
    const uint32_t qa16 = sQ + TAIL_Q + cw * 64 * 32;   // and their tail

    float o[HALVES][32];
    float o16[TAIL > 0 ? TAIL / 2 : 1];   // the tail's 64 x 16 columns
#pragma unroll
    for (int hf = 0; hf < HALVES; ++hf)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[hf][i] = 0.f;
#pragma unroll
    for (int i = 0; i < TAIL / 2; ++i) o16[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    float corr[2] = {1.f, 1.f};   // rescales O before the next PV
    float sc[BK / 2];            // S, then P, of the newest tile
    uint32_t pa[BK / 16][4];     // P of the previous tile, bf16 A fragments

    // S = Q K^T (64 x BK, f32) into sc, from stage `s`
    auto issue_s = [&](int s) {
      const uint32_t sk = sKV + s * 2 * L::KV_BYTES;
      reg_fence(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4 * HALVES; ++kk) {
        const int hf = kk / 4, kin = (kk % 4) * 32;
        wgmma_ss_m64n128k16(sc, sw128_desc(qa + hf * BLOCK_Q + kin, 16),
                            sw128_desc(sk + hf * BLOCK_K + kin, 16), kk > 0);
      }
      if constexpr (TAIL > 0)   // the tail block is one k16 step
        wgmma_ss_m64n128k16(sc, sw32_desc(qa16, 16),
                            sw32_desc(sk + TAIL_K, 16), 1);
      wgmma_commit();
    };
    auto softmax = [&](int tile) {
      const int k0 = (kt_begin + tile) * BK;
      const bool edge = k0 + BK > kvl || (causal && k0 + BK - 1 > wq_first) ||
                        (window > 0 && k0 <= wq_last - window);
      if (edge)
        softmax_step<true>(sc, m, l, corr, k0, c, qp0, kvl, causal, window,
                           scale_log2);
      else
        softmax_step<false>(sc, m, l, corr, k0, c, qp0, kvl, causal, window,
                            scale_log2);
    };
    // P (in sc) as bf16 A fragments: the accumulator's k16 chunk kk is
    // elements 8kk .. 8kk+7, in A-fragment order
    auto pack_p = [&]() {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          pa[kk][j] = pack_bf16(sc[8 * kk + 2 * j], sc[8 * kk + 2 * j + 1]);
    };

    // O = O * corr + P V for the tile in stage `s`; V MN-major, a k16
    // step is 16 key rows (2048 bytes of a 64-column block, 512 of the
    // tail block, whose N = 16 is one m64n16k16)
    auto issue_pv = [&](int s) {
      const uint32_t sv = sKV + s * 2 * L::KV_BYTES + L::KV_BYTES;
#pragma unroll
      for (int hf = 0; hf < HALVES; ++hf) {
#pragma unroll
        for (int i = 0; i < 32; ++i) o[hf][i] *= corr[(i >> 1) & 1];
        reg_fence(o[hf]);
      }
      if constexpr (TAIL > 0) {
#pragma unroll
        for (int i = 0; i < TAIL / 2; ++i) o16[i] *= corr[(i >> 1) & 1];
        reg_fence(o16);
      }
      reg_fence(pa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
        for (int hf = 0; hf < HALVES; ++hf)
          wgmma_rs_m64n64k16_tb(
              o[hf], pa[kk],
              sw128_desc(sv + hf * BLOCK_K + kk * 2048, BLOCK_K));
        if constexpr (TAIL > 0)
          wgmma_rs_m64n16k16_tb(o16, pa[kk],
                                sw32_desc(sv + TAIL_K + kk * 512, BK * 32));
      }
      wgmma_commit();
    };
    auto retire_pv = [&]() {
      wgmma_wait<0>();
#pragma unroll
      for (int hf = 0; hf < HALVES; ++hf) reg_fence(o[hf]);
      if constexpr (TAIL > 0) reg_fence(o16);
      reg_fence(pa);
    };

    mbar_wait(bar_q, 0);
    if (n_tiles > 0) {
      mbar_wait(bar_full, 0);
      issue_s(0);
      wgmma_wait<0>();
      reg_fence(sc);
      softmax(0);
      pack_p();
      for (int it = 1; it < n_tiles; ++it) {
        const int s = it % STAGES, sp = (it - 1) % STAGES;
        mbar_wait(bar_full + 8 * s, (it / STAGES) & 1);
        issue_s(s);
        issue_pv(sp);
        wgmma_wait<1>();   // this tile's S is done; the PV may still run
        reg_fence(sc);
        softmax(it);
        retire_pv();
        __syncwarp();
        if (lane == 0) mbar_arrive(bar_empty + 8 * sp);
        pack_p();
      }
      issue_pv((n_tiles - 1) % STAGES);
      retire_pv();
    }

    // epilogue: finish the row sums across the quad, normalise, store
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1)
        l[hi] += __shfl_xor_sync(0xffffffffu, l[hi], off);
      const int row = r + 8 * hi;
      if (row >= q_rows) continue;
      const float inv = 1.f / fmaxf(l[hi], 1e-30f);
      if (lse && c == 0)
        lse[((size_t)b * H + h) * Sq + q0 + row] =
            (m[hi] == kNegInf ? kNegInf : m[hi] * kLn2) +
            logf(fmaxf(l[hi], 1e-30f));
      __nv_bfloat16* orow = out + (((size_t)b * Sq + q0 + row) * H + h) * D;
#pragma unroll
      for (int hf = 0; hf < HALVES; ++hf)
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int e = 4 * i + 2 * hi;
          *reinterpret_cast<uint32_t*>(orow + hf * 64 + 8 * i + 2 * c) =
              pack_bf16(o[hf][e] * inv, o[hf][e + 1] * inv);
        }
#pragma unroll
      for (int i = 0; i < TAIL / 8; ++i) {
        const int e = 4 * i + 2 * hi;
        *reinterpret_cast<uint32_t*>(orow + HALVES * 64 + 8 * i + 2 * c) =
            pack_bf16(o16[e] * inv, o16[e + 1] * inv);
      }
    }
  }
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (no -lcuda)
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &res);
#endif
    if (err == cudaSuccess && res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// Tensor map of a contiguous (B, S, NH, D) bf16 tensor, boxes of `rows`
// rows x `cols` columns of one head: 64 columns under the 128-byte
// swizzle, or a 16-column tail under the 32-byte swizzle.
bool make_map(EncodeTiledFn enc, CUtensorMap* map, const void* ptr, int B,
              int S, int NH, int D, int rows, int cols = 64) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)NH,
                              (cuuint64_t)max(S, 1), (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)NH * D * 2,
                                 (cuuint64_t)S * NH * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)cols, 1, (cuuint32_t)rows, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
             const_cast<void*>(ptr), dims, strides, box, estr,
             CU_TENSOR_MAP_INTERLEAVE_NONE,
             cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                        : CU_TENSOR_MAP_SWIZZLE_32B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, const int* kv_len, const int* q_offset,
                   int q_offset_scalar, int B, int Sq, int Skv, int H,
                   int KV, int causal, int window, float scale,
                   cudaStream_t stream) {
  EncodeTiledFn enc = encode_tiled();
  if (!enc) return cudaErrorNotSupported;
  CUtensorMap mq, mk, mv, mq16 = {}, mk16 = {}, mv16 = {};
  if (!make_map(enc, &mq, q, B, Sq, H, D, BQ) ||
      !make_map(enc, &mk, k, B, Skv, KV, D, BK) ||
      !make_map(enc, &mv, v, B, Skv, KV, D, BK))
    return cudaErrorInvalidValue;
  if (D % 64 != 0 &&
      (!make_map(enc, &mq16, q, B, Sq, H, D, BQ, 16) ||
       !make_map(enc, &mk16, k, B, Skv, KV, D, BK, 16) ||
       !make_map(enc, &mv16, v, B, Skv, KV, D, BK, 16)))
    return cudaErrorInvalidValue;
  constexpr int smem = Smem<D>::BYTES;
  auto kern = flash_fwd_wgmma<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int grid = (Sq + BQ - 1) / BQ * H * B;   // tile-major, 1-d
  kern<<<grid, THREADS, smem, stream>>>(
      mq, mk, mv, mq16, mk16, mv16, static_cast<__nv_bfloat16*>(out), lse,
      kv_len, q_offset,
      q_offset_scalar, Sq, Skv, H, KV, causal, window, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace tc

// ------------------------------------ f32 and bf16 at D = 32: 3xTF32 --

namespace tf {

constexpr int BQ = 64;        // query rows per block: four warps x 16
constexpr int THREADS = 128;

// keys per tile below D = 128, from `tools/flash_ab.py f32 --sweep` on
// the card at D 64
constexpr int kBkF = 64;

// keys per tile: kBkF, or 32 at D = 128, where two stages of 64 f32 keys
// would leave room for one block an SM
template <int D>
constexpr int block_k() { return D == 128 ? 32 : kBkF; }

// Shared memory (floats): the q tile, two stages of (K tile, V tile),
// then the lo of the current K and V tiles (f32: K and V are split into
// TF32 pairs once per tile as they land); every tile f32 at
// f32_pitch<D>() a row (hopper.cuh).
template <int D>
struct Smem {
  static constexpr int BK = block_k<D>();
  static constexpr int TQ = BQ * f32_pitch<D>();
  static constexpr int TK = BK * f32_pitch<D>();
  static constexpr int LO = TQ + 4 * TK;
  static constexpr int BYTES = 4 * (LO + 2 * TK);
};

// T = float, or bf16 (D = 32: its values are exact in TF32, so only P,
// which the kernel computes, takes the lo passes)
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_tf32(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ out,
               float* __restrict__ lse, const int* __restrict__ kv_len,
               const int* __restrict__ q_offset, int q_offset_scalar, int Sq,
               int Skv, int H, int KV, int causal, int window,
               float scale_log2) {
  constexpr bool EXACT = !std::is_same<T, float>::value;
  using L = Smem<D>;
  constexpr int BK = L::BK;
  extern __shared__ __align__(16) float fsmem[];
  float* sQ = fsmem;
  float* sKV = fsmem + L::TQ;   // stage s: K at 2 s TK, V at 2 s TK + TK
  float* sLo = fsmem + L::LO;   // f32: K lo, then V lo

  const TileOrder to = tile_order((Sq + BQ - 1) / BQ, H, causal);
  const int qt = to.tile, h = to.head, b = to.batch;
  const int kvh = h / (H / KV);
  const int q0 = qt * BQ;
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
  const int n_tiles = max(0, kt_end - kt_begin);

  const T* qb = q + ((size_t)b * Sq * H + h) * D;        // row stride H*D
  const T* kb = k + ((size_t)b * Skv * KV + kvh) * D;    // row stride KV*D
  const T* vb = v + ((size_t)b * Skv * KV + kvh) * D;
  auto load_kv = [&](int it, int st) {
    const int k0 = (kt_begin + it) * BK;
    load_tile_f32<D, BK, THREADS>(sKV + 2 * st * L::TK, kb, k0, Skv, KV * D);
    load_tile_f32<D, BK, THREADS>(sKV + (2 * st + 1) * L::TK, vb, k0, Skv,
                                  KV * D);
  };
  load_tile_f32<D, BQ, THREADS>(sQ, qb, q0, Sq, H * D);
  if (n_tiles > 0) load_kv(0, 0);
  cp_async_commit();

  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const int r = w * 16 + g;            // this thread's rows r, r + 8
  const int qp0 = qoff + q0 + r;
  const int wq_first = qoff + q0 + w * 16, wq_last = wq_first + 15;
  // a warp whose rows are all past Sq (a decode call's one row leaves
  // three of four idle) only loads
  const bool live = w * 16 < q_rows;

  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) o[i][j] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1;
    if (it + 1 < n_tiles) load_kv(it + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    float* sK = sKV + 2 * st * L::TK;
    const float* sV = sK + L::TK;
    if constexpr (!EXACT) {   // K and V (adjacent) to hi and lo, once
      split_tile<THREADS>(sK, sLo, 2 * L::TK);
      __syncthreads();
    }
    const int k0 = (kt_begin + it) * BK;
    // a tile whose keys this warp's rows all mask adds nothing
    const bool skip = !live || (causal && k0 > wq_last) ||
                      (window > 0 && k0 + BK - 1 <= wq_first - window);
    if (!skip) {
      // S = Q K^T, this warp's 16 rows x BK keys (n8 tile i: s[4i ..])
      float s[BK / 2];
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        FragA qa;
        ld_a<D, EXACT>(qa, sQ, w * 16, kk * 8, lane);
#pragma unroll
        for (int nn = 0; nn < BK / 8; ++nn) {
          FragB kf;
          if constexpr (EXACT)
            ld_b_nk<D, true>(kf, sK, nn * 8, kk * 8, lane);
          else
            ld_b_nk<D>(kf, sK, sLo, nn * 8, kk * 8, lane);
          mma3<EXACT, EXACT>(&s[4 * nn], qa, kf);
        }
      }
      // the wgmma kernel's online softmax: its accumulator rows and
      // columns are laid out as mma.sync's
      float corr[2];
      const bool edge = k0 + BK > kvl || (causal && k0 + BK - 1 > wq_first) ||
                        (window > 0 && k0 <= wq_last - window);
      if (edge)
        tc::softmax_step<true>(s, m, l, corr, k0, c, qp0, kvl, causal,
                               window, scale_log2);
      else
        tc::softmax_step<false>(s, m, l, corr, k0, c, qp0, kvl, causal,
                                window, scale_log2);
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) o[i][j] *= corr[j >> 1];
      // O += P V: P's n8 tile kc is the A fragment of k8 step kc
#pragma unroll
      for (int kc = 0; kc < BK / 8; ++kc) {
        FragA pa;
        acc_a(pa, &s[4 * kc]);
#pragma unroll
        for (int dn = 0; dn < D / 8; ++dn) {
          FragB vf;
          if constexpr (EXACT)
            ld_b_kn<D, true>(vf, sV, kc * 8, dn * 8, lane);
          else
            ld_b_kn<D>(vf, sV, sLo + L::TK, kc * 8, dn * 8, lane);
          mma3<false, EXACT>(o[dn], pa, vf);
        }
      }
    }
    __syncthreads();   // the next prefetch overwrites this stage
  }
  cp_async_wait<0>();

  // epilogue: finish the row sums across the quad, normalise, store
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1)
      l[hi] += __shfl_xor_sync(0xffffffffu, l[hi], off);
    const int row = r + 8 * hi;
    if (row >= q_rows) continue;
    const float inv = 1.f / fmaxf(l[hi], 1e-30f);
    if (lse && c == 0)
      lse[((size_t)b * H + h) * Sq + q0 + row] =
          (m[hi] == kNegInf ? kNegInf : m[hi] * tc::kLn2) +
          logf(fmaxf(l[hi], 1e-30f));
    T* orow = out + (((size_t)b * Sq + q0 + row) * H + h) * D;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      store2(orow + 8 * i + 2 * c, o[i][2 * hi] * inv,
             o[i][2 * hi + 1] * inv);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, const int* kv_len, const int* q_offset,
                   int q_offset_scalar, int B, int Sq, int Skv, int H,
                   int KV, int causal, int window, float scale,
                   cudaStream_t stream) {
  constexpr int smem = Smem<D>::BYTES;
  auto kern = flash_fwd_tf32<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int grid = (Sq + BQ - 1) / BQ * H * B;   // tile-major, 1-d
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, kv_len, q_offset,
      q_offset_scalar, Sq, Skv, H, KV, causal, window, scale * tc::kLog2e);
  return cudaGetLastError();
}

}  // namespace tf

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
#define REPRO_FLASH_TF32_CASE(T, DD)                                        \
  return (int)tf::launch<T, DD>(q, k, v, out, lse, kv_len, q_offset,        \
                                q_offset_scalar, B, Sq, Skv, H, KV, causal, \
                                window, scale, s)
  if (dtype == 0 && D == 32) REPRO_FLASH_TF32_CASE(float, 32);
  if (dtype == 0 && D == 64) REPRO_FLASH_TF32_CASE(float, 64);
  if (dtype == 0 && D == 80) REPRO_FLASH_TF32_CASE(float, 80);
  if (dtype == 0 && D == 128) REPRO_FLASH_TF32_CASE(float, 128);
  // bf16 at D = 32 is narrower than the wgmma kernel's first 64-column
  // block: it takes the 3xTF32 kernel, widened to f32 (by shape)
  if (dtype == 1 && D == 32) REPRO_FLASH_TF32_CASE(__nv_bfloat16, 32);
#undef REPRO_FLASH_TF32_CASE
#define REPRO_FLASH_TC_CASE(DD)                                             \
  return (int)tc::launch<DD>(q, k, v, out, lse, kv_len, q_offset,           \
                             q_offset_scalar, B, Sq, Skv, H, KV, causal,    \
                             window, scale, s)
  // D = 80 (zamba2's shared attention): one 64-column block and a
  // 16-column tail block
  if (dtype == 1 && D == 64) REPRO_FLASH_TC_CASE(64);
  if (dtype == 1 && D == 80) REPRO_FLASH_TC_CASE(80);
  if (dtype == 1 && D == 128) REPRO_FLASH_TC_CASE(128);
#undef REPRO_FLASH_TC_CASE
  return (int)cudaErrorInvalidValue;
}
