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
// writer (no atomics; the result is deterministic):
//   dq    one block per (q tile, head, batch): loops over the key tiles
//         the tile can see; also writes Delta (B,H,Sq) f32.
//   dkdv  one block per (key tile of 64, KV head, batch): loops over the
//         G query heads of its group and the q tiles that can see the
//         key tile, so GQA needs no atomics.
//
// bf16 (the train path): every product on the tensor cores, as
// mma.sync m16n8k16 (bf16 in, f32 accumulate). The backward needs five
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
// shared memory, XOR-swizzled by 16-byte chunk so ldmatrix is
// conflict-free, and double-buffered with cp.async (K/V in dq, q/dout
// and their lse / Delta rows in dkdv). Both grids are 1-d and
// tile-major, heaviest tiles first under a causal mask (the last q
// tiles for dq, the first key tiles for dkdv), so the long blocks do not
// land in the last wave; at D = 64 the register caps leave room for 4
// (dq) and 3 (dkdv) blocks per SM. P is recomputed as exp2(s * scale
// * log2e - lse * log2e); P and dS are rounded to bf16 as the A operands
// of dV, dK and dq, and every sum is f32. That P is not bit-identical to
// the one the forward normalised (the forward's S comes from wgmma, in
// another order); the card checks hold dq, dk and dv to autograd through
// the plain f32 version within atol = 2e-2 * max|grad|, rtol = 2e-2.
//
// f32 (the exact reference path of the card checks; no main path runs
// it), and bf16 at D = 32 (the smoke configs): the CUDA-core kernels,
// 64 x 64 tiles, f32 FMAs throughout, bound by FMA issue and
// shared-memory reads. The mma.sync kernels' swizzle XORs a row's
// 16-byte chunk index with row % 8, so a row needs at least 8 chunks
// (D % 64 == 0); a bf16 tensor with D = 32 always takes the CUDA-core
// pair. That is a dispatch by shape, not a fallback: nothing retries
// another kernel when a launch fails.
#include "common.cuh"
#include "hopper.cuh"

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


// ------------------------------------------------ bf16: mma.sync m16n8k16 --

namespace tc {

constexpr int BQ = 64;        // dq kernel: query rows per block
constexpr int BK = 64;        // keys per tile (both kernels)
constexpr int THREADS = 128;  // four warps, 16 rows each
constexpr float kLog2e = 1.4426950408889634f;

// dkdv kernel: query rows per tile (fewer at D = 128, where the dk / dv
// accumulators take twice the registers)
template <int D>
constexpr int dkdv_bq() { return D == 64 ? 64 : 32; }

// Blocks per SM the register allocation must leave room for. At D = 64
// more resident warps hide ldmatrix / mma latency better (measured on
// the card: dq at 4 blocks and dkdv at 3 beat the unconstrained
// allocation); at D = 128 the cap would spill the accumulators.
template <int D>
constexpr int min_blocks_dq() { return D == 64 ? 4 : 1; }
template <int D>
constexpr int min_blocks_dkdv() { return D == 64 ? 3 : 1; }

template <int D>
struct DqSmem {
  static constexpr int TQ = BQ * D * 2, TK = BK * D * 2;
  static constexpr int Q = 0, DO = TQ, KV = 2 * TQ;   // KV: 2 x (K, V)
  static constexpr int BYTES = KV + 4 * TK;
};

template <int D>
struct KvSmem {
  static constexpr int BQ2 = dkdv_bq<D>();
  static constexpr int TQ = BQ2 * D * 2, TK = BK * D * 2;
  static constexpr int K = 0, V = TK, ST = 2 * TK;
  // one stage: q tile, dout tile, lse[BQ2], delta[BQ2]
  static constexpr int STAGE = 2 * TQ + 2 * BQ2 * 4;
  static constexpr int BYTES = ST + 2 * STAGE;
};

// cp.async rows [row0, row0 + ROWS) of one head (rows `stride` elements
// apart) into a swizzled bf16 tile; rows >= valid are zero-filled.
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
  static_assert(D % 64 == 0, "swz<D> needs 8 chunks per row");
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
  static_assert(D % 64 == 0, "swz<D> needs 8 chunks per row");
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
  if (dtype == 0 && D == 32) REPRO_FLASH_BWD_CASE(float, 32);
  if (dtype == 0 && D == 64) REPRO_FLASH_BWD_CASE(float, 64);
  if (dtype == 0 && D == 128) REPRO_FLASH_BWD_CASE(float, 128);
  // bf16 at D = 32: the CUDA-core pair, by shape (swz<D> needs D % 64 == 0)
  if (dtype == 1 && D == 32) REPRO_FLASH_BWD_CASE(__nv_bfloat16, 32);
#undef REPRO_FLASH_BWD_CASE
#define REPRO_FLASH_BWD_TC_CASE(DD)                                         \
  return (int)tc::launch<DD>(q, k, v, o, dout, lse, delta, dq, dk, dv, B,   \
                             Sq, Skv, H, KV, q_offset, causal, window,      \
                             scale, s)
  if (dtype == 1 && D == 64) REPRO_FLASH_BWD_TC_CASE(64);
  if (dtype == 1 && D == 128) REPRO_FLASH_BWD_TC_CASE(128);
#undef REPRO_FLASH_BWD_TC_CASE
  return (int)cudaErrorInvalidValue;
}
