"""Segmented paged chunk-prefill attention, one pool or two: the CUDA
kernels `csrc/paged_prefill.cu` for CUDA tensors, their plain PyTorch
versions for CPU tensors.

Replaces the TPU kernel `repro.kernels.paged_prefill.paged_prefill_pallas`
in both its forms: every prefill-chunk row of the fused mixed step attends
straight over the paged pool, and a segment whose layer lives in the host
tier (layer-wise offload mid-prefill) reads the pinned HOST pool. Where
the Pallas kernel fetched host blocks by DMA inside its grid, the card's
copy engine first stages a host segment's live blocks into a device
buffer (`stage_host_runs`: runs of blocks listed on the host, one batched
call; each host byte crosses PCIe once), and the body reads slot
s * MAXB + j of that buffer in place of the device pool. The serving
executor stages each host-tier layer one layer ahead on a side stream
(`staging_stream`) and calls the body on the staged buffer (`staged=`).
The `host_pool=` form is the plain version's, for CPU tensors. The body is one
of two kernels, picked by dtype and head dim (`body_route`): bf16 at
D = 64 and 128 runs the tensor-core kernel (mma.sync), f32 at every D and
bf16 at D = 32 the CUDA-core one.
"""
from __future__ import annotations

import ctypes
import time

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_prefill import _DTYPES, _HEAD_DIMS, _check
from repro_torch.kernels.paged_attention import MAX_GROUP
from repro_torch.kernels.ref import paged_prefill_reference

# since the last reset (CPU calls do not count): body launches of the
# single-pool form and of the two-pool form (`tier` with `staged`);
# staging calls (`stage_host_runs`, one copy-engine batch each) and the
# runs they handed over. stage_host_s: the host seconds of staging, the
# listing of runs (`host_block_runs`, on any device) and their issue
launches = 0
launches_tiered = 0
launches_stage = 0
stage_runs = 0
stage_host_s = 0.0
# the same calls' body launches by route: the tensor-core kernel
# (`tc::paged_prefill_mma`) or the CUDA-core one (`paged_prefill_kernel`);
# launches_mma + launches_fma == launches + launches_tiered
launches_mma = 0
launches_fma = 0

# the kernel's plain PyTorch version, run for CPU tensors and held
# against the kernel on the card
paged_prefill_plain = paged_prefill_reference


def live_host_slots(block_table, kv_len, tier, block_size):
    """(S, MAXB) bool: the staging slots s * MAXB + j a two-pool call
    copies, tier[s] != 0 and j < ceil(min(kv_len[s], MAXB * BS) / BS)."""
    S, MAXB = block_table.shape
    dev = block_table.device
    n = (kv_len.long().to(dev).clamp(max=MAXB * block_size)
         + block_size - 1) // block_size
    j = torch.arange(MAXB, device=dev)
    return tier.to(dev).bool()[:, None] & (j[None] < n[:, None])


def stage_host_blocks_plain(host_pool, block_table, kv_len, tier):
    """The staging's plain version: (S * MAXB, BS, 2, KV, D) on
    block_table's device whose slot s * MAXB + j holds host block
    clamp(table[s, j], 0, NBH - 1) for every live host slot
    (`live_host_slots`), zeros elsewhere."""
    S, MAXB = block_table.shape
    NBH, BS = host_pool.shape[:2]
    dev = block_table.device
    out = torch.zeros((S * MAXB, *host_pool.shape[1:]),
                      dtype=host_pool.dtype, device=dev)
    idx = live_host_slots(block_table, kv_len, tier, BS).reshape(-1) \
        .nonzero()[:, 0]
    hid = block_table.reshape(-1).long()[idx].clamp(0, NBH - 1)
    out[idx] = host_pool[hid.to(host_pool.device)].to(dev)
    return out


def host_block_runs(block_table, kv_len, tier, block_size, nb_host):
    """The live host slots (`live_host_slots`) as copy runs: an (R, 3)
    int64 numpy array of rows (host block, staging slot, n blocks), each
    run consecutive in both the host pool and the staging buffer, in slot
    order. Host ids are clamped into [0, nb_host - 1], as the plain
    staging does. Takes numpy arrays or CPU tensors; its host time adds
    to `stage_host_s`."""
    global stage_host_s
    t0 = time.perf_counter()
    runs = _runs(block_table, kv_len, tier, block_size, nb_host)
    stage_host_s += time.perf_counter() - t0
    return runs


def _runs(block_table, kv_len, tier, block_size, nb_host):
    tab = np.asarray(block_table, np.int64)
    S, MAXB = tab.shape
    n = (np.minimum(np.asarray(kv_len, np.int64), MAXB * block_size)
         + block_size - 1) // block_size
    live = np.asarray(tier).astype(bool)[:, None] \
        & (np.arange(MAXB)[None] < n[:, None])
    slots = np.flatnonzero(live)
    if not slots.size:
        return np.zeros((0, 3), np.int64)
    src = np.clip(tab.reshape(-1)[slots], 0, nb_host - 1)
    cut = np.flatnonzero((np.diff(src) != 1) | (np.diff(slots) != 1)) + 1
    first = np.concatenate([[0], cut])
    n_blk = np.diff(np.concatenate([first, [slots.size]]))
    return np.stack([src[first], slots[first], n_blk], axis=1) \
        .astype(np.int64)


def stage_host_runs_plain(host_pool, runs, out):
    """The copy engine's plain version: out[dst:dst + n] =
    host_pool[src:src + n] for every row (src, dst, n) of `runs`."""
    for src, dst, n in np.asarray(runs).tolist():
        out[dst:dst + n] = host_pool[src:src + n].to(out.device)
    return out


def _stage_fn():
    lib = _build.load("paged_prefill")
    f = lib.stage_host_runs_fwd
    if f.argtypes is None:
        vp = ctypes.c_void_p
        f.argtypes = [vp, vp, vp, ctypes.c_int, ctypes.c_longlong, vp]
        f.restype = ctypes.c_int
    return f


_streams = {}


def staging_stream(device):
    """The side stream host staging runs on: one per CUDA device, made at
    first use (the copy engine's batch call refuses the legacy default
    stream)."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    st = _streams.get(device)
    if st is None:
        st = _streams[device] = torch.cuda.Stream(device)
    return st


def _check_host(host_pool, dtype, block_shape):
    """Raise unless host_pool is pinned, contiguous, 16-byte aligned CPU
    memory of `dtype` with blocks of `block_shape`."""
    if host_pool.device.type != "cpu" or not host_pool.is_pinned():
        raise ValueError("host_pool must be pinned CPU memory")
    if host_pool.dtype != dtype or not host_pool.is_contiguous() \
            or tuple(host_pool.shape[1:]) != tuple(block_shape):
        raise ValueError(f"host_pool {tuple(host_pool.shape)} "
                         f"{host_pool.dtype} does not fit {dtype} blocks of "
                         f"{tuple(block_shape)}")
    if host_pool.data_ptr() % 16:
        raise ValueError("host_pool must be 16-byte aligned")


def stage_host_runs(host_pool, runs, out):
    """Copy runs of host-pool blocks into the staging buffer `out`:
    out[dst:dst + n] = host_pool[src:src + n] for every row (src, dst, n)
    of `runs` ((R, 3) int64, `host_block_runs`). A CPU `out` runs the
    plain version. A CUDA `out` (contiguous, of host_pool's dtype and
    block shape; host_pool pinned) goes to the copy engine in one call on
    the current stream, which must not be the legacy default stream (run
    it under `torch.cuda.stream(staging_stream(device))`); raises on
    anything else, a run out of range included. Returns `out`."""
    global launches_stage, stage_runs, stage_host_s
    if out.device.type == "cpu":
        return stage_host_runs_plain(host_pool, runs, out)
    if out.device.type != "cuda":
        raise ValueError(f"stage_host_runs: unsupported device {out.device}")
    t0 = time.perf_counter()
    _check_host(host_pool, out.dtype, out.shape[1:])
    if out.dim() != 5 or not out.is_contiguous():
        raise ValueError("stage_host_runs: out must be a contiguous "
                         "(n, BS, 2, KV, D) buffer")
    runs = np.ascontiguousarray(runs, dtype=np.int64)
    if runs.ndim != 2 or runs.shape[1] != 3:
        raise ValueError(f"runs must be (R, 3), not {runs.shape}")
    src, dst, n = runs.T
    if ((n < 1) | (src < 0) | (dst < 0) | (src + n > host_pool.shape[0])
            | (dst + n > out.shape[0])).any():
        raise ValueError("stage_host_runs: a run lies outside host_pool "
                         "or out")
    stream = torch.cuda.current_stream(out.device).cuda_stream
    if stream == 0:
        raise ValueError("stage_host_runs: the copy engine's batch call "
                         "refuses the legacy default stream; run under "
                         "torch.cuda.stream(staging_stream(device))")
    err = _stage_fn()(host_pool.data_ptr(), out.data_ptr(),
                      runs.ctypes.data, runs.shape[0],
                      out[0].numel() * out.element_size(), stream)
    if err != 0:
        raise RuntimeError(f"stage_host_runs: cudaMemcpyBatchAsync failed: "
                           f"cudaError_t {err}")
    launches_stage += 1
    stage_runs += runs.shape[0]
    stage_host_s += time.perf_counter() - t0
    return out


def _fn():
    lib = _build.load("paged_prefill")
    f = lib.paged_prefill_fwd
    if f.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        f.argtypes = [vp] * 9 + [ci] * 9 + [ctypes.c_float, ci, vp]
        f.restype = ci
    return f


def body_route(dtype, head_dim) -> str:
    """The body kernel a CUDA call launches for q of `dtype` and
    `head_dim`, as the kernel library dispatches it: "mma" (tensor cores)
    or "fma" (CUDA cores)."""
    f = _build.load("paged_prefill").paged_prefill_route
    if f.argtypes is None:
        f.argtypes, f.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    return "mma" if f(head_dim, _DTYPES[dtype]) else "fma"


def _staged_table(block_table, tier):
    """block_table with each host segment's row pointed at its staging
    slots s * MAXB + j: the blocks the body reads for it."""
    S, MAXB = block_table.shape
    slots = torch.arange(S * MAXB, dtype=block_table.dtype,
                         device=block_table.device).reshape(S, MAXB)
    return torch.where(tier.to(block_table.device).bool()[:, None], slots,
                       block_table)


def paged_prefill(q, kv_pool, block_table, seg_ids, q_pos, kv_len, *,
                  host_pool=None, tier=None, staged=None, tq=8,
                  softmax_scale=None):
    """q: (T, H, D) flat batch of tq-padded segments, T % tq == 0, the
    positions inside a tile contiguous; kv_pool: (NB, BS, 2, KV, D);
    block_table: (S, MAXB) int32; seg_ids / q_pos: (T,) int32; kv_len:
    (S,) int32. With `tier` (S,) set, a segment whose flag is set reads
    the host tier: `host_pool` (NBH, BS, 2, KV, D), or, given `staged` in
    its place, a staging buffer whose slot s * MAXB + j already holds its
    live block j (`stage_host_runs`). Returns (T, H, D) in q.dtype. The
    chunk's own K/V must already be in the pool (or in its staged slots).

    CPU tensors run the plain version (`staged` as its host pool, the
    host segments' rows pointed at their slots: `_staged_table`). CUDA
    tensors launch the body kernel (on the route `body_route` names),
    which takes bf16 or f32, D in {32, 64, 128}, H / KV <= 16 and
    contiguous inputs, and reads the host tier only from `staged` (stage
    first with `host_block_runs` and `stage_host_runs`, as the executor
    does); raises on anything else, `host_pool` included."""
    global launches, launches_tiered, launches_mma, launches_fma
    if tier is None and (host_pool is not None or staged is not None):
        raise ValueError("paged_prefill: host_pool and staged go together "
                         "with tier")
    if tier is not None and (host_pool is None) == (staged is None):
        raise ValueError("paged_prefill: tier and one of host_pool and "
                         "staged go together")
    if q.device.type == "cpu":
        if staged is not None:
            host_pool, block_table = staged, _staged_table(block_table, tier)
        return paged_prefill_plain(
            q, kv_pool, block_table, seg_ids, q_pos, kv_len,
            host_pool=host_pool, tier=tier, tq=tq,
            softmax_scale=softmax_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_prefill: unsupported device {q.device}")
    if host_pool is not None:
        raise ValueError("paged_prefill: on CUDA the host tier is read "
                         "from a staging buffer: stage its runs with "
                         "stage_host_runs and pass staged=")
    if q.dtype not in _DTYPES:
        raise ValueError(f"paged_prefill: dtype {q.dtype} not in "
                         "(float32, bfloat16)")
    dev = q.device
    _check("q", q, q.dtype, dev, 3)
    _check("kv_pool", kv_pool, q.dtype, dev, 5)
    _check("block_table", block_table, torch.int32, dev, 2)
    _check("seg_ids", seg_ids, torch.int32, dev, 1)
    _check("q_pos", q_pos, torch.int32, dev, 1)
    _check("kv_len", kv_len, torch.int32, dev, 1)
    T, H, D = q.shape
    NB, BS, two, KV, Dp = kv_pool.shape
    S, MAXB = block_table.shape
    if two != 2 or Dp != D:
        raise ValueError(f"kv_pool shape {tuple(kv_pool.shape)} does not "
                         f"fit q {tuple(q.shape)}")
    if seg_ids.shape != (T,) or q_pos.shape != (T,) or kv_len.shape != (S,):
        raise ValueError("seg_ids / q_pos must be (T,) and kv_len (S,)")
    if tq <= 0 or T % tq:
        raise ValueError(f"paged_prefill: T={T} is not a multiple of "
                         f"tq={tq}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"paged_prefill: head dim {D} not in {_HEAD_DIMS}")
    if KV == 0 or H % KV or H // KV > MAX_GROUP:
        raise ValueError(f"paged_prefill: H={H}, KV={KV} needs "
                         f"H % KV == 0 and H / KV <= {MAX_GROUP}")
    tp = None
    if tier is not None:
        if tier.device != dev or tier.shape != (S,):
            raise ValueError(f"tier must be ({S},) on {dev}")
        tp = tier.to(torch.int32).contiguous()
        _check("staged", staged, q.dtype, dev, 5)
        if staged.shape[0] < S * MAXB or staged.shape[1:] != \
                kv_pool.shape[1:]:
            raise ValueError(f"staged {tuple(staged.shape)} must hold "
                             f"{S} x {MAXB} blocks of kv_pool's shape")
    if any(t.data_ptr() % 16 for t in (q, kv_pool)
           + (() if staged is None else (staged,))):
        raise ValueError("paged_prefill: inputs must be 16-byte aligned")
    scale = softmax_scale if softmax_scale is not None else D ** -0.5
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _fn()(q.data_ptr(), kv_pool.data_ptr(),
                None if staged is None else staged.data_ptr(),
                block_table.data_ptr(), seg_ids.data_ptr(), q_pos.data_ptr(),
                kv_len.data_ptr(), None if tp is None else tp.data_ptr(),
                out.data_ptr(), T, H, KV, D, BS, S, MAXB, tq, NB,
                float(scale), _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"paged_prefill kernel launch failed: "
                           f"cudaError_t {err}")
    if tier is not None:
        launches_tiered += 1
    else:
        launches += 1
    if body_route(q.dtype, D) == "mma":
        launches_mma += 1
    else:
        launches_fma += 1
    return out
