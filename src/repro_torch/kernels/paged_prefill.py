"""Segmented paged chunk-prefill attention, one pool or two: the CUDA
kernels `csrc/paged_prefill.cu` for CUDA tensors, their plain PyTorch
versions for CPU tensors.

Replaces the TPU kernel `repro.kernels.paged_prefill.paged_prefill_pallas`
in both its forms: every prefill-chunk row of the fused mixed step attends
straight over the paged pool, and a segment whose layer lives in the host
tier (layer-wise offload mid-prefill) reads the pinned HOST pool. On the
card a two-pool call first stages the host segments' live blocks into a
device buffer (each host byte crosses PCIe once), then runs the one-pool
body, which reads them there. The body is one of two kernels, picked by
dtype and head dim (`body_route`): bf16 at D = 64 and 128 runs the
tensor-core kernel (mma.sync), f32 at every D and bf16 at D = 32 the
CUDA-core one.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_prefill import _DTYPES, _HEAD_DIMS, _check
from repro_torch.kernels.paged_attention import MAX_GROUP
from repro_torch.kernels.ref import paged_prefill_reference

# kernel launches since the last reset (CPU calls do not count): the
# single-pool variant, the two-pool variant (`host_pool` + `tier`), and the
# staging kernel (once per two-pool call, or per `stage_host_blocks`)
launches = 0
launches_tiered = 0
launches_stage = 0
# the same calls' body launches by route: the tensor-core kernel
# (`tc::paged_prefill_mma`) or the CUDA-core one (`paged_prefill_kernel`);
# launches_mma + launches_fma == launches + launches_tiered
launches_mma = 0
launches_fma = 0
# the largest staging buffer a two-pool call allocated since the last
# reset, in bytes (transient, one layer at a time; not KV capacity)
staging_bytes_peak = 0

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
    """The staging kernel's plain version: (S * MAXB, BS, 2, KV, D) on
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


def _fn():
    lib = _build.load("paged_prefill")
    f = lib.paged_prefill_fwd
    if f.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        f.argtypes = [vp] * 10 + [ci] * 10 + [ctypes.c_float, ci, vp]
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


def _stage_fn():
    lib = _build.load("paged_prefill")
    f = lib.stage_host_blocks_fwd
    if f.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        f.argtypes = [vp] * 5 + [ci] * 4 + [ctypes.c_longlong, vp]
        f.restype = ci
    return f


def _check_host(host_pool, tier, dtype, block_shape, S, dev):
    """Raise unless host_pool is pinned, contiguous CPU memory of `dtype`
    with blocks of `block_shape`, and tier is (S,) on `dev`. Returns tier
    as contiguous int32."""
    if host_pool.device.type != "cpu" or not host_pool.is_pinned():
        raise ValueError("paged_prefill: host_pool must be pinned CPU "
                         "memory")
    if host_pool.dtype != dtype or not host_pool.is_contiguous() \
            or host_pool.shape[1:] != block_shape:
        raise ValueError(f"host_pool {tuple(host_pool.shape)} "
                         f"{host_pool.dtype} does not fit kv_pool")
    if host_pool.data_ptr() % 16:
        raise ValueError("paged_prefill: host_pool must be 16-byte aligned")
    if tier.device != dev or tier.shape != (S,):
        raise ValueError(f"tier must be ({S},) on {dev}")
    return tier.to(torch.int32).contiguous()


def stage_host_blocks(host_pool, block_table, kv_len, tier, out=None):
    """Copy the live host blocks of every host-tier segment into a device
    staging buffer: (S * MAXB, BS, 2, KV, D), slot s * MAXB + j =
    host_pool[clamp(table[s, j], 0, NBH - 1)] where
    `live_host_slots` holds. CPU tensors (block_table on the CPU) run the
    plain version, which zeroes the other slots; CUDA tensors launch the
    staging kernel (the first half of a two-pool `paged_prefill` call)
    into `out` if given (a buffer of that shape on the device) or a new
    one, leaving the other slots untouched, and raise on anything it does
    not take."""
    global launches_stage
    if block_table.device.type == "cpu":
        return stage_host_blocks_plain(host_pool, block_table, kv_len, tier)
    if block_table.device.type != "cuda":
        raise ValueError(f"stage_host_blocks: unsupported device "
                         f"{block_table.device}")
    dev = block_table.device
    _check("block_table", block_table, torch.int32, dev, 2)
    _check("kv_len", kv_len, torch.int32, dev, 1)
    S, MAXB = block_table.shape
    tp = _check_host(host_pool, tier, host_pool.dtype, host_pool.shape[1:],
                     S, dev)
    if kv_len.shape != (S,):
        raise ValueError(f"kv_len must be ({S},)")
    shape = (S * MAXB, *host_pool.shape[1:])
    if out is None:
        staged = torch.empty(shape, dtype=host_pool.dtype, device=dev)
    else:
        _check("out", out, host_pool.dtype, dev, 5)
        if tuple(out.shape) != shape:
            raise ValueError(f"out must be {shape}")
        staged = out
    block_bytes = staged[0].numel() * staged.element_size() if S * MAXB \
        else 0
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _stage_fn()(host_pool.data_ptr(), block_table.data_ptr(),
                      kv_len.data_ptr(), tp.data_ptr(), staged.data_ptr(),
                      S, MAXB, host_pool.shape[1], host_pool.shape[0],
                      block_bytes, stream)
    if err != 0:
        raise RuntimeError(f"stage_host_blocks kernel launch failed: "
                           f"cudaError_t {err}")
    launches_stage += 1
    return staged


def paged_prefill(q, kv_pool, block_table, seg_ids, q_pos, kv_len, *,
                  host_pool=None, tier=None, tq=8, softmax_scale=None):
    """q: (T, H, D) flat batch of tq-padded segments, T % tq == 0, the
    positions inside a tile contiguous; kv_pool: (NB, BS, 2, KV, D);
    block_table: (S, MAXB) int32; seg_ids / q_pos: (T,) int32; kv_len:
    (S,) int32. With `tier` (S,) set, a segment whose flag is set reads
    `host_pool` (NBH, BS, 2, KV, D) instead of `kv_pool`. Returns
    (T, H, D) in q.dtype. The chunk's own K/V must already be in the
    pool.

    CPU tensors run the plain version. CUDA tensors launch the kernel
    (its body on the route `body_route` names), which takes bf16 or f32, D
    in {32, 64, 128}, H / KV <= 16 and contiguous inputs, with `host_pool`
    in pinned CPU memory; a two-pool call first launches the staging
    kernel (`stage_host_blocks`) into a transient device buffer of S * MAXB
    blocks, which the body reads in place of the host pool. Raises on
    anything else."""
    global launches, launches_tiered, launches_stage, staging_bytes_peak
    global launches_mma, launches_fma
    if q.device.type == "cpu":
        return paged_prefill_plain(
            q, kv_pool, block_table, seg_ids, q_pos, kv_len,
            host_pool=host_pool, tier=tier, tq=tq,
            softmax_scale=softmax_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_prefill: unsupported device {q.device}")
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
    tiered = tier is not None
    if tiered != (host_pool is not None):
        raise ValueError("paged_prefill: host_pool and tier go together")
    nb_host, hp, tp, staged = 0, None, None, None
    if tiered:
        tp = _check_host(host_pool, tier, q.dtype, kv_pool.shape[1:], S, dev)
        nb_host = host_pool.shape[0]
        hp = host_pool.data_ptr()
        # transient, sized from the shapes (tier stays on the device)
        staged = torch.empty((S * MAXB, *kv_pool.shape[1:]), dtype=q.dtype,
                             device=dev)
    if any(t.data_ptr() % 16 for t in (q, kv_pool)):
        raise ValueError("paged_prefill: inputs must be 16-byte aligned")
    scale = softmax_scale if softmax_scale is not None else D ** -0.5
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _fn()(q.data_ptr(), kv_pool.data_ptr(), hp,
                None if staged is None else staged.data_ptr(),
                block_table.data_ptr(), seg_ids.data_ptr(), q_pos.data_ptr(),
                kv_len.data_ptr(), None if tp is None else tp.data_ptr(),
                out.data_ptr(), T, H, KV, D, BS, S, MAXB, tq, NB, nb_host,
                float(scale), _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"paged_prefill kernel launch failed: "
                           f"cudaError_t {err}")
    if tiered:
        launches_tiered += 1
        launches_stage += 1
        staging_bytes_peak = max(staging_bytes_peak,
                                 staged.numel() * staged.element_size())
    else:
        launches += 1
    if body_route(q.dtype, D) == "mma":
        launches_mma += 1
    else:
        launches_fma += 1
    return out
