"""Segmented paged chunk-prefill attention, one pool or two: the CUDA
kernel `csrc/paged_prefill.cu` for CUDA tensors, its plain PyTorch version
for CPU tensors.

Replaces the TPU kernel `repro.kernels.paged_prefill.paged_prefill_pallas`
in both its forms: every prefill-chunk row of the fused mixed step attends
straight over the paged pool, and a segment whose layer lives in the host
tier (layer-wise offload mid-prefill) reads the pinned HOST pool.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_prefill import _DTYPES, _HEAD_DIMS, _check
from repro_torch.kernels.paged_attention import MAX_GROUP
from repro_torch.kernels.ref import paged_prefill_reference

# kernel launches since the last reset (CPU calls do not count): the
# single-pool variant, and the two-pool variant (`host_pool` + `tier`)
launches = 0
launches_tiered = 0

# the kernel's plain PyTorch version, run for CPU tensors and held
# against the kernel on the card
paged_prefill_plain = paged_prefill_reference


def _fn():
    lib = _build.load("paged_prefill")
    f = lib.paged_prefill_fwd
    if f.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        f.argtypes = [vp] * 9 + [ci] * 10 + [ctypes.c_float, ci, vp]
        f.restype = ci
    return f


def paged_prefill(q, kv_pool, block_table, seg_ids, q_pos, kv_len, *,
                  host_pool=None, tier=None, tq=8, softmax_scale=None):
    """q: (T, H, D) flat batch of tq-padded segments, T % tq == 0, the
    positions inside a tile contiguous; kv_pool: (NB, BS, 2, KV, D);
    block_table: (S, MAXB) int32; seg_ids / q_pos: (T,) int32; kv_len:
    (S,) int32. With `tier` (S,) set, a segment whose flag is set reads
    `host_pool` (NBH, BS, 2, KV, D) instead of `kv_pool`. Returns
    (T, H, D) in q.dtype. The chunk's own K/V must already be in the
    pool.

    CPU tensors run the plain version. CUDA tensors launch the kernel,
    which takes bf16 or f32, D in {32, 64, 128}, H / KV <= 16 and contiguous
    inputs, with `host_pool` in pinned CPU memory (read in place through
    its device-mapped address, never copied), and raises on anything
    else."""
    global launches, launches_tiered
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
    nb_host, hp, tp = 0, None, None
    if tiered:
        if host_pool.device.type != "cpu" or not host_pool.is_pinned():
            raise ValueError("paged_prefill: host_pool must be pinned CPU "
                             "memory")
        if host_pool.dtype != q.dtype or not host_pool.is_contiguous() \
                or host_pool.shape[1:] != kv_pool.shape[1:]:
            raise ValueError(f"host_pool {tuple(host_pool.shape)} "
                             f"{host_pool.dtype} does not fit kv_pool")
        if tier.device != dev or tier.shape != (S,):
            raise ValueError(f"tier must be ({S},) on {dev}")
        nb_host = host_pool.shape[0]
        hp = host_pool.data_ptr()
        tp = tier.to(torch.int32).contiguous()
    if any(t.data_ptr() % 16 for t in (q, kv_pool)) or (hp or 0) % 16:
        raise ValueError("paged_prefill: inputs must be 16-byte aligned")
    scale = softmax_scale if softmax_scale is not None else D ** -0.5
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _fn()(q.data_ptr(), kv_pool.data_ptr(), hp,
                block_table.data_ptr(), seg_ids.data_ptr(), q_pos.data_ptr(),
                kv_len.data_ptr(), None if tp is None else tp.data_ptr(),
                out.data_ptr(), T, H, KV, D, BS, S, MAXB, tq, NB, nb_host,
                float(scale), _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"paged_prefill kernel launch failed: "
                           f"cudaError_t {err}")
    if tiered:
        launches_tiered += 1
    else:
        launches += 1
    return out
