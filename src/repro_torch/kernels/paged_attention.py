"""Paged GQA decode attention: the CUDA kernel `csrc/paged_attention.cu`
for CUDA tensors, its plain PyTorch version for CPU tensors.

Replaces the TPU kernel
`repro.kernels.paged_attention.paged_attention_pallas`: one query token
per sequence attends over KV kept in a single pooled tensor of blocks
(paper §4), addressed through a block table.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_prefill import _DTYPES, _HEAD_DIMS, _check
from repro_torch.kernels.ref import paged_attention_reference

# kernel launches since the last reset (CPU calls do not count)
launches = 0

MAX_GROUP = 16  # query heads per KV head the kernel holds (csrc MAX_G)


# the kernel's plain PyTorch version, run for CPU tensors and held
# against the kernel on the card
paged_attention_plain = paged_attention_reference


def _fn():
    lib = _build.load("paged_attention")
    f = lib.paged_attention_fwd
    if f.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        f.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci,
                      ctypes.c_float, ci, vp]
        f.restype = ci
    return f


def paged_attention(q, kv_pool, block_table, kv_len, *, softmax_scale=None):
    """q: (B, H, D); kv_pool: (NB, BS, 2, KV, D); block_table: (B, MAXB)
    int32; kv_len: (B,) int32. Returns (B, H, D) in q.dtype. Every table
    entry below ceil(kv_len / BS) must be a block id < NB (the caller's
    contract; the kernel does not read the rest). CPU tensors run the
    plain version; CUDA tensors launch the kernel, which takes bf16 or
    f32, D in {32, 64, 128}, H / KV <= 16 and contiguous inputs, and raises on
    anything else."""
    global launches
    if q.device.type == "cpu":
        return paged_attention_plain(q, kv_pool, block_table, kv_len,
                                     softmax_scale=softmax_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"paged_attention: dtype {q.dtype} not in "
                         "(float32, bfloat16)")
    _check("q", q, q.dtype, q.device, 3)
    _check("kv_pool", kv_pool, q.dtype, q.device, 5)
    _check("block_table", block_table, torch.int32, q.device, 2)
    _check("kv_len", kv_len, torch.int32, q.device, 1)
    B, H, D = q.shape
    NB, BS, two, KV, Dp = kv_pool.shape
    MAXB = block_table.shape[1]
    if two != 2 or Dp != D:
        raise ValueError(f"kv_pool shape {tuple(kv_pool.shape)} does not "
                         f"fit q {tuple(q.shape)}")
    if block_table.shape[0] != B or kv_len.shape != (B,):
        raise ValueError("block_table / kv_len batch does not match q")
    if D not in _HEAD_DIMS:
        raise ValueError(f"paged_attention: head dim {D} not in {_HEAD_DIMS}")
    if KV == 0 or H % KV or H // KV > MAX_GROUP:
        raise ValueError(f"paged_attention: H={H}, KV={KV} needs "
                         f"H % KV == 0 and H / KV <= {MAX_GROUP}")
    if any(t.data_ptr() % 16 for t in (q, kv_pool)):
        raise ValueError("paged_attention: inputs must be 16-byte aligned")
    scale = softmax_scale if softmax_scale is not None else D ** -0.5
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _fn()(q.data_ptr(), kv_pool.data_ptr(), block_table.data_ptr(),
                kv_len.data_ptr(), out.data_ptr(), B, H, KV, D, BS, MAXB,
                float(scale), _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: "
                           f"cudaError_t {err}")
    launches += 1
    return out
