"""Kernel entry points the model and the executor call — the port of
`repro.kernels.ops` (attention, with the same signatures minus
`backend=`) plus the fused RMSNorm that `models.layers.rmsnorm` runs.

The backend follows the tensors: CPU tensors run the plain PyTorch
versions (`ref.py`), CUDA tensors launch the hand-written kernels or
raise. There is no fallback from one to the other. Dense-cache
`decode_attention` has no Pallas kernel in the reference; on CUDA it
runs the flash forward kernel (one query row, non-causal, runtime
kv_len), on the CPU `ref.decode_attention_reference`.
"""
from __future__ import annotations

from repro_torch.kernels import flash_prefill as _fp
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import paged_prefill as _pp
from repro_torch.kernels import rmsnorm as _rn


def flash_attention(q, k, v, *, causal=True, window=0, kv_len=None,
                    q_offset=0, q_chunk=512, kv_chunk=512,
                    softmax_scale=None):
    return _fp.flash_attention(
        q, k, v, causal=causal, window=window, kv_len=kv_len,
        q_offset=q_offset, softmax_scale=softmax_scale, q_chunk=q_chunk,
        kv_chunk=kv_chunk)


def decode_attention(q, k_cache, v_cache, kv_len, *, window=0,
                     softmax_scale=None):
    """Single-token GQA attention over a dense cache: q (B, 1, H, D),
    caches (B, S, KV, D), kv_len (B,). With a ring buffer every cached
    slot is within the window already, so `window` changes nothing (as
    in the reference)."""
    del window
    return _fp.decode_attention(q, k_cache, v_cache, kv_len,
                                softmax_scale=softmax_scale)


def paged_attention(q, kv_pool, block_table, kv_len, *, softmax_scale=None):
    return _pa.paged_attention(q, kv_pool, block_table, kv_len,
                               softmax_scale=softmax_scale)


def paged_prefill(q, kv_pool, block_table, seg_ids, q_pos, kv_len, *,
                  host_pool=None, tier=None, staged=None, tq=8,
                  softmax_scale=None):
    """Segmented prefill/decode attention straight over the paged pool(s).

    q: (T, H, D) flat token batch — per-request segments each padded to a
    multiple of `tq` (so a query tile never straddles segments); the
    chunk's own KV must already be written into the pool. block_table:
    (S, MAXB); seg_ids/q_pos: (T,); kv_len: (S,). With `tier` (S,), a
    segment whose flag is set reads `host_pool`, or its blocks already
    staged at slots s * MAXB + j of `staged`. Returns (T, H, D)."""
    return _pp.paged_prefill(q, kv_pool, block_table, seg_ids, q_pos,
                             kv_len, host_pool=host_pool, tier=tier,
                             staged=staged, tq=tq,
                             softmax_scale=softmax_scale)


def rmsnorm(x, w, eps=1e-6):
    """x: (..., d); w: (d,). `x * rsqrt(mean(x^2) + eps)` in f32, rounded
    to x.dtype, times w; differentiable (a backward kernel on CUDA)."""
    return _rn.rmsnorm(x, w, eps)
