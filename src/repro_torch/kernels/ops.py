"""Attention entry points the model and the executor call — the port of
`repro.kernels.ops`, with the same signatures minus `backend=`.

The backend follows the tensors: CPU tensors run the plain PyTorch
versions (`ref.py`), CUDA tensors launch the hand-written kernels or
raise. There is no fallback from one to the other. Dense-cache
`decode_attention` waits for the dense `Model.decode` port (its plain
version is `ref.decode_attention_reference`).
"""
from __future__ import annotations

from repro_torch.kernels import flash_prefill as _fp
from repro_torch.kernels import paged_attention as _pa


def flash_attention(q, k, v, *, causal=True, window=0, kv_len=None,
                    q_offset=0, q_chunk=512, kv_chunk=512,
                    softmax_scale=None):
    return _fp.flash_attention(
        q, k, v, causal=causal, window=window, kv_len=kv_len,
        q_offset=q_offset, softmax_scale=softmax_scale, q_chunk=q_chunk,
        kv_chunk=kv_chunk)


def paged_attention(q, kv_pool, block_table, kv_len, *, softmax_scale=None):
    return _pa.paged_attention(q, kv_pool, block_table, kv_len,
                               softmax_scale=softmax_scale)
