"""Flash-attention prefill (causal / sliding-window GQA): the CUDA kernel
`csrc/flash_prefill.cu` for CUDA tensors, its plain PyTorch version for
CPU tensors.

Replaces the TPU kernel `repro.kernels.flash_prefill.flash_attention_pallas`
and closes its gap: `kv_len` (B,) and `q_offset` (an int or a (B,)
tensor) are runtime inputs, so the engine's whole-prompt prefill
(kv_len = prompt_len) and the two-call chunk path (runtime q_offset) both
run on the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention_reference

# kernel launches since the last reset (CPU calls do not count)
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)


# the kernel's plain PyTorch version, run for CPU tensors and held
# against the kernel on the card
flash_attention_plain = flash_attention_reference


def _fn():
    lib = _build.load("flash_prefill")
    f = lib.flash_attention_fwd
    if f.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        f.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci,
                      ci, ctypes.c_float, ci, vp]
        f.restype = ci
    return f


def _check(name, t, dtype, device, ndim):
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _lens(name, x, B, device):
    """(B,) int32 device tensor (or None) for a runtime length argument."""
    if x is None:
        return None
    t = torch.as_tensor(x, device=device)
    if t.numel() == 1:
        t = t.reshape(1).expand(B)
    if t.shape != (B,):
        raise ValueError(f"{name} must be an int or shape ({B},), "
                         f"got {tuple(t.shape)}")
    return t.to(torch.int32).contiguous()


def flash_attention(q, k, v, *, causal=True, window=0, kv_len=None,
                    q_offset=0, softmax_scale=None, q_chunk=512,
                    kv_chunk=512):
    """q: (B, Sq, H, D); k, v: (B, Skv, KV, D); H % KV == 0.
    kv_len: None or (B,) valid KV prefix per sequence; q_offset: absolute
    position of q[:, 0] (int or (B,) tensor). Returns (B, Sq, H, D) in
    q.dtype. CPU tensors run the plain version (`q_chunk` / `kv_chunk`
    are its chunk sizes); CUDA tensors launch the kernel, which takes
    bf16 or f32, D in {64, 128}, and contiguous inputs, and raises on
    anything else."""
    global launches
    if q.device.type == "cpu":
        return flash_attention_plain(
            q, k, v, causal=causal, window=window, kv_len=kv_len,
            q_offset=q_offset, softmax_scale=softmax_scale,
            q_chunk=q_chunk, kv_chunk=kv_chunk)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention: dtype {q.dtype} not in "
                         "(float32, bfloat16)")
    _check("q", q, q.dtype, q.device, 4)
    _check("k", k, q.dtype, q.device, 4)
    _check("v", v, q.dtype, q.device, 4)
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    if k.shape != (B, Skv, KV, D) or v.shape != k.shape:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do "
                         f"not fit q {tuple(q.shape)}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not in {_HEAD_DIMS}")
    if KV == 0 or H % KV:
        raise ValueError(f"flash_attention: H={H} not a multiple of KV={KV}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: inputs must be 16-byte aligned")
    lens = _lens("kv_len", kv_len, B, q.device)
    if isinstance(q_offset, torch.Tensor):
        offs, off_scalar = _lens("q_offset", q_offset, B, q.device), 0
    else:
        offs, off_scalar = None, int(q_offset)
    scale = softmax_scale if softmax_scale is not None else D ** -0.5
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                None if lens is None else lens.data_ptr(),
                None if offs is None else offs.data_ptr(), off_scalar,
                B, Sq, Skv, H, KV, D, int(bool(causal)), int(window),
                float(scale), _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError_t {err}")
    launches += 1
    return out
