"""Flash-attention prefill (causal / sliding-window GQA): the CUDA kernel
`csrc/flash_prefill.cu` for CUDA tensors, its plain PyTorch version for
CPU tensors.

Replaces the TPU kernel `repro.kernels.flash_prefill.flash_attention_pallas`
and closes its gap: `kv_len` (B,) and `q_offset` (an int or a (B,)
tensor) are runtime inputs, so the engine's whole-prompt prefill
(kv_len = prompt_len) and the two-call chunk path (runtime q_offset) both
run on the kernel.

Its gradient is the kernel pair `csrc/flash_backward.cu` (the reference
has no Pallas backward; its training differentiates the jnp oracle):
when an input requires grad, `flash_attention` runs as an autograd
Function whose forward also keeps each row's log-sum-exp, and whose
backward recomputes P from it. Training passes neither `kv_len` nor a
tensor `q_offset`; with grad on, the kernel path raises for them.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (decode_attention_reference,
                                     flash_attention_reference)

# kernel launches since the last reset (CPU calls do not count): the
# forward, and the backward (one per call: its dq kernel and the dk/dv
# kernel that follows it); `launches_decode` counts the forwards that
# `decode_attention` made (they count in `launches` too)
launches = 0
launches_bwd = 0
launches_decode = 0
# the counters above, by name: a replayed CUDA graph adds what its capture
# counted (`serving.executor._StepGraph`)
COUNTERS = ("launches", "launches_bwd", "launches_decode")

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# head dims with a case in both flash sources: 80 is zamba2's shared
# attention (bf16 takes the tensor-core kernels there, as at 64 and 128:
# the forward with a 16-column tail block, the backward on padded tiles)
_HEAD_DIMS = (32, 64, 80, 128)


# the kernel's plain PyTorch version, run for CPU tensors and held
# against the kernel on the card
flash_attention_plain = flash_attention_reference
decode_attention_plain = decode_attention_reference


def _fn():
    lib = _build.load("flash_prefill")
    f = lib.flash_attention_fwd
    if f.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        f.argtypes = [vp] * 7 + [ci] * 9 + [ctypes.c_float, ci, vp]
        f.restype = ci
    return f


def _bwd_fn():
    lib = _build.load("flash_backward")
    f = lib.flash_attention_bwd
    if f.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        f.argtypes = [vp] * 10 + [ci] * 9 + [ctypes.c_float, ci, vp]
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
    are its chunk sizes; autograd differentiates it); CUDA tensors launch
    the kernel, which takes bf16 or f32, D in {32, 64, 80, 128}, and
    contiguous inputs, and raises on anything else. When q, k or v
    requires grad (and grad mode is on) the backward kernels give the
    gradient."""
    if q.device.type == "cpu":
        return flash_attention_plain(
            q, k, v, causal=causal, window=window, kv_len=kv_len,
            q_offset=q_offset, softmax_scale=softmax_scale,
            q_chunk=q_chunk, kv_chunk=kv_chunk)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    scale = softmax_scale if softmax_scale is not None \
        else q.shape[-1] ** -0.5
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        if kv_len is not None or isinstance(q_offset, torch.Tensor):
            raise ValueError("flash_attention: the backward kernel takes "
                             "no kv_len and only an int q_offset")
        return _Flash.apply(q, k, v, bool(causal), int(window),
                            int(q_offset), float(scale))
    return _launch_fwd(q, k, v, causal, window, kv_len, q_offset, scale,
                       keep_lse=False)[0]


def decode_attention(q, k_cache, v_cache, kv_len, *, softmax_scale=None):
    """One query row per sequence over a dense cache: q (B, 1, H, D),
    k_cache / v_cache (B, S, KV, D), kv_len (B,) valid entries. CPU
    tensors run the plain version (`ref.decode_attention_reference`);
    CUDA tensors launch the forward kernel, non-causal with the runtime
    kv_len, which computes exactly that function (the reference has no
    Pallas kernel for it). One query row fills one row of the kernel's
    128-row tile; the epilogue stores only that row."""
    global launches_decode
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, kv_len,
                                      softmax_scale=softmax_scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    if q.shape[1] != 1:
        raise ValueError(f"decode_attention: q must be (B, 1, H, D), got "
                         f"{tuple(q.shape)}")
    scale = softmax_scale if softmax_scale is not None \
        else q.shape[-1] ** -0.5
    out = _launch_fwd(q, k_cache, v_cache, False, 0, kv_len, 0, scale,
                      keep_lse=False)[0]
    launches_decode += 1
    return out


def _check_qkv(q, k, v):
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


def _launch_fwd(q, k, v, causal, window, kv_len, q_offset, scale, keep_lse):
    """Launch the forward kernel: (out, lse (B, H, Sq) f32 or None)."""
    global launches
    _check_qkv(q, k, v)
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    lens = _lens("kv_len", kv_len, B, q.device)
    if isinstance(q_offset, torch.Tensor):
        offs, off_scalar = _lens("q_offset", q_offset, B, q.device), 0
    else:
        offs, off_scalar = None, int(q_offset)
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if keep_lse else None)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                None if lse is None else lse.data_ptr(),
                None if lens is None else lens.data_ptr(),
                None if offs is None else offs.data_ptr(), off_scalar,
                B, Sq, Skv, H, KV, D, int(bool(causal)), int(window),
                float(scale), _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError_t {err}")
    launches += 1
    return out, lse


def flash_attention_bwd(q, k, v, out, dout, lse, *, causal=True, window=0,
                        q_offset=0, softmax_scale=None):
    """Launch the backward kernels: (dq, dk, dv) in q.dtype for the output
    gradient `dout` of `out = flash_attention(q, k, v, causal=causal,
    window=window, q_offset=q_offset)` (every key valid), given the
    forward's per-row log-sum-exp `lse` (B, H, Sq) f32."""
    global launches_bwd
    _check_qkv(q, k, v)
    dout = dout.contiguous()
    for name, t in (("out", out), ("dout", dout)):
        _check(name, t, q.dtype, q.device, 4)
        if t.shape != q.shape or t.data_ptr() % 16:
            raise ValueError(f"flash_attention_bwd: {name} must be "
                             f"{tuple(q.shape)}, 16-byte aligned")
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    if lse.shape != (B, H, Sq) or lse.dtype != torch.float32 \
            or not lse.is_contiguous():
        raise ValueError(f"flash_attention_bwd: lse must be contiguous "
                         f"({B}, {H}, {Sq}) float32")
    scale = softmax_scale if softmax_scale is not None else D ** -0.5
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    delta = torch.empty_like(lse)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _bwd_fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                    dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, Sq, Skv,
                    H, KV, D, int(q_offset), int(bool(causal)), int(window),
                    float(scale), _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention backward kernel launch failed: "
                           f"cudaError_t {err}")
    launches_bwd += 1
    return dq, dk, dv


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, scale):
        out, lse = _launch_fwd(q, k, v, causal, window, None, q_offset,
                               scale, keep_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = dict(causal=causal, window=window, q_offset=q_offset,
                        softmax_scale=scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout, lse, **ctx.args)
        return dq, dk, dv, None, None, None, None
