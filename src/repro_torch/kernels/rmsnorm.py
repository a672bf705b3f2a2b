"""Fused RMSNorm, forward and backward: the CUDA kernels `csrc/rmsnorm.cu`
for CUDA tensors, the plain PyTorch version for CPU tensors.

Replaces the TPU kernel `repro.kernels.rmsnorm.rmsnorm_pallas`. The
reference has no Pallas backward (its training differentiates the jnp
norm); here the gradient is a kernel too, bound as a
`torch.autograd.Function` and taken only when an input requires grad.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# kernel launches since the last reset (CPU calls do not count): the
# forward, and the backward (one per call: its dx/dw-partials kernel and
# the small dw sum that follows it)
launches = 0
launches_bwd = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_D = 8192   # csrc MAX_D: 8 warps x 32 threads x 32 columns a row


def rmsnorm_plain(x, w, eps=1e-6):
    """The kernel's plain PyTorch version (`repro.models.layers.rmsnorm`):
    f32 mean of squares, rounded to x.dtype before the product with w."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def _lib():
    lib = _build.load("rmsnorm")
    if lib.rmsnorm_fwd.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.rmsnorm_fwd.argtypes = [vp, vp, vp, vp, ci, ci, ctypes.c_float,
                                    ci, ci, vp]
        lib.rmsnorm_fwd.restype = ci
        lib.rmsnorm_bwd.argtypes = [vp] * 7 + [ci] * 4 + [vp]
        lib.rmsnorm_bwd.restype = ci
    return lib


def _check(x, w):
    if x.dtype not in _DTYPES:
        raise ValueError(f"rmsnorm: dtype {x.dtype} not in "
                         "(float32, bfloat16)")
    d = x.shape[-1] if x.dim() else 0
    if w.dtype != x.dtype or w.device != x.device or tuple(w.shape) != (d,):
        raise ValueError(f"rmsnorm: w must be ({d},) {x.dtype} on "
                         f"{x.device}, got {tuple(w.shape)} {w.dtype} on "
                         f"{w.device}")
    if d == 0 or d % 8:
        raise ValueError(f"rmsnorm: last dim {d} is not a multiple of 8")
    if d > _MAX_D:
        raise ValueError(f"rmsnorm: last dim {d} is above {_MAX_D}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("rmsnorm: x and w must be contiguous")
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("rmsnorm: x and w must be 16-byte aligned")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _sms(t):
    """The card's SM count: the kernels' persistent blocks, one per SM."""
    return torch.cuda.get_device_properties(t.device).multi_processor_count


def _forward(x, w, eps, keep_rstd):
    """Launch the forward kernel: (y, rstd (rows,) f32 or None)."""
    global launches
    _check(x, w)
    d = x.shape[-1]
    rows = x.numel() // d
    y = torch.empty_like(x)
    rstd = (torch.empty(rows, dtype=torch.float32, device=x.device)
            if keep_rstd else None)
    if rows:
        err = _lib().rmsnorm_fwd(
            x.data_ptr(), w.data_ptr(), y.data_ptr(),
            None if rstd is None else rstd.data_ptr(), rows, d, float(eps),
            _sms(x), _DTYPES[x.dtype], _stream(x))
        if err != 0:
            raise RuntimeError(f"rmsnorm kernel launch failed: cudaError_t "
                               f"{err}")
        launches += 1
    return y, rstd


def rmsnorm_bwd(dy, x, w, rstd):
    """Launch the backward kernels: (dx in x.dtype, dw in w.dtype) for the
    output gradient `dy` of `rmsnorm(x, w)`, given the forward's per-row
    `rstd` (rows,) f32."""
    global launches_bwd
    _check(x, w)
    dy = dy.contiguous()
    if dy.data_ptr() % 16:   # the kernel's bulk copies read 16-byte units
        dy = dy.clone()
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"rmsnorm_bwd: dy {tuple(dy.shape)} {dy.dtype} "
                         f"does not match x {tuple(x.shape)} {x.dtype}")
    d = x.shape[-1]
    rows = x.numel() // d
    if rstd.shape != (rows,) or rstd.dtype != torch.float32:
        raise ValueError("rmsnorm_bwd: rstd must be (rows,) float32")
    dx = torch.empty_like(x)
    if rows == 0:
        return dx, torch.zeros_like(w)
    dw = torch.empty_like(w)
    blocks = min(rows, _sms(x))   # at most one dw partial per block
    part = torch.empty((blocks, d), dtype=torch.float32, device=x.device)
    err = _lib().rmsnorm_bwd(
        x.data_ptr(), w.data_ptr(), dy.data_ptr(), rstd.data_ptr(),
        dx.data_ptr(), dw.data_ptr(), part.data_ptr(), rows, d, blocks,
        _DTYPES[x.dtype], _stream(x))
    if err != 0:
        raise RuntimeError(f"rmsnorm backward kernel launch failed: "
                           f"cudaError_t {err}")
    launches_bwd += 1
    return dx, dw


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, eps):
        y, rstd = _forward(x, w, eps, keep_rstd=True)
        ctx.save_for_backward(x, w, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w, rstd = ctx.saved_tensors
        dx, dw = rmsnorm_bwd(dy, x, w, rstd)
        return dx, dw, None


def rmsnorm(x, w, eps=1e-6):
    """x: (..., d); w: (d,). Returns rmsnorm(x) * w in x.dtype.

    CPU tensors run the plain version. CUDA tensors launch the kernel,
    which takes bf16 or f32 (w in x's dtype), d a multiple of 8 up to
    8192 and contiguous inputs, and raises on anything else; when x or w
    requires grad (and grad mode is on) the backward kernel gives the
    gradient."""
    if x.device.type == "cpu":
        return rmsnorm_plain(x, w, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm: unsupported device {x.device}")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _RMSNorm.apply(x, w, eps)
    return _forward(x, w, eps, keep_rstd=False)[0]
