"""PyTorch/CUDA port of the LayerKV serving stack (`repro`), for one
NVIDIA H100.

The JAX-free decision layer (`configs`, `core`, `obs`, and
`serving/{request,costmodel,scheduler,session}`) is a verbatim copy of
`repro`'s with imports renamed; `kernels`, `models` and
`serving/{executor,engine}` are rewritten in PyTorch, with hand-written
CUDA kernels for flash prefill and paged decode attention under `csrc/`.
The package never imports `jax` or `repro`.

Entry points take `device=` and default to ``"cuda"``: without a CUDA
device they raise rather than fall back to the CPU. Pass ``device="cpu"``
to run the plain PyTorch versions (the CPU tests do).
"""
from __future__ import annotations

import torch

_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype a config's dtype name (``"float32"`` or
    ``"bfloat16"``) stands for."""
    return _TORCH_DTYPES[name]


def resolve_device(device="cuda") -> torch.device:
    """`device` as a `torch.device`; raises when it names CUDA and no
    CUDA device is present (no silent CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' to run the plain "
            "PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev
