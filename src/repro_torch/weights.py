"""Weights from the JAX reference, by copy.

The reference's params are a pytree of arrays; flattened they are a dict
keyed like ``layers/attn/wq`` (layer-stacked leaves keep their leading
(L, ...) axis). The port keeps JAX's (in, out) matrix layout and computes
`x @ w`, so crossing over is a copy, never a transpose.

`repro.training.checkpoint.save` writes exactly that flat dict as
``arrays.npz`` plus a ``manifest.json`` that records each array's
original dtype (bf16 is widened to f32, since npz cannot hold it).
`load_checkpoint` reads that format with numpy alone.
"""
from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import torch_dtype, unflatten_params


def from_jax_params(flat: Dict[str, np.ndarray], cfg: ModelConfig,
                    device="cuda"):
    """Flat ``{'layers/attn/wq': array, ...}`` (numpy, any float dtype incl.
    ml_dtypes bfloat16) -> the port's nested params in `cfg.dtype` on
    `device`."""
    dev = resolve_device(device)
    dt = torch_dtype(cfg.dtype)
    out = {}
    for key, arr in flat.items():
        a = np.asarray(arr)
        if a.dtype.name == "bfloat16":   # torch cannot read ml_dtypes' bf16
            a = a.astype(np.float32)
        out[key] = torch.tensor(a, dtype=dt, device=dev)   # always a copy
    return unflatten_params(out)


def load_checkpoint(path: str, cfg: ModelConfig, device="cuda"):
    """Params from a checkpoint directory written by
    `repro.training.checkpoint.save(path, params)`. Returns (params,
    meta)."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        flat = {k: data[k] for k in manifest["keys"]}
    return from_jax_params(flat, cfg, device), manifest.get("meta", {})
