"""Weights from the JAX reference, by copy.

The reference's params are a pytree of arrays; flattened they are a dict
keyed like ``layers/attn/wq`` (layer-stacked leaves keep their leading
(L, ...) axis). The port keeps JAX's (in, out) matrix layout and computes
`x @ w`, so crossing over is a copy, never a transpose. MoE leaves
(``layers/moe/{router,we_gate,we_up,we_down,shared/*}``) cross the same
way.

Every leaf keeps its own dtype: the reference keeps some leaves in f32
whatever the model dtype is (the MoE router, `repro.models.moe`), and
the port computes with them in f32 too.

`repro.training.checkpoint.save` writes exactly that flat dict as
``arrays.npz`` plus a ``manifest.json`` that records each array's
original dtype (bf16 is widened to f32, since npz cannot hold it).
`load_checkpoint` reads that format with numpy alone.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import torch_dtype, unflatten_params


def from_jax_params(flat: Dict[str, np.ndarray], cfg: ModelConfig,
                    device="cuda", dtypes: Optional[Dict[str, str]] = None):
    """Flat ``{'layers/attn/wq': array, ...}`` (numpy f32 / bf16, incl.
    ml_dtypes bfloat16) -> the port's nested params on `device`, each leaf
    in its own dtype, or in ``dtypes[key]`` where given (a checkpoint
    manifest's record of arrays widened to f32 on save). Raises if a leaf
    is in neither `cfg.dtype` nor f32."""
    dev = resolve_device(device)
    allowed = {torch_dtype(cfg.dtype), torch.float32}
    out = {}
    for key, arr in flat.items():
        a = np.asarray(arr)
        name = (dtypes or {}).get(key, a.dtype.name)
        if a.dtype.name == "bfloat16":   # torch cannot read ml_dtypes' bf16
            a = a.astype(np.float32)
        dt = torch_dtype(name)
        if dt not in allowed:
            raise ValueError(f"{key}: dtype {name} is neither the model's "
                             f"{cfg.dtype} nor float32")
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
    return (from_jax_params(flat, cfg, device, manifest.get("dtypes")),
            manifest.get("meta", {}))
