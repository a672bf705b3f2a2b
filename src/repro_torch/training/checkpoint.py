"""Checkpoints in the reference's format (`repro.training.checkpoint`):
one flat `arrays.npz` keyed like ``params/layers/attn/wq`` plus a
`manifest.json` with `keys`, `dtypes` and `meta`. npz cannot hold
bfloat16, so bf16 leaves are widened to f32 and their dtype recorded.
The reference's `load` and the port's `weights.load_checkpoint` both
read what `save` writes.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from repro_torch.models.model import flatten_params


def save(path: str, tree, meta: dict | None = None) -> None:
    """Write the nested dict of tensors `tree` (any device) to `path`."""
    os.makedirs(path, exist_ok=True)
    flat, dtypes = {}, {}
    for k, t in flatten_params(tree).items():
        t = t.detach().cpu()
        dtypes[k] = str(t.dtype).removeprefix("torch.")
        flat[k] = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    np.savez(os.path.join(path, "arrays.npz"), **flat)
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump({"meta": meta or {}, "keys": sorted(flat),
                   "dtypes": dtypes}, f)
