#!/usr/bin/env python3
"""Run chip_smoke's train-ssm configuration (TRAIN_SSM: xlstm-1.3b at
full width, 16 of 48 layers, 5 AdamW steps of 4 x 1024 tokens) in bf16
and in f32 on one NVIDIA GPU, and print each step's loss, gradient norm
and the gradient norms of its parameter leaves, so that a trend in the
gradient-norm path can be told apart as the model's own dynamics (the
same in both dtypes) or as bf16 rounding (the paths part).

    python3 tools/train_dtype_ab.py OUT_DIR

The weights are `build_model(cfg, device="cuda", seed=0)`'s (drawn in
f32 and cast, so both dtypes start from the same weights up to
rounding), the data the synthetic stream of `train_loop.train`. Each
step is `train_loop.make_train_step`'s (loss, autograd backward, AdamW
with `train`'s defaults) with every leaf's gradient norm read between
the backward and the update. Each dtype runs in a fresh process (its own
peak memory; an out-of-memory error ends only that run), which writes
OUT_DIR/train_dtype_<dtype>.json and prints its paths. Exits non-zero if
either run failed.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _one(a) -> int:
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    import dataclasses
    import math
    import time
    import torch
    from chip_smoke import TRAIN_SSM as T, _smi
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.model import flatten_params
    from repro_torch.training.data import DataConfig, SyntheticLM
    from repro_torch.training.optimizer import (AdamWConfig, adamw_update,
                                                init_opt_state)
    cfg = dataclasses.replace(get_config(T["arch"]), n_layers=T["layers"],
                              dtype=a.one)
    tag = f"{T['arch']} L={T['layers']} {a.one} B={T['batch']} S={T['seq']}"
    out = {**T, "dtype": a.one, "nvidia_smi": _smi()}
    path = os.path.join(a.out, f"train_dtype_{a.one}.json")
    torch.cuda.reset_peak_memory_stats()
    try:
        model = build_model(cfg, device="cuda", seed=0)
        model.requires_grad_(True)
        flat = flatten_params(model.params)
        opt = AdamWConfig(lr=1e-3, total_steps=T["steps"],
                          warmup_steps=max(T["steps"] // 10, 5))
        state = init_opt_state(model.params)
        data = SyntheticLM(cfg, DataConfig(batch_size=T["batch"],
                                           seq_len=T["seq"]),
                           device="cuda").batches()
        rows = []
        for step in range(T["steps"]):
            t0 = time.perf_counter()
            loss, _ = model.loss(next(data))
            loss.backward()
            leaves = {k: float(p.grad.float().norm())
                      for k, p in flat.items()}
            grads = {k: p.grad for k, p in flat.items()}
            _, state, m = adamw_update(opt, grads, state, flat)
            for p in flat.values():
                p.grad = None
            rows.append({"loss": float(loss.detach()),
                         "grad_norm": float(m["grad_norm"]),
                         "lr": float(m["lr"]), "leaf_grad_norms": leaves,
                         "s": time.perf_counter() - t0})
            print(f"[{tag}] step {step} loss {rows[-1]['loss']:.4f} "
                  f"grad_norm {rows[-1]['grad_norm']:.3f} lr "
                  f"{rows[-1]['lr']:.2e} ({rows[-1]['s']:.2f} s)",
                  flush=True)
    except torch.OutOfMemoryError as e:
        out.update(ok=False, error=f"out of memory: {str(e)[:200]}")
        print(f"[{tag}] {out['error']}", flush=True)
        with open(path, "w") as f:
            json.dump(out, f, indent=1)
        return 1
    first, last = rows[0]["leaf_grad_norms"], rows[-1]["leaf_grad_norms"]
    top = sorted(last, key=last.get, reverse=True)[:8]
    for k in top:
        print(f"[{tag}] leaf {k}: grad norm {first[k]:.4g} -> {last[k]:.4g}"
              f" ({last[k] / max(first[k], 1e-30):.3g}x); share of the "
              f"last step's squared norm "
              f"{last[k] ** 2 / rows[-1]['grad_norm'] ** 2:.3f}", flush=True)
    ok = all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
             for r in rows)
    out.update(ok=ok, steps=rows, peak_bytes=torch.cuda.max_memory_allocated(),
               losses=[r["loss"] for r in rows],
               grad_norms=[r["grad_norm"] for r in rows])
    print(f"[{tag}] losses {out['losses']}; grad norms {out['grad_norms']};"
          f" peak {out['peak_bytes'] / 2**30:.2f} GiB; {out['nvidia_smi']}",
          flush=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    return 0 if ok else 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("out")
    p.add_argument("--one", help=argparse.SUPPRESS)
    a = p.parse_args(argv)
    os.makedirs(a.out, exist_ok=True)
    if a.one:
        return _one(a)
    sys.path[:0] = [os.path.join(ROOT, "src")]
    from repro_torch.kernels import _build
    _build.build(["flash_prefill", "flash_backward", "rmsnorm"])
    env = dict(os.environ, PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    rcs = [subprocess.run([sys.executable, os.path.abspath(__file__), a.out,
                           "--one", dtype], env=env).returncode
           for dtype in ("bfloat16", "float32")]
    return max(rcs)


if __name__ == "__main__":
    sys.exit(main())
