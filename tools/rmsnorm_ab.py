#!/usr/bin/env python3
"""Compare the RMSNorm kernels of checkouts of the repository on one
NVIDIA GPU.

    python3 tools/rmsnorm_ab.py OUT_DIR TREE [TREE ...]

Each TREE is a checkout of the repository, for instance the parent
commit unpacked with `git archive` under the gitignored `build/`; `.` is
this one. List them in turns (parent, change, change, parent) so that
drift of the card shows. Each runs in a fresh process that builds that
tree's `csrc/rmsnorm.cu` and times, through that tree's wrapper and with
THIS tree's `chip_smoke._time_ms` (one timing method for every tree),
the forward at the train path's activations (4096 x 2048) and at
llama2-7b's serve shapes (1024 x 4096 prefill, 8 x 4096 decode) and the
backward at the train path's, all bf16, each beside `F.rms_norm` (its
autograd backward for the backward) in the same process, and splits the
train-shape times by kernel with torch.profiler. It holds each forward
against the plain version first. The process writes
OUT_DIR/rmsnorm_ab_<i>.json and prints one summary line. Needs a CUDA
device; exits non-zero on the first tree that fails.
"""
from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
SMOKE = os.path.join(os.path.dirname(HERE), "chip_smoke.py")
REPS = 100


def _sha(t):
    """A short hash of a tensor's bits (bf16 viewed as int16)."""
    import torch
    bits = t.view(torch.int16) if t.element_size() == 2 else t
    return hashlib.sha256(bits.cpu().numpy().tobytes()).hexdigest()[:16]


def _kernel_us(cs, fn):
    """Device microseconds per call of each kernel `fn` launches
    (`chip_smoke._kernel_ms` over 20 calls)."""
    return {k: ms * 1e3 for k, ms in cs._kernel_ms(fn, 20).items()}


def _one(tree: str, out: str) -> None:
    tree = os.path.abspath(tree)
    sys.path.insert(0, os.path.join(tree, "src"))
    import torch
    import torch.nn.functional as F
    spec = importlib.util.spec_from_file_location("chip_smoke_here", SMOKE)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from repro_torch.kernels import _build
    from repro_torch.kernels import rmsnorm as rn
    if not rn.__file__.startswith(tree):
        raise RuntimeError(f"imported {rn.__file__}, not {tree}'s")
    _build.build(["rmsnorm"])
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    res = {"tree": tree, "nvidia_smi": cs._smi(), "fwd": {}}
    for name in ("train", "llama2-7b prefill", "llama2-7b decode"):
        x, w, rows, d = cs._norm_inputs(gen, cs.NORM_SHAPES[name])
        y = rn.rmsnorm(x, w)
        err = float((y.float() - rn.rmsnorm_plain(x, w).float()).abs().max())
        if not err <= 2e-2 * 8:   # bf16: a few ulps of |y| <= ~4
            raise AssertionError(f"{name}: forward err {err}")
        res["fwd"][name] = {
            "shape": f"{rows} x {d}", "max_abs_err": err, "y_sha": _sha(y),
            "ms": cs._time_ms(lambda: rn.rmsnorm(x, w), reps=REPS),
            "library_ms": cs._time_ms(
                lambda: F.rms_norm(x, (d,), w, eps=1e-6), reps=REPS),
            "kernels_us": _kernel_us(cs, lambda: rn.rmsnorm(x, w))}
    x, w, rows, d = cs._norm_inputs(gen, cs.NORM_SHAPES["train"])
    dy = torch.randn(x.shape, generator=gen, device="cuda") \
        .to(torch.bfloat16)
    _, rstd = rn._forward(x, w, 1e-6, keep_rstd=True)
    xg, wg = (t.clone().requires_grad_() for t in (x, w))
    y = F.rms_norm(xg, (d,), wg, eps=1e-6)
    dx, _ = rn.rmsnorm_bwd(dy, x, w, rstd)
    res["bwd"] = {
        "shape": f"{rows} x {d}", "dx_sha": _sha(dx),
        "ms": cs._time_ms(lambda: rn.rmsnorm_bwd(dy, x, w, rstd), reps=REPS),
        "library_ms": cs._time_ms(lambda: torch.autograd.grad(
            y, (xg, wg), dy, retain_graph=True), reps=REPS),
        "kernels_us": _kernel_us(cs, lambda: rn.rmsnorm_bwd(dy, x, w, rstd))}
    with open(out, "w") as f:
        json.dump(res, f, indent=1)
    fwd = "; ".join(f"{k} {v['ms']:.4f} (F.rms_norm {v['library_ms']:.4f}, "
                    f"y {v['y_sha']})" for k, v in res["fwd"].items())
    print(f"[ab] {tree}: fwd {fwd}; bwd {res['bwd']['ms']:.4f} (F.rms_norm "
          f"autograd {res['bwd']['library_ms']:.4f}, dx "
          f"{res['bwd']['dx_sha']}); {res['nvidia_smi']}",
          flush=True)
    for k, v in [("fwd train", res["fwd"]["train"])] + [("bwd", res["bwd"])]:
        print(f"[ab]   {k} profiler us/call: {v['kernels_us']}", flush=True)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--one"]:
        _one(argv[1], argv[2])
        return 0
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    out_dir, trees = os.path.abspath(argv[0]), argv[1:]
    os.makedirs(out_dir, exist_ok=True)
    for i, tree in enumerate(trees, 1):
        out = os.path.join(out_dir, f"rmsnorm_ab_{i}.json")
        rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                             "--one", tree, out]).returncode
        if rc:
            print(f"[ab] {tree} failed: exit {rc}", file=sys.stderr)
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
