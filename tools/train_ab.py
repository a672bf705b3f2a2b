#!/usr/bin/env python3
"""Compare checkouts of the repository on one NVIDIA GPU: the flash
kernels' times and the train phase of each checkout's `chip_smoke.py`.

    python3 tools/train_ab.py OUT_DIR TREE [TREE ...]

Each TREE is a checkout of the repository, for instance the parent
commit unpacked with `git archive` under the gitignored `build/`; `.` is
this one. List them in turns (parent, change, change, parent) so that
drift of the card or the host shows. Each runs in a fresh process that
builds that tree's kernels, times its flash forward and backward with
THIS tree's `chip_smoke._time_ms` (one timing method for every tree) and
runs its `phase_train(profile=True)`; the process writes
OUT_DIR/train_ab_<i>.json and prints one summary line. Needs a CUDA
device; exits non-zero on the first tree that fails.
"""
from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
SMOKE = os.path.join(os.path.dirname(HERE), "chip_smoke.py")


def _one(tree: str, out: str) -> None:
    tree = os.path.abspath(tree)
    sys.path[:0] = [os.path.join(tree, "src"), tree]
    os.chdir(tree)
    import chip_smoke as cs
    import torch
    spec = importlib.util.spec_from_file_location("chip_smoke_here", SMOKE)
    here = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(here)
    cs._time_ms = here._time_ms
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = cs.phase_build()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    fwd, bwd = cs.time_flash(gen), cs.time_flash_bwd(gen)
    torch.cuda.empty_cache()
    train = cs.phase_train(profile=True)
    res = {"tree": tree, "nvidia_smi": smi, "flash_fwd": fwd,
           "flash_bwd": bwd,
           **{k: train[k] for k in ("step_s", "steady_step_s",
                                    "tokens_per_s", "peak_bytes", "losses",
                                    "profile")}}
    with open(out, "w") as f:
        json.dump(res, f, indent=1, default=str)
    train_fwd = fwd.get("at_train_shape", {}).get("ms")
    print(f"[ab] {tree}: flash fwd {fwd['ms']:.4f} ms (SDPA "
          f"{fwd['library_ms']:.4f}), at the train shape {train_fwd}; "
          f"bwd {bwd['ms']:.4f} ms (SDPA {bwd['library_ms']:.4f}); step s "
          f"{[round(t, 4) for t in train['step_s']]}; device busy "
          f"{train['profile']['device_busy_ms_per_step']:.1f} ms of "
          f"{train['profile']['wall_ms_per_step']:.1f} traced; {smi}",
          flush=True)


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
        out = os.path.join(out_dir, f"train_ab_{i}.json")
        rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                             "--one", tree, out]).returncode
        if rc:
            print(f"[ab] {tree} failed: exit {rc}", file=sys.stderr)
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
