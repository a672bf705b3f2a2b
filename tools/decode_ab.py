#!/usr/bin/env python3
"""Compare checkouts of the repository on one NVIDIA GPU: the traced
decode step of each checkout's `chip_smoke.py`, on the model of one of
its serving paths (`serve`, llama2-7b, by default; `moe`,
deepseek-moe-16b).

    python3 tools/decode_ab.py [--path serve|moe] OUT_DIR TREE [TREE ...]

Each TREE is a checkout of the repository, for instance the parent
commit unpacked with `git archive` under the gitignored `build/`; `.` is
this one. List them in turns (parent, change, change, parent) so that
drift of the card or the host shows. Each runs in a fresh process that
builds that tree's kernels and runs its `_profile_decode` (an exclusive
vllm engine on the path's model, random weights from the engine's
seed, the path's prompts (serve 8, moe 6) at full width and depth: the
prefill step and two decode steps, then torch.profiler over four
decode-only steps); the process writes
OUT_DIR/decode_ab_<i>.json and prints one summary line: wall and
device-busy ms a step, the busy share and device ops a step. Needs a
CUDA device; exits non-zero on the first tree that fails.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys


def _one(tree: str, out: str, path: str) -> None:
    tree = os.path.abspath(tree)
    sys.path[:0] = [os.path.join(tree, "src"), tree]
    os.chdir(tree)
    import chip_smoke as cs
    import torch
    from repro_torch.configs import get_config
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = cs.phase_build()
    cfg = get_config(cs.PATHS[path]["arch"])
    prof = cs._profile_decode(cfg, None, cs._path_prompts(path, cfg),
                              cs.PATHS[path]["out_len"])
    with open(out, "w") as f:
        json.dump({"tree": tree, "path": path, "nvidia_smi": smi,
                   "profile": prof}, f, indent=1, default=str)
    print(f"[ab] {tree}: {cfg.arch_id} decode B {prof['batch']}: "
          f"{prof['wall_ms_per_step']:.2f} ms wall a step, device busy "
          f"{prof['device_busy_ms_per_step']:.2f} ms "
          f"({prof['device_busy_share']:.3f}), "
          f"{prof['device_ops_per_step']:.0f} device ops a step; {smi}",
          flush=True)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--one"]:
        _one(*argv[1:4])
        return 0
    path = "serve"
    if argv[:1] == ["--path"]:
        path, argv = argv[1], argv[2:]
    if path not in ("serve", "moe") or len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    out_dir, trees = os.path.abspath(argv[0]), argv[1:]
    os.makedirs(out_dir, exist_ok=True)
    for i, tree in enumerate(trees, 1):
        out = os.path.join(out_dir, f"decode_ab_{i}.json")
        rc = subprocess.call([sys.executable, os.path.abspath(__file__),
                              "--one", tree, out, path])
        if rc:
            print(f"[ab] {tree} failed: exit {rc}", file=sys.stderr)
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
