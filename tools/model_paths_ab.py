#!/usr/bin/env python3
"""The port's host-paced model paths on one NVIDIA GPU, across checkouts
of the repository: generate-ssm's TTFT (xlstm-1.3b, the sLSTM's token
loop), generate-hybrid's TPOT (zamba2-2.7b, ~2400 device ops a decode
step) and the train path's step (granite-3-2b, B 4 x S 1024), each
driven by the tree's own `chip_smoke.py` phase with its checks.

    python3 tools/model_paths_ab.py [--train-steps N] OUT_DIR TREE \
        [TREE ...]

Each TREE is a checkout, for instance the parent commit unpacked with
`git archive` under the gitignored `build/`; `.` is this one. List them
in turns (parent, change, change, parent) so that drift of the card
shows. Each runs in a fresh process that imports that tree's port and
`chip_smoke.py`, builds that tree's kernels, runs generate-ssm,
generate-hybrid (twice each: the first run of a process also pays its
start-up) and train, and writes OUT_DIR/model_paths_<i>.json. Prints
TTFT, the median TPOT, the steady train step (the median of the steps
after the first) and the card's name and power limit. With
--train-steps, only the train path, for N steps. Needs a CUDA device.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def _one(tree: str, out: str, train_steps: int) -> None:
    tree = os.path.abspath(tree)
    sys.path[:0] = [os.path.join(tree, "src"), tree]
    import chip_smoke as cs
    from repro_torch.kernels import _build
    for mod in (cs, _build):
        if not mod.__file__.startswith(tree):
            raise RuntimeError(f"imported {mod.__file__}, not {tree}'s")
    _build.build(["flash_prefill", "flash_backward", "rmsnorm"])
    res = {"tree": tree, "nvidia_smi": cs._smi()}
    paths = () if train_steps else (("generate-ssm", cs.GENERATE_SSM),
                                    ("generate-hybrid", cs.GENERATE_HYBRID))
    for tag, g in paths:
        res[tag] = [{k: v for k, v in
                     cs.phase_generate_recurrent(tag, g).items()
                     if k != "tokens"} for _ in range(2)]
    if train_steps:
        cs.TRAIN["steps"] = train_steps
    res["train"] = cs.phase_train()
    with open(out, "w") as f:
        json.dump(res, f, indent=1, default=str)
    steps = res["train"]["step_s"][1:]
    line = "".join(
        f"{tag} TTFT " + " / ".join(f"{r['ttft_s']:.4f}" for r in res[tag])
        + " s, TPOT median " + " / ".join(
            f"{_median(r['tpot_s']) * 1e3:.2f}" for r in res[tag]) + " ms; "
        for tag, _ in paths)
    print(f"[model_paths] {tree}: {line}train: {len(steps)} steps after "
          f"the first, median {_median(steps):.4f} s, mean "
          f"{sum(steps) / len(steps):.4f} s, {min(steps):.4f}-"
          f"{max(steps):.4f} s; {res['nvidia_smi']}", flush=True)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--one"]:
        _one(argv[1], argv[2], int(argv[3]))
        return 0
    train_steps = 0
    if argv[:1] == ["--train-steps"]:
        train_steps, argv = int(argv[1]), argv[2:]
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    out_dir, trees = os.path.abspath(argv[0]), argv[1:]
    os.makedirs(out_dir, exist_ok=True)
    for i, tree in enumerate(trees, 1):
        out = os.path.join(out_dir, f"model_paths_{i}.json")
        rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                             "--one", tree, out, str(train_steps)]
                            ).returncode
        if rc:
            print(f"[model_paths] {tree} failed: exit {rc}", file=sys.stderr)
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
