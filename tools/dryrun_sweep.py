"""Run dry-run pairs in parallel processes, and compare two sweeps (CPU
only; no card):

    PYTHONPATH=src python tools/dryrun_sweep.py run OUT.json \
        [--arch A[,B...] --shape S[,T...]] [--pairs A:S[,B:T...]] \
        [--mesh single,multi] [--jobs 5] [--src DIR]
    python tools/dryrun_sweep.py compare BEFORE.json AFTER.json

`run` starts one `python -m repro_torch.launch.dryrun` process a pair
(every `--arch` with every `--shape`, and each of `--pairs`, on each
mesh; the process group is process-global), `--jobs` at a time, train pairs
first, and writes their records to OUT.json as one list; `--src` names
another tree's `src` to run that tree's dry run (a parent unpacked with
`git archive`). `compare` prints, for each pair in both files, the GiB a
rank before and after, `temp_size` and its change, whether `flops`, the
memory record and the collectives are equal, and the change in `flops`,
the collective bytes before and after, and the change in
`bytes_accessed`.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ORDER = {"train_4k": 0, "prefill_32k": 1, "decode_32k": 2, "long_500k": 3}


def _one(src, arch, shape, mesh, tmp):
    out = os.path.join(tmp, f"{arch}.{shape}.{mesh}.json")
    env = dict(os.environ, PYTHONPATH=src)
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--mesh", mesh, "--out", out],
        env=env, capture_output=True, text=True)
    if proc.returncode:
        return {"arch": arch, "shape": shape, "mesh": mesh, "ok": False,
                "error": f"exit {proc.returncode}: {proc.stderr[-2000:]}"}
    with open(out) as f:
        rec = json.load(f)[0]
    print(f"{arch} x {shape} x {rec['mesh']}: ok {rec['ok']} "
          f"{rec.get('bytes_per_device', 0) / 2**30:.3f} GiB "
          f"{time.time() - t0:.1f} s", flush=True)
    return rec


def run(args):
    both = [(a, s) for s in args.shape.split(",") if s
            for a in args.arch.split(",") if a]
    both += [tuple(p.split(":")) for p in args.pairs.split(",") if p]
    pairs = [(a, s, m) for a, s in both for m in args.mesh.split(",")]
    pairs.sort(key=lambda p: (_ORDER.get(p[1], 9), p[2] == "single"))
    src = os.path.abspath(args.src or os.path.join(ROOT, "src"))
    with tempfile.TemporaryDirectory() as tmp, \
            ThreadPoolExecutor(args.jobs) as pool:
        recs = list(pool.map(lambda p: _one(src, *p, tmp), pairs))
    with open(args.out, "w") as f:
        json.dump(recs, f, indent=1)
    print(f"{sum(r['ok'] for r in recs)}/{len(recs)} ok -> {args.out}")


def compare(args):
    def load(path):
        with open(path) as f:
            return {(r["arch"], r["shape"], r["mesh"]): r for r in json.load(f)
                    if r.get("ok")}
    before, after = load(args.before), load(args.after)
    print("arch | shape | mesh | GiB before | GiB after | temp_size after "
          "| temp_size after - before | memory equal | flops equal | flops "
          "after - before | collectives equal | collective bytes before -> "
          "after | bytes_accessed after - before")
    for key in sorted(before.keys() & after.keys()):
        b, a = before[key], after[key]
        cb, ca = (r["collectives"]["total_bytes"] for r in (b, a))
        print(" | ".join(str(x) for x in (
            *key, f"{b['bytes_per_device'] / 2**30:.3f}",
            f"{a['bytes_per_device'] / 2**30:.3f}",
            a["memory"]["temp_size"],
            a["memory"]["temp_size"] - b["memory"]["temp_size"],
            a["memory"] == b["memory"],
            a["flops"] == b["flops"], f"{a['flops'] - b['flops']:.0f}",
            a["collectives"] == b["collectives"], f"{cb} -> {ca}",
            f"{a['bytes_accessed'] - b['bytes_accessed']:.0f}")))


def main(argv=None):
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run")
    r.add_argument("out")
    r.add_argument("--arch", default="")
    r.add_argument("--shape", default="")
    r.add_argument("--pairs", default="")
    r.add_argument("--mesh", default="single,multi")
    r.add_argument("--jobs", type=int, default=5)
    r.add_argument("--src", default=None)
    c = sub.add_parser("compare")
    c.add_argument("before")
    c.add_argument("after")
    args = ap.parse_args(argv)
    if args.cmd == "run":
        run(args)
    else:
        compare(args)


if __name__ == "__main__":
    main()
