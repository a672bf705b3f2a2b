#!/usr/bin/env python3
"""Compare the first tokens of one of `chip_smoke.py`'s serving paths
across checkouts of the repository on one NVIDIA GPU, with the margin of
each first token.

    python3 tools/path_ab.py [--bf16-f32-reduce] OUT_DIR TAG TREE [TREE ...]

TAG is a path of `chip_smoke.PATHS` (serve, fused or moe in any tree).
Each TREE is a checkout, for instance the parent commit unpacked with
`git archive` under the gitignored `build/`; `.` is this one. Each runs
in a fresh
process that imports that tree's `chip_smoke.py` and port, and drives
the path as `chip_smoke._serve_pair` does (a layerkv run on the tight pool,
then vllm on the pool that fits everything, same weights and prompts)
without stopping at the first mismatch. Then it prefills each prompt
alone (B = 1, exclusive prefill) and records the two largest logits at
its last position, their gap and one bf16 step at the larger one's
magnitude, through this checkout's `chip_smoke.solo_top2` and
`bf16_step`: the helpers of `chip_smoke.check_first_tokens`, which
accepts a differing first token only as such a near-tie (the two tokens
the two largest logits, the gap at most one step). It also records each
run's wall-clock TTFT and TPOT per request, its decode tokens per second
and the layerkv run's compiled-step counts, as `chip_smoke._serve_pair`
prints them. This tool asserts nothing: it reports every request's
numbers. With --bf16-f32-reduce, bf16 matrix products keep
their split-K reductions in f32
(`torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction =
False`). The process writes OUT_DIR/path_ab_<TAG>_<i>.json and prints a
summary. Needs a CUDA device.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import os
import subprocess
import sys


def _here():
    """This checkout's `chip_smoke.py` (its `solo_top2` and `bf16_step`,
    the helpers its first-token check reads; a tree under test may
    predate them), loaded under a name of its own."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_here", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


HERE = _here()


def _one(tree: str, tag: str, out: str, f32_reduce: bool) -> None:
    tree = os.path.abspath(tree)
    sys.path[:0] = [os.path.join(tree, "src"), tree]
    import torch
    import chip_smoke as cs
    from repro_torch.configs import get_config
    if not cs.__file__.startswith(tree):
        raise RuntimeError(f"imported {cs.__file__}, not {tree}'s")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if f32_reduce:
        torch.backends.cuda.matmul \
            .allow_bf16_reduced_precision_reduction = False
    pc = cs.PATHS[tag]
    if hasattr(cs, "path_config"):   # trees that have the *-smoke paths
        cfg = cs.path_config(tag)
        prompts = cs._path_prompts(tag, cfg)
    else:
        cfg = get_config(pc["arch"])
        prompts = cs._prompts(cfg.vocab_size, n=pc["n"], seed=pc["seed"])
    eng, done, st = cs._serve(cfg, None, "layerkv", pc["ndb"], pc["nhb"],
                              prompts, pc["out_len"], seed=0, device="cuda",
                              **pc["mode"])
    lk = {r.rid: list(r.generated) for r in done}
    graphs = {k: getattr(eng.ex, k, None) for k in (
        "graph_captures", "graph_replays", "graph_pool_bytes")}
    graphs["eager_steps"] = dict(getattr(eng.ex, "eager_steps", {}))
    params = eng.ex.params
    del eng, done
    gc.collect()
    eng, done, st_v = cs._serve(cfg, params, "vllm", pc["ndb_ref"], 16,
                                prompts, pc["out_len"], seed=0,
                                device="cuda", **pc["mode"])
    vl = {r.rid: list(r.generated) for r in done}
    rows = []
    for i, p in enumerate(prompts):
        (t0, l0), (t1, l1) = HERE.solo_top2(eng.ex, p)
        rid = f"r{i}"
        rows.append({"rid": rid, "prompt_len": len(p),
                     "layerkv_first": lk[rid][0], "vllm_first": vl[rid][0],
                     "solo_top2": [t0, t1], "solo_logits": [l0, l1],
                     "solo_gap": l0 - l1,
                     "one_bf16_step": HERE.bf16_step(l0)})
    agree = sum(a == b for rid in lk for a, b in zip(lk[rid], vl[rid]))
    total = sum(len(t) for t in lk.values())
    wall = {name: {"ttft_s": sorted(s["ttft_s"].values()),
                   "tpot_ms": sorted(x * 1e3 for x in s["tpot_s"].values()),
                   "decode_tok_per_s": s["decode_tokens"]
                   / s["decode_wall_s"] if s["decode_wall_s"] else None}
            for name, s in (("layerkv", st), ("vllm", st_v))}
    res = {"tree": tree, "tag": tag, "bf16_f32_reduce": f32_reduce,
           "nvidia_smi": cs._smi(), "torch": torch.__version__,
           "requests": rows, "agreement": agree / total, "wall": wall,
           "layerkv_graphs": graphs}
    with open(out, "w") as f:
        json.dump(res, f, indent=1)
    bad = [r["rid"] for r in rows if r["layerkv_first"] != r["vllm_first"]]
    print(f"[path_ab] {tree} {tag} f32-reduce={f32_reduce}: first tokens "
          f"differ for {bad or 'none'}; full-stream agreement "
          f"{agree}/{total}; {res['nvidia_smi']}, torch {torch.__version__}",
          flush=True)
    for name, w in wall.items():
        print(f"[path_ab]   {name}: TTFT s "
              f"{[round(x, 4) for x in w['ttft_s']]}; TPOT ms "
              f"{[round(x, 2) for x in w['tpot_ms']]}; decode "
              f"{w['decode_tok_per_s'] or float('nan'):.1f} tok/s",
              flush=True)
    print(f"[path_ab]   layerkv compiled steps: {graphs}", flush=True)
    for r in rows:
        print(f"[path_ab]   {r['rid']} len {r['prompt_len']}: layerkv "
              f"{r['layerkv_first']} vllm {r['vllm_first']} solo top2 "
              f"{r['solo_top2']} gap {r['solo_gap']:.6g} (one bf16 step "
              f"{r['one_bf16_step']:.6g})", flush=True)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--one"]:
        _one(argv[1], argv[2], argv[3], argv[4] == "1")
        return 0
    f32_reduce = argv[:1] == ["--bf16-f32-reduce"]
    argv = argv[1:] if f32_reduce else argv
    if len(argv) < 3:
        print(__doc__, file=sys.stderr)
        return 2
    out_dir, tag, trees = os.path.abspath(argv[0]), argv[1], argv[2:]
    os.makedirs(out_dir, exist_ok=True)
    suffix = "_f32reduce" if f32_reduce else ""
    for i, tree in enumerate(trees, 1):
        out = os.path.join(out_dir, f"path_ab_{tag}{suffix}_{i}.json")
        rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                             "--one", tree, tag, out,
                             "1" if f32_reduce else "0"]).returncode
        if rc:
            print(f"[path_ab] {tree} failed: exit {rc}", file=sys.stderr)
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
