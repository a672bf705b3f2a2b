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
alone (B = 1, exclusive prefill) and records the gap between the two
largest logits at its last position, so a first token that differs
between policies can be told apart as a near-tie (a gap within bf16
rounding) or not. With --bf16-f32-reduce, bf16 matrix products keep
their split-K reductions in f32
(`torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction =
False`). The process writes OUT_DIR/path_ab_<TAG>_<i>.json and prints a
summary. Needs a CUDA device.
"""
from __future__ import annotations

import gc
import json
import os
import subprocess
import sys


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
    eng, done, _ = cs._serve(cfg, None, "layerkv", pc["ndb"], pc["nhb"],
                             prompts, pc["out_len"], seed=0, device="cuda",
                             **pc["mode"])
    lk = {r.rid: list(r.generated) for r in done}
    params = eng.ex.params
    del eng, done
    gc.collect()
    eng, done, _ = cs._serve(cfg, params, "vllm", pc["ndb_ref"], 16,
                             prompts, pc["out_len"], seed=0, device="cuda",
                             **pc["mode"])
    vl = {r.rid: list(r.generated) for r in done}
    last = []
    note = eng.ex._note_logits

    def keep(logits):
        last.append(logits.float().reshape(-1, logits.shape[-1])[-1])
        note(logits)
    eng.ex._note_logits = keep
    rows = []
    for i, p in enumerate(prompts):
        eng.ex.prefill(p, len(p))
        top = torch.topk(last[-1], 2)
        rid = f"r{i}"
        rows.append({"rid": rid, "prompt_len": len(p),
                     "layerkv_first": lk[rid][0], "vllm_first": vl[rid][0],
                     "solo_top2": top.indices.tolist(),
                     "solo_gap": float(top.values[0] - top.values[1]),
                     "logit_std": float(last[-1].std())})
    agree = sum(a == b for rid in lk for a, b in zip(lk[rid], vl[rid]))
    total = sum(len(t) for t in lk.values())
    res = {"tree": tree, "tag": tag, "bf16_f32_reduce": f32_reduce,
           "nvidia_smi": cs._smi(), "torch": torch.__version__,
           "requests": rows, "agreement": agree / total}
    with open(out, "w") as f:
        json.dump(res, f, indent=1)
    bad = [r["rid"] for r in rows if r["layerkv_first"] != r["vllm_first"]]
    print(f"[path_ab] {tree} {tag} f32-reduce={f32_reduce}: first tokens "
          f"differ for {bad or 'none'}; full-stream agreement "
          f"{agree}/{total}; {res['nvidia_smi']}, torch {torch.__version__}",
          flush=True)
    for r in rows:
        print(f"[path_ab]   {r['rid']} len {r['prompt_len']}: layerkv "
              f"{r['layerkv_first']} vllm {r['vllm_first']} solo top2 "
              f"{r['solo_top2']} gap {r['solo_gap']:.4f} (logit std "
              f"{r['logit_std']:.3f})", flush=True)


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
