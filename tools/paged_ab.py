#!/usr/bin/env python3
"""Compare the paged attention kernels of checkouts of the repository on
one NVIDIA GPU, alone and along the fused serving path.

    python3 tools/paged_ab.py [--no-trace] OUT_DIR TREE [TREE ...]

Each TREE is a checkout of the repository, for instance the parent
commit unpacked with `git archive` under the gitignored `build/`; `.` is
this one. List them in turns (parent, change, change, parent) so that
drift of the card shows. Each runs in a fresh process that builds that
tree's kernels and, through that tree's public wrappers and with THIS
tree's `chip_smoke` helpers (one timing method and one set of inputs for
every tree), times

  - paged decode, llama2-7b (H = KV = 32, D = 128), bf16, BS 16: the
    serve path's batch (8 rows at their prompt lengths + 16) and B 1 at
    ctx 4096, each held against the plain version first;
  - paged prefill at the fused path's timed shape (a 512-token chunk at
    offset 512), over the device pool and over the same blocks in the
    pinned host pool; the two outputs must be equal bit for bit;

each split by kernel with torch.profiler. Then, unless --no-trace, it
drives one layerkv run of the fused path (llama2-7b at full size, random
weights from seed 0) under torch.profiler (`chip_smoke._profile_run`):
the paged kernels' device time and launches, the two-pool calls apart.
The process writes OUT_DIR/paged_ab_<i>.json and prints a summary. Needs
a CUDA device; exits non-zero on the first tree that fails.
"""
from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
SMOKE = os.path.join(os.path.dirname(HERE), "chip_smoke.py")
REPS = 50


def _one(tree: str, out: str, trace: bool) -> None:
    tree = os.path.abspath(tree)
    sys.path.insert(0, os.path.join(tree, "src"))
    import torch
    spec = importlib.util.spec_from_file_location("chip_smoke_here", SMOKE)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from repro_torch.kernels import _build
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import paged_prefill as pp
    if not pa.__file__.startswith(tree):
        raise RuntimeError(f"imported {pa.__file__}, not {tree}'s")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    H, KV, D = cs.FLASH_SHAPES["llama2-7b"]
    bf16 = torch.bfloat16
    res = {"tree": tree, "nvidia_smi": cs._smi(), "decode": {}}
    for name, ctx in (("B=8 serve batch",
                       [len(p) + 16 for p in cs._prompts()]),
                      ("B=1 ctx 4096", [4096])):
        q, pool, tab, lens = cs._paged_rows(gen, H, KV, D, bf16, ctx)
        got = pa.paged_attention(q, pool, tab, lens)
        err, ok = cs._max_err(got, pa.paged_attention_plain(q, pool, tab,
                                                            lens), 2e-2)
        if not ok:
            raise AssertionError(f"decode {name}: err {err}")

        def call():
            return pa.paged_attention(q, pool, tab, lens)
        res["decode"][name] = {"ms": cs._time_ms(call, reps=REPS),
                               "max_abs_err": err,
                               "kernels_ms": cs._kernel_ms(call)}
        del q, pool, tab, lens, got
    q, seg, pos, klen, _, maxb = cs._pp_batch(gen, H, KV, D, bf16,
                                              [(512, 512)])
    pool = torch.randn(4 * maxb, 16, 2, KV, D, generator=gen,
                       device="cuda").to(bf16)
    tab = torch.randperm(4 * maxb, generator=gen, device="cuda")[:maxb] \
        .reshape(1, maxb).int()
    two_kw = {"host_pool": pool.cpu().pin_memory(),
              "tier": torch.ones(1, dtype=torch.bool, device="cuda")}
    one = pp.paged_prefill(q, pool, tab, seg, pos, klen, tq=32)
    two = pp.paged_prefill(q, pool, tab, seg, pos, klen, tq=32, **two_kw)
    torch.cuda.synchronize()
    res["prefill"] = {
        "bit_identical": bool(torch.equal(one, two)),
        "one_pool_ms": cs._time_ms(lambda: pp.paged_prefill(
            q, pool, tab, seg, pos, klen, tq=32), reps=REPS),
        "two_pool_ms": cs._time_ms(lambda: pp.paged_prefill(
            q, pool, tab, seg, pos, klen, tq=32, **two_kw), reps=REPS),
        "two_pool_kernels_ms": cs._kernel_ms(lambda: pp.paged_prefill(
            q, pool, tab, seg, pos, klen, tq=32, **two_kw))}
    if not res["prefill"]["bit_identical"]:
        raise AssertionError("two pools differ from one pool on the same "
                             "blocks")
    del q, pool, tab, one, two, two_kw
    torch.cuda.empty_cache()
    if trace:
        from repro_torch.configs import get_config
        from repro_torch.models import DecoderModel
        cfg = get_config(cs.PATHS["fused"]["arch"])
        params = DecoderModel(cfg, None, device="cuda", seed=0).params
        res["fused_trace"] = cs._profile_run(
            cfg, params, "fused", cs._path_prompts("fused", cfg))
    with open(out, "w") as f:
        json.dump(res, f, indent=1, default=str)
    dec = "; ".join(f"{k} {v['ms']:.4f}" for k, v in res["decode"].items())
    pf = res["prefill"]
    print(f"[paged_ab] {tree}: decode {dec}; prefill one pool "
          f"{pf['one_pool_ms']:.4f}, two pools {pf['two_pool_ms']:.4f} "
          f"(bit-identical); {res['nvidia_smi']}", flush=True)
    for k, v in res["decode"].items():
        print(f"[paged_ab]   decode {k} by kernel (ms/call): "
              f"{v['kernels_ms']}", flush=True)
    print(f"[paged_ab]   two pools by kernel (ms/call): "
          f"{pf['two_pool_kernels_ms']}", flush=True)
    if trace:
        ft = res["fused_trace"]
        print(f"[paged_ab]   fused trace: {ft['kernels']}; {ft['ranges']}; "
              f"busy {ft['device_busy_ms_per_step']:.1f} ms of "
              f"{ft['wall_ms_per_step']:.1f} ms", flush=True)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--one"]:
        _one(argv[1], argv[2], argv[3] == "1")
        return 0
    trace = argv[:1] != ["--no-trace"]
    argv = argv if trace else argv[1:]
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    out_dir, trees = os.path.abspath(argv[0]), argv[1:]
    os.makedirs(out_dir, exist_ok=True)
    for i, tree in enumerate(trees, 1):
        out = os.path.join(out_dir, f"paged_ab_{i}.json")
        rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                             "--one", tree, out,
                             "1" if trace else "0"]).returncode
        if rc:
            print(f"[paged_ab] {tree} failed: exit {rc}", file=sys.stderr)
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
