#!/usr/bin/env python3
"""Compare the paged attention kernels of checkouts of the repository on
one NVIDIA GPU, alone and along the fused serving path.

    python3 tools/paged_ab.py [--no-trace] OUT_DIR TREE [TREE ...]
    python3 tools/paged_ab.py --tf32 OUT_DIR TREE [TREE ...]

Each TREE is a checkout of the repository, for instance the parent
commit unpacked with `git archive` under the gitignored `build/`; `.` is
this one. List them in turns (parent, change, change, parent) so that
drift of the card shows. Each runs in a fresh process that builds that
tree's kernels and, through that tree's public wrappers and with THIS
tree's `chip_smoke` helpers (one timing method and one set of inputs for
every tree), times

  - paged decode, llama2-7b (H = KV = 32, D = 128), bf16, BS 16: the
    serve path's batch (8 rows at their prompt lengths + 16) and B 1 at
    ctx 4096, each held against the plain version first
    (`chip_smoke.time_paged` too: with a tree's separate combine kernel
    timed alone where it has one), and the host time of one call and of
    32 back-to-back calls (llama2-7b's layers: one decode step);
  - paged prefill at the fused path's timed shape (a 512-token chunk at
    offset 512), over the device pool and over the same blocks in the
    pinned host pool; the two outputs must be equal bit for bit. A tree
    with copy-engine staging (`stage_host_runs`) is timed as its
    executor issues the call, from a host-side list of runs
    (`chip_smoke.staged_two_pool_call`); an older tree through its
    `host_pool=` wrapper, its SM staging kernel included;
  - that tree's staging alone on the side stream (`staging_stream`, or a
    stream of its own for an older tree), and the same staging beside 8
    one-pool bodies on the compute stream, against the 8 bodies alone:
    what staging one layer ahead costs the compute it overlaps;
  - the host time of one staging and of one two-pool call, as that
    tree's executor issues them: listing the runs from numpy tables and
    handing them to the copy engine, or the SM staging kernel launched
    on the device-side tables;

each split by kernel with torch.profiler. A host time is the median
over calls of the wall time until the call returns, the device idle
before each call. Then, unless --no-trace, it drives one layerkv run of
the fused path (llama2-7b at full size, random weights from seed 0)
under torch.profiler (`chip_smoke._profile_run`): the paged kernels'
device time and launches, the two-pool calls apart, the side stream's
copies and their overlap with compute, staging host calls and time per
step.

The process writes OUT_DIR/paged_ab_<i>.json and prints a summary.

With --tf32, the case of the paged prefill body that f32 at every D and
bf16 at D 32 take (the 3xTF32 kernel; a CUDA-core one in older trees):
each tree, in a fresh process, builds its `csrc/paged_prefill.cu`,
reports the body route its dispatch names for f32 at D 32 / 64 / 128 and
bf16 at D 32 (`body_route`), and holds against the plain version and
times through its wrapper, with THIS tree's `chip_smoke._time_pp_one_pool`
(one set of inputs, one timing method and one bound for every tree: the
3xTF32 floor and the f32 FMA one beside it), the fused path's chunk (512
tokens at offset 512, kv_len 1024, BS 16, tq 32) in f32 at llama2-7b's
heads (H = KV = 32, D 128), one pool and two (bit-identical to one), and
at granite-3-2b's (H 32, KV 8, D 64), and the smoke paths' shape (a
64-token chunk at offset 64, H 8, KV 2, D 32) in bf16 and f32. Writes
OUT_DIR/paged_tf32_ab_<i>.json.

Needs a CUDA device; exits non-zero on the first tree that fails.
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


def _host_us(fn, n=200):
    """Median host microseconds until `fn()` returns, over `n` calls,
    each issued with the device idle."""
    import statistics
    import time
    import torch
    fn()
    ts = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return statistics.median(ts) * 1e6


def _overlap_ms(cs, stage, body, n=8):
    """Device ms of `n` calls of body() on the compute stream alone, and
    of the same calls with one stage() issued beside them on a side
    stream (from one start, to the end of both)."""
    import torch
    side = torch.cuda.Stream()
    alone = cs._time_ms(lambda: [body() for _ in range(n)], reps=10)

    def both():
        main = torch.cuda.current_stream()
        side.wait_stream(main)
        with torch.cuda.stream(side):
            stage()
        for _ in range(n):
            body()
        main.wait_stream(side)
    return alone, cs._time_ms(both, reps=10)


def _one(tree: str, out: str, trace: bool) -> None:
    tree = os.path.abspath(tree)
    sys.path.insert(0, os.path.join(tree, "src"))
    import numpy as np
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
    copy_engine = hasattr(pp, "stage_host_runs")
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
                               "kernels_ms": cs._kernel_ms(call),
                               "host_us": _host_us(call)}
        if ctx != [4096]:
            res["decode"][name]["host_us_per_32_calls"] = _host_us(
                lambda: [call() for _ in range(32)], n=50)
        del q, pool, tab, lens, got
    res["time_paged"] = cs.time_paged(gen)
    q, seg, pos, klen, _, maxb = cs._pp_batch(gen, H, KV, D, bf16,
                                              [(512, 512)])
    pool = torch.randn(4 * maxb, 16, 2, KV, D, generator=gen,
                       device="cuda").to(bf16)
    tab = torch.randperm(4 * maxb, generator=gen, device="cuda")[:maxb] \
        .reshape(1, maxb).int()
    hpool = pool.cpu().pin_memory()
    tier = torch.ones(1, dtype=torch.bool, device="cuda")

    def one_pool():
        return pp.paged_prefill(q, pool, tab, seg, pos, klen, tq=32)
    if copy_engine:
        tables = (tab.cpu().numpy(), klen.cpu().numpy(),
                  tier.cpu().numpy())
        runs = pp.host_block_runs(*tables, 16, hpool.shape[0])
        staged = torch.empty((maxb, 16, 2, KV, D), dtype=bf16,
                             device="cuda")
        side = pp.staging_stream(pool.device)

        def two_pool(runs=runs):
            return cs.staged_two_pool_call(hpool, runs, staged, lambda:
                                           pp.paged_prefill(
                                               q, pool, tab, seg, pos, klen,
                                               tq=32, staged=staged,
                                               tier=tier))

        def stage(runs=runs):
            pp.stage_host_runs(hpool, runs, staged)

        def listed(fn):     # the runs listed per call, as the executor does
            return lambda: fn(pp.host_block_runs(*tables, 16,
                                                 hpool.shape[0]))
    else:
        side = torch.cuda.Stream()
        staged = torch.empty((maxb, 16, 2, KV, D), dtype=bf16,
                             device="cuda")

        def two_pool():
            return pp.paged_prefill(q, pool, tab, seg, pos, klen, tq=32,
                                    host_pool=hpool, tier=tier)

        def stage():
            pp.stage_host_blocks(hpool, tab, klen, tier, out=staged)

        def listed(fn):     # the SM kernel reads the device-side tables
            return fn
    one, two = one_pool(), two_pool()
    torch.cuda.synchronize()
    with torch.cuda.stream(side):
        stage_ms = cs._time_ms(stage, reps=REPS)
        stage_host_us = _host_us(listed(stage))
    alone, beside = _overlap_ms(cs, stage, one_pool)
    res["prefill"] = {
        "bit_identical": bool(torch.equal(one, two)),
        "one_pool_ms": cs._time_ms(one_pool, reps=REPS),
        "two_pool_ms": cs._time_ms(two_pool, reps=REPS),
        "two_pool_kernels_ms": cs._kernel_ms(two_pool),
        "staging": "copy engine (stage_host_runs)" if copy_engine
        else "SM kernel (stage_host_blocks)",
        "staging_ms_side_stream": stage_ms,
        "staging_host_us": stage_host_us,
        "two_pool_host_us": _host_us(listed(two_pool)),
        "eight_bodies_ms": alone, "eight_bodies_with_staging_ms": beside}
    if not res["prefill"]["bit_identical"]:
        raise AssertionError("two pools differ from one pool on the same "
                             "blocks")
    del q, pool, tab, one, two, hpool
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
    print(f"[paged_ab] {tree}: "
          f"decode {dec}; prefill one pool {pf['one_pool_ms']:.4f}, two "
          f"pools {pf['two_pool_ms']:.4f} (bit-identical); staging "
          f"({pf['staging']}) alone on a side stream "
          f"{pf['staging_ms_side_stream']:.4f}; 8 bodies "
          f"{pf['eight_bodies_ms']:.4f}, with the staging beside them "
          f"{pf['eight_bodies_with_staging_ms']:.4f}; host us per call: "
          f"staging {pf['staging_host_us']:.1f}, two-pool call "
          f"{pf['two_pool_host_us']:.1f}; {res['nvidia_smi']}", flush=True)
    for k, v in res["decode"].items():
        per_step = v.get("host_us_per_32_calls")
        print(f"[paged_ab]   decode {k} by kernel (ms/call): "
              f"{v['kernels_ms']}; host {v['host_us']:.1f} us per call"
              + (f", {per_step:.1f} us per 32 calls" if per_step else ""),
              flush=True)
    tp = res["time_paged"]
    print(f"[paged_ab]   time_paged: B 8 {tp['ms']:.4f} (combine alone "
          f"{tp.get('combine_ms', 'folded')}), B 1 ctx 4096 "
          f"{tp['at_b1_ctx4096']['ms']:.4f}", flush=True)
    print(f"[paged_ab]   two pools by kernel (ms/call): "
          f"{pf['two_pool_kernels_ms']}", flush=True)
    if trace:
        ft = res["fused_trace"]
        print(f"[paged_ab]   fused trace: {ft['kernels']}; {ft['ranges']}; "
              f"side copies {ft['side_copies']}; staging {ft['staging']}; "
              f"busy {ft['device_busy_ms_per_step']:.1f} ms of "
              f"{ft['wall_ms_per_step']:.1f} ms", flush=True)


# the --tf32 rows: (heads in chip_smoke's FLASH_SHAPES or SMOKE_SHAPES,
# dtype, chunk, offset, two pools)
TF32_ROWS = {
    "llama2-7b f32": ("llama2-7b", "float32", 512, 512, False),
    "granite-3-2b f32": ("granite-3-2b", "float32", 512, 512, False),
    "llama2-7b f32, two pools": ("llama2-7b", "float32", 512, 512, True),
    "smoke D 32 bf16": ("granite-3-2b smoke", "bfloat16", 64, 64, False),
    "smoke D 32 f32": ("granite-3-2b smoke", "float32", 64, 64, False),
}


def _one_tf32(tree: str, out: str) -> None:
    tree = os.path.abspath(tree)
    sys.path.insert(0, os.path.join(tree, "src"))
    import torch
    spec = importlib.util.spec_from_file_location("chip_smoke_here", SMOKE)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from repro_torch.kernels import _build
    from repro_torch.kernels import paged_prefill as pp
    if not pp.__file__.startswith(tree):
        raise RuntimeError(f"imported {pp.__file__}, not {tree}'s")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build(["paged_prefill"])
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    res = {"tree": tree, "nvidia_smi": cs._smi(), "routes": {
        f"{dt} D {D}": pp.body_route(getattr(torch, dt), D)
        for dt, D in (("float32", 32), ("float32", 64), ("float32", 128),
                      ("bfloat16", 32))}, "rows": {}}
    for name, (heads, dt, C, off, two) in TF32_ROWS.items():
        H, KV, D = {**cs.FLASH_SHAPES, **cs.SMOKE_SHAPES}[heads]
        res["rows"][name] = cs._time_pp_one_pool(
            gen, H, KV, D, getattr(torch, dt), C, off, None,
            two_pools=two)
    with open(out, "w") as f:
        json.dump(res, f, indent=1, default=str)
    print(f"[paged_ab tf32] {tree}: routes {res['routes']}; "
          f"{res['nvidia_smi']}", flush=True)
    for name, t in res["rows"].items():
        print(f"[paged_ab tf32]   {name}: {t['ms']:.4f} ms, bound "
              f"{t['bound_ms']:.4f} ({t['bound_by']}), f32 FMA bound "
              f"{t.get('bound_ms_f32_fma', float('nan')):.4f}, plain "
              f"{t['plain_ms']:.4f}, max_abs_err {t['max_abs_err']:.3g}",
              flush=True)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--one"]:
        _one(argv[1], argv[2], argv[3] == "1")
        return 0
    if argv[:1] == ["--one-tf32"]:
        _one_tf32(argv[1], argv[2])
        return 0
    tf32 = argv[:1] == ["--tf32"]
    trace = not tf32 and argv[:1] != ["--no-trace"]
    argv = argv[1:] if tf32 or argv[:1] == ["--no-trace"] else argv
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    out_dir, trees = os.path.abspath(argv[0]), argv[1:]
    os.makedirs(out_dir, exist_ok=True)
    for i, tree in enumerate(trees, 1):
        if tf32:
            cmd = ["--one-tf32", tree,
                   os.path.join(out_dir, f"paged_tf32_ab_{i}.json")]
        else:
            cmd = ["--one", tree,
                   os.path.join(out_dir, f"paged_ab_{i}.json"),
                   "1" if trace else "0"]
        rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                             *cmd]).returncode
        if rc:
            print(f"[paged_ab] {tree} failed: exit {rc}", file=sys.stderr)
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
