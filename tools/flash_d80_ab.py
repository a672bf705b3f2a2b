#!/usr/bin/env python3
"""The flash kernels at head dim 80 (zamba2-2.7b's shared attention) on
one NVIDIA GPU: an A/B across checkouts, and a sweep of the D = 80
constants of this checkout.

    python3 tools/flash_d80_ab.py OUT_DIR TREE [TREE ...]
    python3 tools/flash_d80_ab.py --paths OUT_DIR TREE [TREE ...]
    python3 tools/flash_d80_ab.py --sweep OUT_JSON

A/B: each TREE is a checkout of the repository, for instance the parent
commit unpacked with `git archive` under the gitignored `build/`; `.` is
this one. List them in turns (parent, change, change, parent) so that
drift of the card shows. Each runs in a fresh process that builds that
tree's `csrc/flash_prefill.cu` and `csrc/flash_backward.cu` and, through
that tree's wrapper and with THIS tree's `chip_smoke` helpers (one
timing method for every tree), holds the bf16 forward, backward and
`decode_attention` at D 80 against their plain versions, then times
them at the chip_smoke shapes (forward and backward at B 4, S 1024,
H = KV = 32, causal; decode at B 4 over 1040 of 1056 keys), each beside
SDPA, and, as a control, the forward and backward at the train path's
D 64 and the forward at llama2-7b's D 128. The bf16 D = 80 route is read
from the tree's own dispatch. Writes OUT_DIR/flash_d80_ab_<i>.json.

Paths: the same turns, each tree's own `chip_smoke.py` driving its
generate-hybrid and train-hybrid phases (zamba2-2.7b at full size, the
paths that run flash at D 80) with their checks, generate-hybrid twice
(the first run of a process also pays its start-up); writes
OUT_DIR/hybrid_paths_<i>.json and prints TTFT, TPOT, the steady step,
peak memory and the step-0 loss.

Sweep: builds variants of this tree's sources under the gitignored
`build/sweep/` (the backward's kBq80 / kMinDq80 / kMinDkdv80, the
forward's cap on its K/V ring), one `nvcc` each, in parallel, prints each
variant's registers and spills at D = 80, puts each library in the
wrapper's place, holds it against the plain version and times it at the
train-hybrid shape, split by kernel with torch.profiler. The first
variant of each list is the committed one.

Prints the card's name and power limit. Needs a CUDA device.
"""
from __future__ import annotations

import importlib.util
import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
SMOKE = os.path.join(ROOT, "chip_smoke.py")
OUT = os.path.join(ROOT, "build", "sweep")
# (kBq80, kMinDq80, kMinDkdv80); the first is the committed kernel's
BWD = [(64, 3, 2), (64, 2, 2), (64, 1, 1), (64, 3, 1), (32, 3, 3),
       (32, 3, 2), (32, 2, 2), (32, 1, 1)]
# the forward's cap on its ring of K/V stages (5 fit at D = 80)
FWD = [4, 5, 3]
BWD_LINE = "constexpr int kBq80 = 64, kMinDq80 = 3, kMinDkdv80 = 2;"
FWD_LINE = "static constexpr int STAGES = FIT < 4 ? FIT : 4;"


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_here", SMOKE)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def _route(tree):
    """The macro each flash source's C entry uses for bf16 at D = 80."""
    out = {}
    for src in ("flash_prefill.cu", "flash_backward.cu"):
        text = open(os.path.join(tree, "src/repro_torch/csrc", src)).read()
        m = re.search(r"dtype == 1 && D == 80\) (REPRO_\w+)\(", text)
        out[src] = m.group(1) if m else None
    return out


def _check_d80(cs, gen):
    """bf16 D 80 forward, backward and decode against the plain versions
    at chip_smoke's tolerances; returns the worst error of each."""
    import torch
    from repro_torch.kernels import flash_prefill as fp
    H, KV, D = cs.D80_ATTN
    tol = cs.TOL["bfloat16"]
    q, k, v, _, _ = cs._flash_case(gen, H, KV, D, torch.bfloat16, 2, 1000,
                                   1037, [1037], 37)
    do = torch.randn(q.shape, generator=gen, device="cuda") \
        .to(torch.bfloat16)
    kw = dict(q_offset=37, causal=True)
    got = cs._flash_grads(fp.flash_attention, q, k, v, do, **kw)
    want = cs._flash_grads(fp.flash_attention_plain, q, k, v, do, **kw)
    out_err, ok = cs._max_err(fp.flash_attention(q, k, v, **kw),
                              fp.flash_attention_plain(q, k, v, **kw), tol)
    res = [cs._max_err_grad(g, p, tol) for g, p in zip(got, want)]
    bwd_err = max(r[0] for r in res)
    ok = ok and all(r[1] for r in res)
    q, k, v, lens, _ = cs._flash_case(gen, H, KV, D, torch.bfloat16, 4, 1,
                                      cs.D80_DECODE_SLOTS,
                                      cs.D80_DECODE_LENS, 0)
    dec_err, ok2 = cs._max_err(fp.decode_attention(q, k, v, lens),
                               fp.decode_attention_plain(q, k, v, lens), tol)
    if not (ok and ok2):
        raise AssertionError(f"D 80 disagrees: forward {out_err}, backward "
                             f"{bwd_err}, decode {dec_err}")
    return {"fwd": out_err, "bwd": bwd_err, "decode": dec_err}


def _one(tree: str, out: str) -> None:
    tree = os.path.abspath(tree)
    sys.path.insert(0, os.path.join(tree, "src"))
    import torch
    cs = _smoke()
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_prefill as fp
    if not fp.__file__.startswith(tree):
        raise RuntimeError(f"imported {fp.__file__}, not {tree}'s")
    _build.build(["flash_prefill", "flash_backward"])
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    H, KV, D = cs.D80_ATTN
    B, S = cs.TRAIN_HYBRID["batch"], cs.TRAIN_HYBRID["seq"]
    res = {"tree": tree, "nvidia_smi": cs._smi(), "route": _route(tree),
           "max_abs_err": _check_d80(cs, gen)}
    res["fwd"] = cs._time_flash_fwd_at(gen, H, KV, D, B, S, S, True)
    res["bwd"] = cs._time_flash_bwd_at(gen, H, KV, D, B, S)
    res["decode"] = cs._time_decode_at(
        gen, H, KV, D, [cs.GENERATE_HYBRID["prompt"] + 16] * B,
        cs.D80_DECODE_SLOTS)
    gran = cs.FLASH_SHAPES["granite-3-2b"]
    Bt, St = cs.TRAIN["batch"], cs.TRAIN["seq"]
    res["control"] = {
        "fwd D 64": cs._time_flash_fwd_at(gen, *gran, Bt, St, St, True),
        "bwd D 64": cs._time_flash_bwd_at(gen, *gran, Bt, St),
        "fwd D 128": cs._time_flash_fwd_at(gen, *cs.FLASH_SHAPES["llama2-7b"],
                                           1, St, St, True, lens_arg=True)}
    for row in [res["fwd"], res["bwd"], res["decode"],
                *res["control"].values()]:
        row.pop("kernel", None)   # this tree's chip_smoke would name it
    with open(out, "w") as f:
        json.dump(res, f, indent=1)
    line = "; ".join(f"{k} {res[k]['ms']:.4f} ms (SDPA "
                     f"{res[k]['library_ms']:.4f}, bound "
                     f"{res[k]['bound_ms']:.4f})"
                     for k in ("fwd", "bwd", "decode"))
    ctl = "; ".join(f"{k} {v['ms']:.4f}" for k, v in res["control"].items())
    print(f"[ab] {tree}: route {res['route']}; D 80 {line}; control {ctl}; "
          f"err {res['max_abs_err']}; {res['nvidia_smi']}", flush=True)


def _one_paths(tree: str, out: str) -> None:
    tree = os.path.abspath(tree)
    sys.path.insert(0, os.path.join(tree, "src"))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_tree", os.path.join(tree, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from repro_torch.kernels import _build
    if not _build.__file__.startswith(tree):
        raise RuntimeError(f"imported {_build.__file__}, not {tree}'s")
    _build.build(["flash_prefill", "flash_backward", "rmsnorm"])
    gens = [cs.phase_generate_recurrent("generate-hybrid",
                                        cs.GENERATE_HYBRID)
            for _ in range(2)]
    train = cs.phase_train_recurrent("train-hybrid", cs.TRAIN_HYBRID,
                                     cs.TRAIN_KERNELS)
    res = {"tree": tree, "nvidia_smi": cs._smi(), "route": _route(tree),
           "generate-hybrid": [{k: v for k, v in g.items() if k != "tokens"}
                               for g in gens],
           "train-hybrid": train}
    with open(out, "w") as f:
        json.dump(res, f, indent=1, default=str)
    gen = "; ".join(
        f"TTFT {g['ttft_s']:.4f} s, TPOT median "
        f"{sorted(g['tpot_s'])[len(g['tpot_s']) // 2] * 1e3:.2f} ms"
        for g in gens)
    print(f"[paths] {tree}: route {res['route']}; generate-hybrid {gen}, "
          f"teacher forcing rel {gens[-1]['teacher_forcing_rel']}; "
          f"train-hybrid steady step {train['steady_step_s']:.4f} s, peak "
          f"{train['peak_bytes'] / 2**30:.2f} GiB, step-0 loss "
          f"{train['losses'][0]:.4f}; {res['nvidia_smi']}", flush=True)


def _variant(name, src, old, new):
    """Write `src` with `old` replaced by `new` under build/sweep and
    start its build; returns (process, library path, log path)."""
    from repro_torch.kernels import _build
    text = open(os.path.join(_build.CSRC, src)).read()
    if old not in text:
        raise RuntimeError(f"{src}: {old!r} not found")
    cu = os.path.join(OUT, f"{name}.cu")
    with open(cu, "w") as f:
        f.write(text.replace(old, new))
    so = os.path.join(OUT, f"lib{name}.so")
    log = cu + ".log"
    proc = subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                             str(_build.CSRC), "-o", so, cu],
                            stdout=open(log, "w"), stderr=subprocess.STDOUT)
    return proc, so, log


def _ptxas_d80(log):
    """ptxas's register / spill lines of the D = 80 tensor-core kernels."""
    out, fn = [], None
    for line in open(log).read().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
        elif fn and "ILi80E" in fn and "mma" in fn and (
                "registers" in line or "spill" in line):
            out.append(f"{fn}: {line.strip()}")
    return out


def _sweep(out_json):
    import ctypes
    import torch
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    cs = _smoke()
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_prefill as fp
    os.makedirs(OUT, exist_ok=True)
    builds = {}
    for bq, mdq, mkv in BWD:
        builds[("bwd", bq, mdq, mkv)] = _variant(
            f"flash_backward_bq{bq}_dq{mdq}_kv{mkv}", "flash_backward.cu",
            BWD_LINE, f"constexpr int kBq80 = {bq}, kMinDq80 = {mdq}, "
                      f"kMinDkdv80 = {mkv};")
    for st in FWD:
        builds[("fwd", st)] = _variant(
            f"flash_prefill_st{st}", "flash_prefill.cu", FWD_LINE,
            f"static constexpr int STAGES = FIT < {st} ? FIT : {st};")
    smi = cs._smi()
    print(smi, flush=True)
    res = {"nvidia_smi": smi, "variants": []}
    libs = {}
    for key, (proc, so, log) in builds.items():
        if proc.wait():
            raise RuntimeError(f"nvcc failed for {key}: "
                               f"{open(log).read()[-3000:]}")
        libs[key] = ctypes.CDLL(so)
        for line in _ptxas_d80(log) + [ln.strip() for ln in open(
                log).read().splitlines() if "C7514" in ln]:
            print(f"[sweep] {key}: {line}", flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    H, KV, D = cs.D80_ATTN
    B, S = cs.TRAIN_HYBRID["batch"], cs.TRAIN_HYBRID["seq"]
    q, k, v, _, _ = cs._flash_case(gen, H, KV, D, torch.bfloat16, B, S, S,
                                   [S] * B, 0)
    do = torch.randn(q.shape, generator=gen, device="cuda") \
        .to(torch.bfloat16)
    want_out = fp.flash_attention_plain(q, k, v)
    want = cs._flash_grads(fp.flash_attention_plain, q, k, v, do)
    tol = cs.TOL["bfloat16"]
    for key, lib in libs.items():
        name = "flash_backward" if key[0] == "bwd" else "flash_prefill"
        _build._libs[name] = lib
        if key[0] == "fwd":
            err, ok = cs._max_err(fp.flash_attention(q, k, v), want_out, tol)
            fn = lambda: fp.flash_attention(q, k, v)   # noqa: E731
        else:
            got = cs._flash_grads(fp.flash_attention, q, k, v, do)
            r = [cs._max_err_grad(g, p, tol) for g, p in zip(got, want)]
            err, ok = max(x[0] for x in r), all(x[1] for x in r)
            out, lse = fp._launch_fwd(q, k, v, True, 0, None, 0, D ** -0.5,
                                      keep_lse=True)
            fn = lambda: fp.flash_attention_bwd(   # noqa: E731
                q, k, v, out, do, lse, causal=True)
        if not ok:
            raise AssertionError(f"{key}: err {err}")
        row = {"variant": list(key), "max_abs_err": err,
               "ms": cs._time_ms(fn, reps=50),
               "by_kernel_ms": cs._kernel_ms(fn, 20)}
        res["variants"].append(row)
        print(f"[sweep] {key}: {row['ms']:.4f} ms, by kernel "
              f"{row['by_kernel_ms']}, err {err:.3g}", flush=True)
        del _build._libs[name]
    with open(out_json, "w") as fh:
        json.dump(res, fh, indent=1)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--one"]:
        _one(argv[1], argv[2])
        return 0
    if argv[:1] == ["--one-paths"]:
        _one_paths(argv[1], argv[2])
        return 0
    if argv[:1] == ["--sweep"] and len(argv) == 2:
        _sweep(os.path.abspath(argv[1]))
        return 0
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    mode, stem = "--one", "flash_d80_ab"
    if argv[0] == "--paths":
        mode, stem, argv = "--one-paths", "hybrid_paths", argv[1:]
    out_dir, trees = os.path.abspath(argv[0]), argv[1:]
    os.makedirs(out_dir, exist_ok=True)
    for i, tree in enumerate(trees, 1):
        out = os.path.join(out_dir, f"{stem}_{i}.json")
        rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                             mode, tree, out]).returncode
        if rc:
            print(f"[ab] {tree} failed: exit {rc}", file=sys.stderr)
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
