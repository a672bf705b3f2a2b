#!/usr/bin/env python3
"""The flash kernels on one NVIDIA GPU, one case of routes at a time: a
check of this checkout, an A/B across checkouts, and a sweep of the
case's constants.

    python3 tools/flash_ab.py CASE OUT_DIR TREE [TREE ...]
    python3 tools/flash_ab.py CASE --check OUT_JSON
    python3 tools/flash_ab.py CASE --sweep OUT_JSON
    python3 tools/flash_ab.py d80 --paths OUT_DIR TREE [TREE ...]

CASE names an entry of CASES:

  d80  bf16 at head dim 80 (zamba2-2.7b's shared attention): forward,
       backward and `decode_attention` held against their plain versions
       (q_offset 37, Sq != Skv; decode over ragged contexts), timed at
       the chip_smoke shapes (forward and backward at B 4, S 1024,
       H = KV = 32, causal; decode at B 4 over 1040 of 1056 keys) and,
       as a control, the forward and backward at the train path's D 64
       and the forward at llama2-7b's D 128. Sweep: the backward's
       kBq80 / kMinDq80 / kMinDkdv80 and the forward's cap on its K/V
       ring, at the train-hybrid shape.
  f32  the f32 route at every D and bf16 at D 32 (3xTF32 on the tensor
       cores): held at train_tiny's G = 3 shape; with --check also f32
       at D 32, 64, 80 and 128 within 2e-5 and bf16 at D 32 within 2e-2
       (causal at Sq != Skv and q_offset 37, a window, G = 3, one-row
       decode); timed at train_tiny's shape (B 4, S 256, H 12, KV 4,
       D 64, f32, causal), granite-3-2b's train shape in f32 (B 4,
       S 1024, H 32, KV 8, D 64), quickstart's (granite-3-2b smoke: B 8,
       S 64, H 8, KV 2, D 32) in f32 and bf16, and the one-row decode at
       D 64 and 80. Sweep: the forward's kBkF, the backward's kBkDq /
       kWarpsKv / kMinKv, at train_tiny's and granite-3-2b's f32 train
       shapes.

A/B: each TREE is a checkout of the repository, for instance the parent
commit unpacked with `git archive` under the gitignored `build/`; `.` is
this one. List them in turns (parent, change, change, parent) so that
drift of the card shows. Each runs in a fresh process that builds that
tree's `csrc/flash_prefill.cu` and `csrc/flash_backward.cu`, reads the
case's routes from that tree's dispatch, and holds and times the case
through that tree's wrapper with THIS tree's `chip_smoke` helpers (one
timing method and one bound for every tree), each row beside its plain
version and SDPA (TF32 off). Writes OUT_DIR/flash_<CASE>_ab_<i>.json.

Check: the A/B's run on this tree alone, with the compiler's registers
and spills of the case's kernels and the case's full checks.

Paths (d80): the same turns, each tree's own `chip_smoke.py` driving its
generate-hybrid and train-hybrid phases (zamba2-2.7b at full size, the
paths that run flash at D 80) with their checks, generate-hybrid twice
(the first run of a process also pays its start-up); writes
OUT_DIR/hybrid_paths_<i>.json and prints TTFT, TPOT, the steady step,
peak memory and the step-0 loss.

Sweep: builds variants of this tree's sources under the gitignored
`build/sweep/` (each a line of constants rewritten), one `nvcc` each, in
parallel, prints each variant's registers and spills, puts each library
in the wrapper's place, holds it against the plain version and times it
at the case's shapes, the time split by kernel with torch.profiler. The
first variant of each list is the committed one.

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


def _smoke(path=SMOKE):
    spec = importlib.util.spec_from_file_location("chip_smoke_here", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def _setup(tree):
    tree = os.path.abspath(tree)
    sys.path.insert(0, os.path.join(tree, "src"))
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 means f32
    torch.backends.cudnn.allow_tf32 = False
    cs = _smoke()
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_prefill as fp
    if not fp.__file__.startswith(tree):
        raise RuntimeError(f"imported {fp.__file__}, not {tree}'s")
    _build.build(["flash_prefill", "flash_backward"])
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    return tree, cs, _build, gen


def _route(tree, pairs):
    """The macro each flash source's C entry uses for each (dtype code,
    D) of `pairs` (0 f32, 1 bf16)."""
    out = {}
    for src in ("flash_prefill.cu", "flash_backward.cu"):
        text = open(os.path.join(tree, "src/repro_torch/csrc", src)).read()
        for dt, D in pairs:
            m = re.search(rf"dtype == {dt} && D == {D}\) (REPRO_\w+)\(",
                          text)
            out[f"{src} {('f32', 'bf16')[dt]} D {D}"] = \
                m.group(1) if m else None
    return out


def _ptxas(text, keep):
    """ptxas's register / spill lines of the entry functions `keep`
    accepts, and any C7514 warning."""
    out, fn = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
        elif "C7514" in line or (fn and keep(fn) and (
                "registers" in line or "spill" in line)):
            out.append(f"{fn}: {line.strip()}")
    return out


# ------------------------------------------------------------------ d80 --

def _check_d80(cs, gen, full):
    """bf16 D 80 forward, backward and decode against the plain versions
    at chip_smoke's tolerances; the worst error of each."""
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
    return {"D 80 bfloat16": {"fwd": out_err, "bwd": bwd_err,
                              "decode": dec_err}}


def _times_d80(cs, gen):
    H, KV, D = cs.D80_ATTN
    B, S = cs.TRAIN_HYBRID["batch"], cs.TRAIN_HYBRID["seq"]
    gran = cs.FLASH_SHAPES["granite-3-2b"]
    Bt, St = cs.TRAIN["batch"], cs.TRAIN["seq"]
    return {
        "fwd D 80": cs._time_flash_fwd_at(gen, H, KV, D, B, S, S, True),
        "bwd D 80": cs._time_flash_bwd_at(gen, H, KV, D, B, S),
        "decode D 80": cs._time_decode_at(
            gen, H, KV, D, [cs.GENERATE_HYBRID["prompt"] + 16] * B,
            cs.D80_DECODE_SLOTS),
        "control fwd D 64": cs._time_flash_fwd_at(gen, *gran, Bt, St, St,
                                                  True),
        "control bwd D 64": cs._time_flash_bwd_at(gen, *gran, Bt, St),
        "control fwd D 128": cs._time_flash_fwd_at(
            gen, *cs.FLASH_SHAPES["llama2-7b"], 1, St, St, True,
            lens_arg=True)}


def _sweep_shapes_d80(cs):
    return {"train-hybrid": (*cs.D80_ATTN, cs.TRAIN_HYBRID["batch"],
                             cs.TRAIN_HYBRID["seq"], "bfloat16", True)}


def _one_paths(tree: str, out: str) -> None:
    """Each tree's own generate-hybrid and train-hybrid phases."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, os.path.join(tree, "src"))
    cs = _smoke(os.path.join(tree, "chip_smoke.py"))
    from repro_torch.kernels import _build
    if not _build.__file__.startswith(tree):
        raise RuntimeError(f"imported {_build.__file__}, not {tree}'s")
    _build.build(["flash_prefill", "flash_backward", "rmsnorm"])
    gens = [cs.phase_generate_recurrent("generate-hybrid",
                                        cs.GENERATE_HYBRID)
            for _ in range(2)]
    train = cs.phase_train_recurrent("train-hybrid", cs.TRAIN_HYBRID,
                                     cs.TRAIN_KERNELS)
    res = {"tree": tree, "nvidia_smi": cs._smi(),
           "route": _route(tree, CASES["d80"]["pairs"]),
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


# ------------------------------------------------------------------ f32 --

def _check_f32(cs, gen, full):
    """Forward, backward and decode against the plain versions at
    chip_smoke's tolerances; the worst error per case."""
    import torch
    from repro_torch.kernels import flash_prefill as fp
    errs = {}
    shapes = [("train_tiny G=3", cs.TINY_ATTN, 4, 256, 256, 0, 0)]
    if full:
        for D in (32, 64, 80, 128):
            shapes += [(f"D={D} Sq 1000 Skv 1037 q_offset 37", (8, 2, D), 1,
                        1000, 1037, 37, 0),
                       (f"D={D} window 200", (8, 2, D), 1, 1000, 1037, 37,
                        200)]
        shapes += [("G=3 Sq 300 Skv 337 q_offset 37", cs.TINY_ATTN, 2, 300,
                    337, 37, 0)]
    for name, (H, KV, D), B, Sq, Skv, off, window in shapes:
        for dtype in [torch.float32] + ([torch.bfloat16] if D == 32 else []):
            key = str(dtype)[6:]
            tol = cs.TOL[key]
            q, k, v, _, _ = cs._flash_case(gen, H, KV, D, dtype, B, Sq, Skv,
                                           [Skv] * B, off)
            do = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
            kw = dict(q_offset=off, window=window, causal=True)
            err, ok = cs._max_err(fp.flash_attention(q, k, v, **kw),
                                  fp.flash_attention_plain(q, k, v, **kw),
                                  tol)
            got = cs._flash_grads(fp.flash_attention, q, k, v, do, **kw)
            want = cs._flash_grads(fp.flash_attention_plain, q, k, v, do,
                                   **kw)
            torch.cuda.synchronize()
            res = [cs._max_err_grad(a, b, tol) for a, b in zip(got, want)]
            berr = max(r[0] for r in res)
            errs[f"{name} {key}"] = {"fwd": err, "bwd": berr}
            print(f"[check] {name} {key}: fwd {err:.3g} bwd {berr:.3g} "
                  f"(tol {tol})", flush=True)
            if not (ok and all(r[1] for r in res)):
                raise AssertionError(f"{name} {key} disagrees: fwd {err}, "
                                     f"bwd {[r[0] for r in res]}")
    if full:
        lens, S = [1, 63, 64, 65, 281, 700, 1040, 1056], 1056
        for D in (32, 64, 80, 128):
            for dtype in [torch.float32] + (
                    [torch.bfloat16] if D == 32 else []):
                key = str(dtype)[6:]
                q, k, v, kv_len, _ = cs._flash_case(gen, 8, 2, D, dtype,
                                                    len(lens), 1, S, lens, 0)
                err, ok = cs._max_err(fp.decode_attention(q, k, v, kv_len),
                                      fp.decode_attention_plain(q, k, v,
                                                                kv_len),
                                      cs.TOL[key])
                errs[f"decode D={D} {key}"] = {"fwd": err}
                print(f"[check] decode D={D} {key}: {err:.3g}", flush=True)
                if not ok:
                    raise AssertionError(f"decode D={D} {key}: {err}")
    return errs


def _times_f32(cs, gen):
    Bt, St = cs.EXAMPLES["tiny_batch"], cs.EXAMPLES["tiny_seq"]
    Bq, Sq = cs.QUICK_TRAIN
    gran, S = cs.FLASH_SHAPES["granite-3-2b"], cs.TRAIN["seq"]
    quick = cs.SMOKE_SHAPES["granite-3-2b smoke"]
    rows = {
        "fwd train_tiny f32": cs._time_flash_fwd_at(
            gen, *cs.TINY_ATTN, Bt, St, St, True, dtype="float32"),
        "bwd train_tiny f32": cs._time_flash_bwd_at(
            gen, *cs.TINY_ATTN, Bt, St, dtype="float32"),
        "fwd granite train f32": cs._time_flash_fwd_at(
            gen, *gran, cs.TRAIN["batch"], S, S, True, dtype="float32"),
        "bwd granite train f32": cs._time_flash_bwd_at(
            gen, *gran, cs.TRAIN["batch"], S, dtype="float32"),
    }
    for dtype in ("float32", "bfloat16"):
        rows[f"fwd quickstart {dtype}"] = cs._time_flash_fwd_at(
            gen, *quick, Bq, Sq, Sq, True, dtype=dtype)
        rows[f"bwd quickstart {dtype}"] = cs._time_flash_bwd_at(
            gen, *quick, Bq, Sq, dtype=dtype)
    for D in (64, 80):
        rows[f"decode D={D} f32"] = cs._time_decode_at(
            gen, 8, 2, D, [1040] * 8, 1056, dtype="float32")
    return rows


def _sweep_shapes_f32(cs):
    return {"train_tiny": (*cs.TINY_ATTN, cs.EXAMPLES["tiny_batch"],
                           cs.EXAMPLES["tiny_seq"], "float32", True),
            "granite train": (*cs.FLASH_SHAPES["granite-3-2b"],
                              cs.TRAIN["batch"], cs.TRAIN["seq"], "float32",
                              False)}


# Each case: its (dtype code, D) routes, its checks (full or not), its
# timed rows, the kernels whose ptxas lines it prints, its sweep (kind,
# source, line of constants with {} for each value, the variants, the
# committed one first) and the sweep's shapes (H, KV, D, B, S, dtype,
# whether the backward is held through autograd there), and its paths.
CASES = {
    "d80": dict(
        pairs=[(1, 80)], check=_check_d80, times=_times_d80,
        ptxas=lambda fn: "ILi80E" in fn and "mma" in fn,
        sweep=[("bwd", "flash_backward.cu",
                "constexpr int kBq80 = {}, kMinDq80 = {}, kMinDkdv80 = {};",
                [(64, 3, 2), (64, 2, 2), (64, 1, 1), (64, 3, 1), (32, 3, 3),
                 (32, 3, 2), (32, 2, 2), (32, 1, 1)]),
               ("fwd", "flash_prefill.cu",   # 5 stages fit at D = 80
                "static constexpr int STAGES = FIT < {0} ? FIT : {0};",
                [(4,), (5,), (3,)])],
        sweep_shapes=_sweep_shapes_d80, paths=_one_paths),
    "f32": dict(
        pairs=[(0, 32), (0, 64), (0, 80), (0, 128), (1, 32)],
        check=_check_f32, times=_times_f32,
        ptxas=lambda fn: "tf32" in fn,
        sweep=[("fwd", "flash_prefill.cu", "constexpr int kBkF = {};",
                [(64,), (32,)]),
               ("bwd", "flash_backward.cu",
                "constexpr int kBkDq = {}, kWarpsKv = {}, kMinKv = {};",
                [(32, 8, 2), (64, 8, 2), (32, 8, 1), (32, 4, 1),
                 (32, 4, 2)])],
        sweep_shapes=_sweep_shapes_f32, paths=None),
}


# ---------------------------------------------------------------- modes --

def _say_rows(tag, rows):
    for name, r in rows.items():
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        print(f"[{tag}] {name}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, "
              f"SDPA {lib}, bound {r['bound_ms']:.4f} {r['bound_by']}) "
              f"[{r['shape']}]", flush=True)


def _one(case: str, tree: str, out: str, full: bool) -> None:
    c = CASES[case]
    tree, cs, _build, gen = _setup(tree)
    res = {"tree": tree, "nvidia_smi": cs._smi(),
           "route": _route(tree, c["pairs"])}
    if full:
        res["ptxas"] = [line for name in ("flash_prefill", "flash_backward")
                        for line in _ptxas(_build.log_text(name),
                                           c["ptxas"])]
        for line in res["ptxas"]:
            print(f"[ptxas] {line}", flush=True)
    res["max_abs_err"] = c["check"](cs, gen, full)
    res["rows"] = c["times"](cs, gen)
    for row in res["rows"].values():
        row.pop("kernel", None)   # this tree's chip_smoke would name it
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(res, f, indent=1)
    _say_rows("check" if full else "ab", res["rows"])
    print(f"[ab] {tree}: route {res['route']}; err {res['max_abs_err']}; "
          f"{res['nvidia_smi']}", flush=True)


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


def _sweep(case, out_json):
    import ctypes
    import torch
    c = CASES[case]
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    torch.backends.cuda.matmul.allow_tf32 = False
    cs = _smoke()
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_prefill as fp
    os.makedirs(OUT, exist_ok=True)
    os.makedirs(os.path.dirname(out_json), exist_ok=True)
    builds = {}
    for kind, src, line, values in c["sweep"]:
        for v in values:
            builds[(kind, *v)] = _variant(
                f"{case}_{kind}_" + "_".join(map(str, v)), src,
                line.format(*values[0]), line.format(*v))
    smi = cs._smi()
    print(smi, flush=True)
    res = {"nvidia_smi": smi, "variants": []}
    libs = {}
    for key, (proc, so, log) in builds.items():
        if proc.wait():
            raise RuntimeError(f"nvcc failed for {key}: "
                               f"{open(log).read()[-3000:]}")
        libs[key] = ctypes.CDLL(so)
        for line in _ptxas(open(log).read(), c["ptxas"]):
            print(f"[sweep] {key}: {line}", flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    cases = {}
    for name, (H, KV, D, B, S, dtype, grads) in c["sweep_shapes"](cs).items():
        dt = getattr(torch, dtype)
        q, k, v, _, _ = cs._flash_case(gen, H, KV, D, dt, B, S, S, [S] * B,
                                       0)
        do = torch.randn(q.shape, generator=gen, device="cuda").to(dt)
        cases[name] = (q, k, v, do, cs.TOL[dtype],
                       fp.flash_attention_plain(q, k, v),
                       cs._flash_grads(fp.flash_attention_plain, q, k, v, do)
                       if grads else None)
    for key, lib in libs.items():
        lname = "flash_backward" if key[0] == "bwd" else "flash_prefill"
        _build._libs[lname] = lib
        row = {"variant": list(key)}
        for name, (q, k, v, do, tol, want_out, want) in cases.items():
            D = q.shape[-1]
            if key[0] == "fwd":
                fn = lambda: fp.flash_attention(q, k, v)   # noqa: E731
                err, ok = cs._max_err(fn(), want_out, tol)
            else:
                out, lse = fp._launch_fwd(q, k, v, True, 0, None, 0,
                                          D ** -0.5, keep_lse=True)
                fn = lambda: fp.flash_attention_bwd(   # noqa: E731
                    q, k, v, out, do, lse, causal=True)
                err, ok = None, True
                if want is not None:
                    got = cs._flash_grads(fp.flash_attention, q, k, v, do)
                    r = [cs._max_err_grad(g, p, tol)
                         for g, p in zip(got, want)]
                    err, ok = max(x[0] for x in r), all(x[1] for x in r)
            if not ok:
                raise AssertionError(f"{key} {name}: err {err}")
            row[name] = {"ms": cs._time_ms(fn, reps=50), "max_abs_err": err,
                         "by_kernel_ms": cs._kernel_ms(fn, 20)}
        res["variants"].append(row)
        print(f"[sweep] {key}: " + "; ".join(
            f"{n} {row[n]['ms']:.4f} ms {row[n]['by_kernel_ms']}"
            for n in cases), flush=True)
        del _build._libs[lname]
    with open(out_json, "w") as fh:
        json.dump(res, fh, indent=1)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--one"]:
        _one(argv[1], argv[2], argv[3], full=False)
        return 0
    if argv[:1] == ["--one-paths"]:
        _one_paths(argv[1], argv[2])
        return 0
    if len(argv) < 3 or argv[0] not in CASES:
        print(__doc__, file=sys.stderr)
        return 2
    case, argv = argv[0], argv[1:]
    if argv[0] == "--check" and len(argv) == 2:
        _one(case, ROOT, os.path.abspath(argv[1]), full=True)
        return 0
    if argv[0] == "--sweep" and len(argv) == 2:
        _sweep(case, os.path.abspath(argv[1]))
        return 0
    cmd, stem = ["--one", case], f"flash_{case}_ab"
    if argv[0] == "--paths":
        if CASES[case]["paths"] is None:
            print(f"{case} has no paths", file=sys.stderr)
            return 2
        cmd, stem, argv = ["--one-paths"], "hybrid_paths", argv[1:]
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    out_dir, trees = os.path.abspath(argv[0]), argv[1:]
    os.makedirs(out_dir, exist_ok=True)
    for i, tree in enumerate(trees, 1):
        out = os.path.join(out_dir, f"{stem}_{i}.json")
        rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                             *cmd, tree, out]).returncode
        if rc:
            print(f"[ab] {tree} failed: exit {rc}", file=sys.stderr)
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
