#!/usr/bin/env python3
"""Sweep the tuning constants of the paged kernels on one NVIDIA GPU.

    python3 tools/paged_sweep.py [--only decode,body,tf32] [OUT_JSON]

Writes variants of `csrc/paged_attention.cu` (SPLIT tokens per block, NW
warps, STAGES of the cp.async ring), of the bf16 tensor-core body in
`csrc/paged_prefill.cu` (`tc::`: BK keys per step, STAGES of its ring,
MAX_NWR warps per block) and of its 3xTF32 body (`tf::`: kBk keys per
step below D 128, kBk128 at D 128, kStages of its ring, kWarps warps per
block below D 128, kWarps128 at D 128) under the gitignored
`build/sweep/`, with the constants substituted, builds them with one
`nvcc` each, in parallel, loads them with ctypes and times, with
`chip_smoke._time_ms`:

  - paged decode (one launch: the split kernel merges a row's splits),
    llama2-7b heads, bf16, BS 16: the serve path's batch (8 rows at
    prompt + 16), B 1 at ctx 4096 and B 32 at ctx 256-2047, each variant
    checked against the plain version;
  - the one-pool bf16 body at the fused path's timed shape (a 512-token
    chunk at offset 512, llama2-7b heads) and at granite-3-2b's (H 32,
    KV 8, D 64), each variant checked against the plain version;
  - the one-pool 3xTF32 body at `paged_ab.TF32_ROWS`' one-pool rows: the
    same chunk in f32 at both heads, and the smoke paths' shape
    (granite-3-2b smoke: a 64-token chunk at offset 64, H 8, KV 2, D 32)
    in bf16 and f32, each variant checked against the plain version (f32
    within 2e-5, bf16 within 2e-2);
  - the copy engine on the same bytes, pinned to device and back
    (`copy_`, non-blocking).

Prints one line per variant and shape and the card's name and power
limit; with OUT_JSON also writes them there. Needs a CUDA device.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "sweep")
# (SPLIT, NW, STAGES); the first is the committed kernel's
DECODE = [(256, 4, 3), (256, 4, 4), (256, 4, 2), (512, 4, 3), (128, 4, 3),
          (256, 8, 3)]
# the tensor-core body's (BK, STAGES, MAX_NWR); the first is the
# committed kernel's (Q passes through one ring slot: MAX_NWR * 8 <= BK)
BODY = [(64, 2, 4), (64, 3, 4), (32, 3, 4), (32, 2, 4), (64, 2, 8),
        (64, 2, 2)]
# the 3xTF32 body's (kBk, kBk128, kStages, kWarps, kWarps128); the first
# is the committed kernel's (a ring slot holds at least one row a thread:
# BK >= threads / 16-byte chunks a row)
TF32 = [(64, 32, 2, 4, 8), (64, 32, 2, 4, 4), (64, 32, 3, 4, 8),
        (64, 16, 2, 4, 8), (64, 16, 3, 4, 8), (64, 64, 2, 4, 4),
        (32, 32, 2, 4, 8)]


def _variant(name, src, repl):
    """Write `src` with each (old, new) of `repl` substituted and start
    its build; returns (process, library path, build log path)."""
    from repro_torch.kernels import _build
    text = open(os.path.join(_build.CSRC, src)).read()
    for old, new in repl:
        if old not in text:
            raise RuntimeError(f"{src}: {old!r} not found")
        text = text.replace(old, new)
    cu = os.path.join(OUT, f"{name}.cu")
    with open(cu, "w") as f:
        f.write(text)
    so = os.path.join(OUT, f"lib{name}.so")
    log = open(cu + ".log", "w")
    return subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                             str(_build.CSRC), "-o", so, cu], stdout=log,
                            stderr=subprocess.STDOUT), so, cu + ".log"


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    kinds = {"decode", "body", "tf32"}
    if argv[:1] == ["--only"]:
        kinds, argv = set(argv[1].split(",")), argv[2:]
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import paged_prefill as pp
    os.makedirs(OUT, exist_ok=True)
    builds = {}
    for s, w, st in DECODE if "decode" in kinds else ():
        builds[("decode", s, w, st)] = _variant(
            f"decode_s{s}_w{w}_st{st}", "paged_attention.cu",
            [("constexpr int SPLIT = 256;", f"constexpr int SPLIT = {s};"),
             ("constexpr int NW = 4;", f"constexpr int NW = {w};"),
             ("constexpr int STAGES = 3;", f"constexpr int STAGES = {st};")])
    for bk, st, nw in BODY if "body" in kinds else ():
        builds[("body", bk, st, nw)] = _variant(
            f"body_bk{bk}_st{st}_nwr{nw}", "paged_prefill.cu",
            [("constexpr int BK = 64;         // keys per step",
              f"constexpr int BK = {bk};         // keys per step"),
             ("constexpr int STAGES = 2;      // depth",
              f"constexpr int STAGES = {st};      // depth"),
             ("constexpr int MAX_NWR = 4;     // warps",
              f"constexpr int MAX_NWR = {nw};     // warps")])
    for bk, bk128, st, nw, nw128 in TF32 if "tf32" in kinds else ():
        builds[("tf32", bk, bk128, st, nw, nw128)] = _variant(
            f"tf32_bk{bk}_bk128{bk128}_st{st}_w{nw}_w128{nw128}",
            "paged_prefill.cu",
            [("constexpr int kBk = 64;", f"constexpr int kBk = {bk};"),
             ("constexpr int kBk128 = 32;",
              f"constexpr int kBk128 = {bk128};"),
             ("constexpr int kStages = 2;", f"constexpr int kStages = {st};"),
             ("constexpr int kWarps = 4;", f"constexpr int kWarps = {nw};"),
             ("constexpr int kWarps128 = 8;",
              f"constexpr int kWarps128 = {nw128};")])
    libs = {}
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from flash_ab import _ptxas
    from paged_ab import TF32_ROWS
    for key, (proc, so, log) in builds.items():
        if proc.wait():
            raise RuntimeError(f"nvcc failed for {key}; see {OUT}")
        libs[key] = ctypes.CDLL(so)
        if key[0] == "tf32":   # its kernels' registers and spills
            for line in _ptxas(open(log).read(),
                               lambda fn: "paged_prefill_tf32" in fn):
                print(f"[sweep] {key[1:]} {line}", flush=True)
    smi = cs._smi()
    print(smi, flush=True)
    res = {"nvidia_smi": smi, "decode": []}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    H, KV, D = cs.FLASH_SHAPES["llama2-7b"]
    bf16 = torch.bfloat16
    vp, ci = ctypes.c_void_p, ctypes.c_int
    b32 = torch.randint(256, 2048, (32,), generator=torch.Generator()
                        .manual_seed(3)).tolist()
    for shape, ctx in (("B=8 serve batch", [len(p) + 16
                                            for p in cs._prompts()]),
                       ("B=1 ctx 4096", [4096]), ("B=32 ctx 256-2047", b32)):
        q, pool, tab, lens = cs._paged_rows(gen, H, KV, D, bf16, ctx)
        B, MAXB = tab.shape
        want = pa.paged_attention_plain(q, pool, tab, lens)
        nbytes, _ = cs._decode_bound(ctx, H, KV, D, 16, B)
        for key, lib in libs.items():
            if key[0] != "decode":
                continue
            split = key[1]
            ns = -(-MAXB * 16 // split)
            f = lib.paged_attention_fwd
            f.argtypes = [vp] * 8 + [ci] * 8 + [ctypes.c_float, ci, vp]
            out = torch.empty_like(q)
            po = torch.empty(B, H, ns, D, device="cuda")
            pm = torch.empty(B, H, ns, 2, device="cuda")
            tk = torch.zeros(B * KV, dtype=torch.int32, device="cuda")

            def call():
                st = torch.cuda.current_stream().cuda_stream
                err = f(q.data_ptr(), pool.data_ptr(), tab.data_ptr(),
                        lens.data_ptr(), out.data_ptr(), po.data_ptr(),
                        pm.data_ptr(), tk.data_ptr(), B, H, KV, D, 16, MAXB,
                        split, ns, D ** -0.5, 1, st)
                if err:
                    raise RuntimeError(f"{key}: cudaError_t {err}")
            call()
            err, ok = cs._max_err(out, want, 2e-2)
            if not ok:
                raise AssertionError(f"{key} {shape}: err {err}")
            ms = cs._time_ms(call, reps=50)
            row = {"split": split, "warps": key[2], "stages": key[3],
                   "shape": shape, "ms": ms,
                   "bound_ms": nbytes / cs.HBM_BYTES_PER_S * 1e3}
            res["decode"].append(row)
            print(f"[sweep] decode SPLIT {split} NW {key[2]} STAGES "
                  f"{key[3]} {shape}: {ms:.4f} ms (bound "
                  f"{row['bound_ms']:.4f})", flush=True)
        del q, pool, tab, lens, want
    # the copy engine's rate on the fused path's live K/V (64 blocks)
    nbytes = (512 + 512) // 16 * 16 * 2 * KV * D * 2
    shapes = {"body": [(arch, arch, "bfloat16", 512, 512)
                       for arch in ("llama2-7b", "granite-3-2b")],
              "tf32": [(name, *row[:4]) for name, row in TF32_ROWS.items()
                       if not row[4]]}   # the one-pool rows
    for kind in ("body", "tf32"):
        res[kind] = []
        for name, heads, dt, C, off in shapes[kind]:
            dtype = getattr(torch, dt)
            Hb, KVb, Db = {**cs.FLASH_SHAPES, **cs.SMOKE_SHAPES}[heads]
            qb, segb, posb, klenb, _, mb = cs._pp_batch(
                gen, Hb, KVb, Db, dtype, [(off, C)])
            poolb = torch.randn(4 * mb, 16, 2, KVb, Db, generator=gen,
                                device="cuda").to(dtype)
            tabb = torch.randperm(4 * mb, generator=gen,
                                  device="cuda")[:mb].reshape(1, mb).int()
            wantb = pp.paged_prefill_plain(qb, poolb, tabb, segb, posb,
                                           klenb, tq=32)
            for key, lib in libs.items():
                if key[0] != kind:
                    continue
                f = lib.paged_prefill_fwd
                f.argtypes = [vp] * 9 + [ci] * 9 + [ctypes.c_float, ci, vp]
                outb = torch.empty_like(qb)

                def call():
                    err = f(qb.data_ptr(), poolb.data_ptr(), None,
                            tabb.data_ptr(), segb.data_ptr(),
                            posb.data_ptr(), klenb.data_ptr(), None,
                            outb.data_ptr(), qb.shape[0], Hb, KVb, Db, 16, 1,
                            mb, 32, poolb.shape[0], Db ** -0.5,
                            int(dt == "bfloat16"),
                            torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"{key}: cudaError_t {err}")
                call()
                err, ok = cs._max_err(outb, wantb, cs.TOL[dt])
                if not ok:
                    raise AssertionError(f"{key} {name}: err {err}")
                ms = cs._time_ms(call, reps=50)
                res[kind].append({"variant": key[1:], "shape": name,
                                  "ms": ms, "max_abs_err": err})
                print(f"[sweep] {kind} {key[1:]} {name}: {ms:.4f} ms "
                      f"(err {err:.3g})", flush=True)
            del qb, poolb, tabb, wantb
    src = torch.empty(nbytes // 2, dtype=bf16).pin_memory()
    dst = torch.empty(nbytes // 2, dtype=bf16, device="cuda")
    for name, fn in (("h2d", lambda: dst.copy_(src, non_blocking=True)),
                     ("d2h", lambda: src.copy_(dst, non_blocking=True))):
        ms = cs._time_ms(fn, reps=30)
        res[f"copy_engine_{name}_gb_per_s"] = nbytes / ms / 1e6
        print(f"[sweep] copy engine {name} (pinned): {ms:.4f} ms = "
              f"{nbytes / ms / 1e6:.1f} GB/s", flush=True)
    if argv:
        with open(argv[0], "w") as fh:
            json.dump(res, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
