#!/usr/bin/env python3
"""Sweep the tuning constants of the paged kernels on one NVIDIA GPU.

    python3 tools/paged_sweep.py [--only decode,body] [OUT_JSON]

Writes variants of `csrc/paged_attention.cu` (SPLIT tokens per block, NW
warps, STAGES of the cp.async ring) and of the tensor-core body in
`csrc/paged_prefill.cu` (BK keys per step, STAGES of its ring, MAX_NWR
warps per block) under the gitignored `build/sweep/`, with the constants
substituted, builds them with one `nvcc` each, in parallel, loads them
with ctypes and times, with `chip_smoke._time_ms`:

  - paged decode (one launch: the split kernel merges a row's splits),
    llama2-7b heads, bf16, BS 16: the serve path's batch (8 rows at
    prompt + 16), B 1 at ctx 4096 and B 32 at ctx 256-2047, each variant
    checked against the plain version;
  - the one-pool body at the fused path's timed shape (a 512-token chunk
    at offset 512, llama2-7b heads) and at granite-3-2b's (H 32, KV 8, D 64), bf16,
    each variant checked against the plain version;
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


def _variant(name, src, repl):
    """Write `src` with each (old, new) of `repl` substituted and start
    its build; returns (process, library path)."""
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
                            stderr=subprocess.STDOUT), so


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    kinds = {"decode", "body"}
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
    libs = {}
    for key, (proc, so) in builds.items():
        if proc.wait():
            raise RuntimeError(f"nvcc failed for {key}; see {OUT}")
        libs[key] = ctypes.CDLL(so)
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
    res["body"] = []
    for arch in ("llama2-7b", "granite-3-2b"):
        Hb, KVb, Db = cs.FLASH_SHAPES[arch]
        qb, segb, posb, klenb, _, mb = cs._pp_batch(gen, Hb, KVb, Db, bf16,
                                                    [(512, 512)])
        poolb = torch.randn(4 * mb, 16, 2, KVb, Db, generator=gen,
                            device="cuda").to(bf16)
        tabb = torch.randperm(4 * mb, generator=gen, device="cuda")[:mb] \
            .reshape(1, mb).int()
        wantb = pp.paged_prefill_plain(qb, poolb, tabb, segb, posb, klenb,
                                       tq=32)
        for key, lib in libs.items():
            if key[0] != "body":
                continue
            f = lib.paged_prefill_fwd
            f.argtypes = [vp] * 9 + [ci] * 9 + [ctypes.c_float, ci, vp]
            outb = torch.empty_like(qb)

            def call():
                err = f(qb.data_ptr(), poolb.data_ptr(), None,
                        tabb.data_ptr(), segb.data_ptr(), posb.data_ptr(),
                        klenb.data_ptr(), None, outb.data_ptr(),
                        qb.shape[0], Hb, KVb, Db, 16, 1, mb, 32,
                        poolb.shape[0], Db ** -0.5, 1,
                        torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{key}: cudaError_t {err}")
            call()
            err, ok = cs._max_err(outb, wantb, 2e-2)
            if not ok:
                raise AssertionError(f"{key} {arch}: err {err}")
            ms = cs._time_ms(call, reps=50)
            res["body"].append({"bk": key[1], "stages": key[2],
                                "max_nwr": key[3], "shape": arch, "ms": ms})
            print(f"[sweep] body BK {key[1]} STAGES {key[2]} MAX_NWR "
                  f"{key[3]} {arch} timed shape: {ms:.4f} ms", flush=True)
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
