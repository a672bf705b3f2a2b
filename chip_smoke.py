#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (`src/repro_torch`) on one
NVIDIA H100.

    python3 chip_smoke.py [--out results.json] [--profile]

Phases, each of which raises (and so exits non-zero) on any failure:

  build    compile the port's CUDA kernels from `src/repro_torch/csrc`
           (one nvcc per source, in parallel) and print build seconds, the
           compiler's register / spill report, and the card's name and
           power limit as nvidia-smi gives them.
  kernels  hold each kernel against its plain PyTorch version on the card,
           in bf16 (atol = rtol = 2e-2) and f32 (atol = rtol = 2e-5, the
           repo's Pallas-vs-reference tolerance): flash prefill at
           llama2-7b (H = KV = 32, D = 128) and granite-3-2b (H = 32,
           KV = 8, D = 64) shapes with bucket-padded Sq 16 / 1024, ragged
           kv_len, and chunk-style q_offset > 0; paged decode at B = 1, 8,
           32 with power-of-two pad rows (kv_len = 0 on a trash block),
           BS = 16, MAXB a multiple of 8, contexts up to 4096. Then time
           each kernel at its main-path shape beside its plain version,
           one PyTorch library call where one computes the same function
           (scaled_dot_product_attention, a yardstick the port never
           calls), and its bound: the larger of bytes / 3.35 TB/s and
           flops / 989 TFLOP/s (H100 SXM data sheet, bf16 dense).
  serve    llama2-7b at full width and depth, bf16, random weights from a
           seeded generator on the card, served by the port's
           LayerKVEngine (exclusive prefill, policy 'layerkv',
           slo_aware off, 16-token blocks) with a device pool tight enough
           to force layer-wise offload and reload: 8 requests of 256-1024
           prompt tokens, 32 output tokens each, all arriving at t = 0.
           Kernel launch counts are zeroed just before this run and read
           just after it. Asserts every request finishes, offload and
           reload both happened, both kernels were launched, no logits
           went non-finite, and every first token equals a 'vllm' run on
           a pool that fits everything; prints the agreement share of
           the full token streams and wall-clock TTFT / TPOT / decode
           tokens per second.
  profile  (only with --profile) torch.profiler over a few decode-only
           steps of a vllm run at B = 8: wall and device-busy time per
           step, device ops per step, top device ops.

The line before the last is a JSON object {"kernels": [...]}, the last
line {"ok": true, "device": {...}}. Without a CUDA device, or without
the repository's `src/repro_torch` beside it, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
BF16_FLOPS_PER_S = 989e12      # H100 SXM data sheet, dense bf16
TOL = {"bfloat16": 2e-2, "float32": 2e-5}
FLASH_SHAPES = {"llama2-7b": (32, 32, 128), "granite-3-2b": (32, 8, 64)}


def _say(*a):
    print(*a, flush=True)


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


def _time_ms(fn, reps=20, warm=3):
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / reps


def _max_err(got, want, tol):
    """Max |got - want| and whether every element is within
    atol + rtol * |want| (atol = rtol = tol)."""
    d = (got.float() - want.float()).abs()
    ok = bool((d <= tol + tol * want.float().abs()).all())
    return float(d.max()), ok


# ------------------------------------------------------------------ build --

def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    secs = _build.build()
    _say(f"[build] {', '.join(f'{k} {v:.1f}s' for k, v in secs.items())} "
         f"(wall {time.perf_counter() - t0:.1f}s, parallel nvcc, sm_90a)")
    for name in _build.SOURCES:
        for line in _build.log_text(name).splitlines():
            if "registers" in line or "spill" in line:
                _say(f"[build] {name}: {line.strip()}")
    smi = _smi()
    _say(f"[build] nvidia-smi: {smi}")
    return smi


# ---------------------------------------------------------------- kernels --

def _flash_pairs(Sq, q_off, kv_len):
    """Causal (query, key) pairs a flash call must compute, per row."""
    n = 0
    for b, L in enumerate(kv_len):
        off = q_off[b]
        for i in range(Sq):
            n += max(0, min(off + i + 1, L))
    return n


def _flash_case(gen, H, KV, D, dtype, B, Sq, Skv, kv_len, q_off):
    import torch
    dev = "cuda"
    q = torch.randn(B, Sq, H, D, generator=gen, device=dev).to(dtype)
    k = torch.randn(B, Skv, KV, D, generator=gen, device=dev).to(dtype)
    v = torch.randn(B, Skv, KV, D, generator=gen, device=dev).to(dtype)
    lens = torch.tensor(kv_len, dtype=torch.int32, device=dev)
    off = q_off if isinstance(q_off, int) \
        else torch.tensor(q_off, dtype=torch.int32, device=dev)
    return q, k, v, lens, off


def check_flash(gen):
    import torch
    from repro_torch.kernels import flash_prefill as fp
    worst = {}
    for arch, (H, KV, D) in FLASH_SHAPES.items():
        for dtype in (torch.bfloat16, torch.float32):
            tol = TOL[str(dtype).split(".")[1]]
            cases = [
                ("prompt 11 in bucket 16", 1, 16, 16, [11], 0),
                ("ragged bucket 1024", 2, 1024, 1024, [1000, 617], 0),
                ("chunk q_offset 512", 1, 32, 1024, [544], 512),
                ("chunk per-row q_offset", 2, 32, 1024, [32, 732],
                 [0, 700]),
            ]
            for name, B, Sq, Skv, kv_len, q_off in cases:
                q, k, v, lens, off = _flash_case(gen, H, KV, D, dtype, B, Sq,
                                                 Skv, kv_len, q_off)
                got = fp.flash_attention(q, k, v, kv_len=lens, q_offset=off)
                want = fp.flash_attention_plain(q, k, v, kv_len=lens,
                                                q_offset=off)
                torch.cuda.synchronize()
                err, ok = _max_err(got, want, tol)
                _say(f"[kernels] flash {arch} {str(dtype)[6:]} {name}: "
                     f"max_abs_err {err:.3g} (tol {tol})")
                if not ok:
                    raise AssertionError(f"flash kernel disagrees: {arch} "
                                         f"{dtype} {name} err {err}")
                key = str(dtype)[6:]
                worst[key] = max(worst.get(key, 0.0), err)
    return worst


def _paged_case(gen, H, KV, D, dtype, B, n_real, BS=16, max_ctx=4096):
    """B rows, the first n_real with random contexts (one at max_ctx), the
    rest pow2 pad rows at kv_len 0 whose tables all point at the trash
    block (id NB - 1)."""
    import torch
    dev = "cuda"
    ctx = torch.randint(1, max_ctx + 1, (n_real,), generator=gen,
                        device=dev)
    ctx[0] = max_ctx
    maxb = -(-max_ctx // BS)
    MAXB = -(-maxb // 8) * 8
    NB = n_real * maxb + 1
    trash = NB - 1
    pool = torch.randn(NB, BS, 2, KV, D, generator=gen,
                       device=dev).to(dtype)
    perm = torch.randperm(NB - 1, generator=gen, device=dev)
    tab = torch.full((B, MAXB), trash, dtype=torch.int32, device=dev)
    tab[:n_real, :maxb] = perm[:n_real * maxb].reshape(n_real, maxb).int()
    lens = torch.zeros(B, dtype=torch.int32, device=dev)
    lens[:n_real] = ctx.int()
    q = torch.randn(B, H, D, generator=gen, device=dev).to(dtype)
    return q, pool, tab, lens


def check_paged(gen):
    import torch
    from repro_torch.kernels import paged_attention as pa
    worst = {}
    for arch, (H, KV, D) in FLASH_SHAPES.items():
        for dtype in (torch.bfloat16, torch.float32):
            tol = TOL[str(dtype).split(".")[1]]
            for B, n_real in ((1, 1), (8, 5), (32, 20)):
                q, pool, tab, lens = _paged_case(gen, H, KV, D, dtype, B,
                                                 n_real)
                got = pa.paged_attention(q, pool, tab, lens)
                want = pa.paged_attention_plain(q, pool, tab, lens)
                torch.cuda.synchronize()
                if not torch.isfinite(got).all():
                    raise AssertionError("paged kernel: non-finite output")
                err, ok = _max_err(got[:n_real], want[:n_real], tol)
                _say(f"[kernels] paged {arch} {str(dtype)[6:]} B={B} "
                     f"({B - n_real} pad rows): max_abs_err {err:.3g} "
                     f"(tol {tol})")
                if not ok:
                    raise AssertionError(f"paged kernel disagrees: {arch} "
                                         f"{dtype} B={B} err {err}")
                key = str(dtype)[6:]
                worst[key] = max(worst.get(key, 0.0), err)
                del q, pool, tab, lens, got, want
    return worst


def _prompts(vocab=32000, n=8, lo=256, hi=1024, seed=0):
    """The serve phase's prompts: n lengths in [lo, hi] (one at hi, a
    full 1024-token bucket), random token ids, from `seed`."""
    import numpy as np
    r = np.random.RandomState(seed)
    lens = [int(x) for x in r.randint(lo, hi + 1, n)]
    lens[0] = hi
    return [[int(t) for t in r.randint(0, vocab, L)] for L in lens]


def time_flash(gen):
    """llama2-7b prefill attention at the main path's largest bucket:
    one prompt of 1024 tokens, bf16."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_prefill as fp
    H, KV, D = FLASH_SHAPES["llama2-7b"]
    S = 1024
    q, k, v, lens, _ = _flash_case(gen, H, KV, D, torch.bfloat16, 1, S, S,
                                   [S], 0)
    ms = _time_ms(lambda: fp.flash_attention(q, k, v, kv_len=lens))
    plain = _time_ms(lambda: fp.flash_attention_plain(q, k, v, kv_len=lens),
                     reps=5)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))   # (B, H, S, D)
    lib = _time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True))
    nbytes = 4 * q.numel() * q.element_size() + lens.numel() * 4
    flops = 4 * D * H * _flash_pairs(S, [0], [S])
    return _bound(ms, plain, lib, nbytes, flops, BF16_FLOPS_PER_S,
                  f"B=1 Sq=Skv={S} H=KV={H} D={D} bf16 causal")


def time_paged(gen):
    """llama2-7b decode attention of one layer at the serve phase's batch:
    8 sequences at their prompt lengths + 16, bf16, BS 16."""
    import torch
    from repro_torch.kernels import paged_attention as pa
    H, KV, D = FLASH_SHAPES["llama2-7b"]
    BS = 16
    ctx = [len(p) + 16 for p in _prompts()]
    B = len(ctx)
    maxb = max(-(-c // BS) for c in ctx)
    MAXB = -(-maxb // 8) * 8
    NB = B * maxb + 1
    pool = torch.randn(NB, BS, 2, KV, D, generator=gen,
                       device="cuda").to(torch.bfloat16)
    perm = torch.randperm(NB - 1, generator=gen, device="cuda")
    tab = torch.full((B, MAXB), NB - 1, dtype=torch.int32, device="cuda")
    tab[:, :maxb] = perm[:B * maxb].reshape(B, maxb).int()
    lens = torch.tensor(ctx, dtype=torch.int32, device="cuda")
    q = torch.randn(B, H, D, generator=gen,
                    device="cuda").to(torch.bfloat16)
    ms = _time_ms(lambda: pa.paged_attention(q, pool, tab, lens))
    plain = _time_ms(lambda: pa.paged_attention_plain(q, pool, tab, lens),
                     reps=5)
    kv_bytes = sum(ctx) * 2 * KV * D * 2
    nbytes = kv_bytes + 2 * q.numel() * 2 + sum(
        -(-c // BS) for c in ctx) * 4 + B * 4
    flops = 4 * H * D * sum(ctx)
    return _bound(ms, plain, None, nbytes, flops, BF16_FLOPS_PER_S,
                  f"B={B} ctx {min(ctx)}-{max(ctx)} H=KV={H} D={D} bf16 "
                  f"BS={BS}")


def _bound(ms, plain, lib, nbytes, flops, peak, shape):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return {"ms": ms, "plain_ms": plain, "library_ms": lib,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops, "shape": shape}


def phase_kernels():
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    t0 = time.perf_counter()
    flash_err = check_flash(gen)
    paged_err = check_paged(gen)
    torch.cuda.empty_cache()
    flash_t = time_flash(gen)
    paged_t = time_paged(gen)
    for name, err, t in (("flash_attention", flash_err, flash_t),
                         ("paged_attention", paged_err, paged_t)):
        lib = "n/a" if t["library_ms"] is None \
            else f"{t['library_ms']:.4f}"
        _say(f"[kernels] {name} [{t['shape']}]: max_abs_err bf16 "
             f"{err['bfloat16']:.3g} f32 {err['float32']:.3g}, "
             f"kernel_ms {t['ms']:.4f} plain_ms {t['plain_ms']:.4f} "
             f"library_ms {lib} bound_ms {t['bound_ms']:.4f} "
             f"({t['bound_by']})")
    _say(f"[kernels] phase {time.perf_counter() - t0:.1f}s")
    return {"flash_attention": (flash_err, flash_t),
            "paged_attention": (paged_err, paged_t)}


# ------------------------------------------------------------------ serve --

def _serve(cfg, params, policy, ndb, nhb, prompts, out_len, seed):
    """Drive one engine through a ServingSession; returns (engine, done,
    wall stats)."""
    import torch
    from repro_torch.serving.engine import LayerKVEngine
    from repro_torch.serving.request import Request
    from repro_torch.serving.scheduler import ServeConfig
    from repro_torch.serving.session import ServingSession
    ec = ServeConfig.for_engine(policy=policy, slo_aware=False,
                                block_size=16, num_device_blocks=ndb,
                                num_host_blocks=nhb)
    eng = LayerKVEngine(cfg, params, ec, device="cuda", seed=seed)
    torch.cuda.synchronize()
    session = ServingSession(eng)
    handles = [session.submit(Request(rid=f"r{i}", prompt_len=len(p),
                                      output_len=out_len, arrival=0.0,
                                      prompt=p))
               for i, p in enumerate(prompts)]
    first, last, n_tok = {}, {}, {}
    decode_wall, steps = 0.0, 0
    t0 = time.perf_counter()
    while True:
        ts = time.perf_counter()
        firsts_before = len(first)
        if not session.step():
            break
        torch.cuda.synchronize()
        now = time.perf_counter()
        steps += 1
        for h in handles:
            new = h.take_new()
            if new:
                first.setdefault(h.rid, now)
                last[h.rid] = now
                n_tok[h.rid] = n_tok.get(h.rid, 0) + len(new)
        if len(first) == firsts_before:
            decode_wall += now - ts     # a step that only decoded
    wall = time.perf_counter() - t0
    done = session.drain()
    ttft = {rid: first[rid] - t0 for rid in first}
    tpot = {rid: (last[rid] - first[rid]) / max(n_tok[rid] - 1, 1)
            for rid in first}
    decode_tokens = sum(n - 1 for n in n_tok.values())
    return eng, done, {"wall_s": wall, "steps": steps, "ttft_s": ttft,
                       "tpot_s": tpot, "decode_tokens": decode_tokens,
                       "decode_wall_s": decode_wall}


def phase_serve(profile=False):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.kernels import paged_attention as pa
    cfg = get_config("llama2-7b")             # full width and depth, bf16
    prompts = _prompts(cfg.vocab_size)
    out_len = 32
    _say(f"[serve] llama2-7b L={cfg.n_layers} d={cfg.d_model} "
         f"H={cfg.n_heads} KV={cfg.n_kv_heads} bf16, {len(prompts)} "
         f"requests, prompts {sorted(len(p) for p in prompts)}, "
         f"{out_len} output tokens each")

    # ---- the main path: layerkv on a tight pool (counts zeroed first)
    fp.launches = 0
    pa.launches = 0
    t0 = time.perf_counter()
    eng, done, st = _serve(cfg, None, "layerkv", 4096, 16384, prompts,
                           out_len, seed=0)
    launches = {"flash_attention": fp.launches,
                "paged_attention": pa.launches}
    _say(f"[serve] layerkv: {len(done)} done in {st['wall_s']:.2f}s wall "
         f"({st['steps']} steps; setup+run {time.perf_counter() - t0:.1f}s)"
         f", launches {launches}")
    kinds = [x.kind for x in eng.off.ledger.log]
    n_off, n_rel = kinds.count("offload"), kinds.count("reload")
    _say(f"[serve] layerkv ledger: {n_off} offloads, {n_rel} reloads, "
         f"peak device memory "
         f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    if len(done) != len(prompts):
        raise AssertionError(f"only {len(done)} of {len(prompts)} finished")
    for r in done:
        if len(r.generated) != out_len or r.tokens_out != out_len:
            raise AssertionError(f"{r.rid}: {len(r.generated)} tokens, "
                                 f"expected {out_len}")
    if not (n_off > 0 and n_rel > 0):
        raise AssertionError("the pool did not force offload and reload")
    if not all(v > 0 for v in launches.values()):
        raise AssertionError(f"a kernel was never launched: {launches}")
    if eng.ex.nonfinite_logits():
        raise AssertionError("non-finite logits on the layerkv run")
    lk_tokens = {r.rid: list(r.generated) for r in done}
    params = eng.ex.params

    # ---- reference run: vllm on a pool that fits every request whole
    del eng, done
    eng_v, done_v, st_v = _serve(cfg, params, "vllm", 20000, 16, prompts,
                                 out_len, seed=0)
    if eng_v.ex.nonfinite_logits():
        raise AssertionError("non-finite logits on the vllm run")
    v_tokens = {r.rid: list(r.generated) for r in done_v}
    bad = [rid for rid in lk_tokens if lk_tokens[rid][0] != v_tokens[rid][0]]
    if bad:
        raise AssertionError(f"first tokens differ from vllm for {bad}")
    agree = sum(a == b for rid in lk_tokens
                for a, b in zip(lk_tokens[rid], v_tokens[rid]))
    total = sum(len(t) for t in lk_tokens.values())
    _say(f"[serve] first tokens identical to vllm for all "
         f"{len(lk_tokens)} requests; full-stream agreement "
         f"{agree}/{total} = {agree / total:.3f} (not asserted: bf16 decode "
         f"batches differ between policies)")
    for name, s in (("layerkv", st), ("vllm", st_v)):
        ttft = sorted(s["ttft_s"].values())
        tpot = sorted(s["tpot_s"].values())
        tps = s["decode_tokens"] / s["decode_wall_s"] \
            if s["decode_wall_s"] else float("nan")
        _say(f"[serve] {name} wall-clock: TTFT s "
             f"{[round(x, 4) for x in ttft]}; TPOT ms "
             f"{[round(x * 1e3, 2) for x in tpot]}; decode "
             f"{s['decode_tokens']} tokens in {s['decode_wall_s']:.3f}s of "
             f"decode-only steps = {tps:.1f} tok/s")
    serve = {"layerkv": st, "vllm": st_v, "offloads": n_off,
             "reloads": n_rel, "agreement": agree / total}
    if profile:
        del eng_v, done_v
        serve["profile"] = _profile_decode(cfg, params, prompts, out_len)
    return launches, serve


def _profile_decode(cfg, params, prompts, out_len, steps=4):
    """torch.profiler over `steps` decode-only steps of a vllm run (all
    requests resident, B = len(prompts)): wall per step, device-busy time
    and share, launches per step, and the top device ops."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    from repro_torch.serving.engine import LayerKVEngine
    from repro_torch.serving.request import Request
    from repro_torch.serving.scheduler import ServeConfig
    from repro_torch.serving.session import ServingSession
    ec = ServeConfig.for_engine(policy="vllm", slo_aware=False,
                                block_size=16, num_device_blocks=20000,
                                num_host_blocks=16)
    eng = LayerKVEngine(cfg, params, ec, device="cuda")
    session = ServingSession(eng)
    for i, p in enumerate(prompts):
        session.submit(Request(rid=f"p{i}", prompt_len=len(p),
                               output_len=out_len, arrival=0.0, prompt=p))
    for _ in range(3):              # the prefill step, then two warm decodes
        session.step()
    if len(eng.decoding) != len(prompts):
        raise AssertionError("profile window is not a full decode batch")
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            session.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = [e for e in prof.key_averages()
           if str(getattr(e, "device_type", "")).endswith("CUDA")]

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    busy_us = sum(dev_us(e) for e in dev)
    launches = sum(e.count for e in dev)
    top = sorted(dev, key=dev_us, reverse=True)[:10]
    out = {"steps": steps, "batch": len(prompts),
           "wall_ms_per_step": wall / steps * 1e3,
           "device_busy_ms_per_step": busy_us / steps / 1e3,
           "device_busy_share": busy_us / (wall * 1e6),
           "device_ops_per_step": launches / steps,
           "top": [(e.key, dev_us(e) / steps / 1e3, e.count // steps)
                   for e in top]}
    _say(f"[profile] vllm decode B={len(prompts)}: "
         f"{out['wall_ms_per_step']:.2f} ms wall/step, device busy "
         f"{out['device_busy_ms_per_step']:.2f} ms/step "
         f"({out['device_busy_share']:.3f}), "
         f"{out['device_ops_per_step']:.0f} device ops/step")
    for name, ms, n in out["top"]:
        _say(f"[profile]   {ms:8.3f} ms/step  x{n:<5d} {name[:90]}")
    return out


# ------------------------------------------------------------------- main --

REPLACES = {
    "flash_attention": ("src/repro_torch/csrc/flash_prefill.cu",
                        "src/repro/kernels/flash_prefill.py:83"),
    "paged_attention": ("src/repro_torch/csrc/paged_attention.cu",
                        "src/repro/kernels/paged_attention.py:73"),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write every number of the run here (JSON)")
    ap.add_argument("--profile", action="store_true",
                    help="after the serve phase, trace a few decode steps "
                         "with torch.profiler and print where they go")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "an NVIDIA GPU", file=sys.stderr)
        return 2
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: {src}/repro_torch not found; run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 means f32
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    smi = phase_build()
    kern = phase_kernels()
    launches, serve = phase_serve(profile=args.profile)

    rows = []
    for name, (err, t) in kern.items():
        src_path, replaces = REPLACES[name]
        rows.append({
            "name": name, "route": "cuda", "source": src_path,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err["bfloat16"],
            "max_abs_err_f32": err["float32"],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "shape": t["shape"]})
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"nvidia_smi": smi, "kernels": rows, "serve": serve,
                       "device": device,
                       "seconds": time.perf_counter() - t0}, f, indent=1,
                      default=str)
    _say(f"[done] {time.perf_counter() - t0:.1f}s")
    _say(smi)
    _say(json.dumps({"kernels": rows}))
    _say(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
