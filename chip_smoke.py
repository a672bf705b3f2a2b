#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (`src/repro_torch`) on one
NVIDIA H100.

    python3 chip_smoke.py [--out results.json] [--profile]

Phases, each of which raises (and so exits non-zero) on any failure:

  build    compile the port's CUDA kernels from `src/repro_torch/csrc`
           (one nvcc per source, in parallel) and print build seconds, the
           compiler's register / spill report and warnings, the count of
           tensor-core instructions (HGMMA = wgmma, HMMA = mma.sync) in
           the SASS of the two flash libraries (it fails if the forward
           has no HGMMA or the backward neither), and the card's name and
           power limit as nvidia-smi gives them.
  kernels  hold each kernel against its plain PyTorch version on the card,
           in bf16 (atol = rtol = 2e-2) and f32 (atol = rtol = 2e-5, the
           repo's Pallas-vs-reference tolerance): flash prefill at
           llama2-7b (H = KV = 32, D = 128) and granite-3-2b (H = 32,
           KV = 8, D = 64) shapes with bucket-padded Sq 16 / 1024, ragged
           kv_len, and chunk-style q_offset > 0, and at the edges of the
           bf16 kernel's 128 x 128 tiles with G = H / KV in {1, 4, 8} at
           D = 64 and 128 (Sq 1000 / Skv 1037, kv_len below one tile,
           per-row q_offset with kv_len across a tile, a window of 200);
           paged decode (one launch of the split kernel, whose last split
           block per row merges the row's splits) at B = 1, 8, 32 with
           power-of-two pad rows (kv_len = 0 on a trash block), BS = 16,
           MAXB a multiple of 8, contexts up to 4096, and at the split's
           edges, against the plain version and the plain split
           algorithm, batch-invariant bit for bit (each row of a batch of
           8 alone, and a second call), and the in-kernel merge against
           its plain version on the partials the launch left; paged
           prefill at the same two shapes and at G = 16 (H 32, KV 2, D
           128: 512 rows per tile), tq = 32, BS = 16, each call's body
           asserted on its route (bf16 at D 64 / 128 on the tensor-core
           kernel, f32 and D 32 on the CUDA-core one), on the cases
           of tests/test_fused.py (chunk edges, a chunk + decode tokens + a
           kv_len = 0 dummy, and the two-pool variant with the host pool
           pinned on the CPU and host ids above the device pool's size),
           and at the fused step's own layout and size (a 512-token chunk
           at offset 512 among one-token segments, a dummy slot and tail
           tiles, T = 1024, MAXB 64), one pool and two; for every two-pool
           case the staging (the copy engine on the side stream) writes
           exactly the live host blocks, each equal to its plain version,
           and the two-pool output equals the one-pool output on the same
           blocks bit for bit; RMSNorm forward
           against its plain version and its backward (dx, dw) against
           autograd through the plain version, and the flash backward
           (dq, dk, dv) against autograd through the plain flash
           attention, causal with GQA, each at the train path's shapes
           (B 4, S 1024; granite-3-2b: d 2048, H 32, KV 8, D 64) and at
           llama2-7b's serving shapes (the flash backward also off the
           64-row grid at q_offset 37, with a window, and at G in {1, 4,
           8} x D in {64, 128}), in bf16 and f32. Gradients are sums
           over rows or keys taken in another order, so their atol is
           the tolerance times the largest |gradient|.
           Then time each kernel at its main-path shape (the flash
           forward also at the train path's, paged decode also at B 1,
           ctx 4096; paged prefill, both variants, held once more against
           its plain version on the timed inputs, the two-pool call
           (staging from a host-side list of runs, then the body) split
           by kernel with torch.profiler, the staging alone on the side
           stream beside one copy_ of the same bytes from one pinned
           buffer, the staged blocks held against the plain staging,
           the tensor-core body also at granite-3-2b's heads and the
           CUDA-core body at the smoke paths' D = 32) with CUDA events
           around back-to-back calls that a spin kernel let the host
           enqueue first (device time, not the host's launch rate),
           beside its plain version, one PyTorch library call where one
           computes the same function (scaled_dot_product_attention,
           its backward with enable_gqa, F.rms_norm and its autograd
           backward: yardsticks the port never calls), and its bound:
           the larger of bytes / 3.35 TB/s and operations / the peak for
           their type (989 TFLOP/s bf16 dense for attention, 67 TFLOP/s
           f32 for the norm's elementwise math; H100 SXM data sheet).
           The RMSNorm forward is also timed at llama2-7b's serve shapes
           (1024 x 4096 prefill, 8 x 4096 decode), where the serve
           path's launches run.
  d32      every attention kernel (flash forward and backward, paged
           decode, paged prefill over one pool and two) against its plain
           version at head dim 32, the smoke configs' (granite-3-2b H 8
           KV 2, deepseek-moe-16b H 4 KV 4), in bf16 (the CUDA-core
           kernels, picked by shape) and f32, on the kernels phase's
           cases; the worst errors fold into the kernels' rows.
  smoke    the smoke configs (D = 32) through the engine on the card:
           granite-3-2b exclusive (serve-smoke) and fused (fused-smoke),
           deepseek-moe-16b fused (moe-smoke), each as `_serve_pair`
           drives the main paths below (launch counts zeroed before the
           layerkv run and read after it, first tokens equal vllm's).
  serve    llama2-7b at full width and depth, bf16, random weights from a
           seeded generator on the card, served by the port's
           LayerKVEngine (exclusive prefill, policy 'layerkv',
           slo_aware off, 16-token blocks) with a device pool tight enough
           to force layer-wise offload and reload: 8 requests of 256-1024
           prompt tokens, 32 output tokens each, all arriving at t = 0.
  fused    the same model, weights and prompts through the fused mixed
           step (chunked, fused, 512-token prefill budget): chunk rows on
           the paged-prefill kernel, over the pinned host pool for layers
           offloaded mid-prefill, decode rows on the paged decode kernel.
  moe      deepseek-moe-16b (arXiv:2401.06066) at full width and depth
           (28 layers, 64 routed experts top-6 + 2 shared), bf16, random
           weights made on the card after llama2-7b's are freed, through
           the fused step: 6 requests of 256-1024 tokens, 16 output tokens.
           Each of serve / fused / moe is a main path: kernel launch counts
           are zeroed just before its layerkv run and read just after it.
           Each asserts every request finishes, offload and reload both
           happened, its kernels were launched, no logits went non-finite,
           and every first token equals a 'vllm' run (same mode) on a pool
           that fits everything; fused and moe also assert a step ran with
           a host-tier chunk. Each prints the agreement share of the full
           token streams and wall-clock TTFT / TPOT / decode tokens per
           second.
  cluster  llama2-7b (the serve phase's weights, shared by both
           replicas: each engine gets the same tensors) served by a
           ClusterSession of two port engines behind the slo_aware router,
           in the fused mode with the fused path's prompts, each replica on
           a device pool tight enough to offload and read the host tier,
           with a FaultPlan that crashes replica 0 while it streams and
           revives it. Asserts every request finishes with all its tokens,
           every stream read with take_new equals the request's whole
           output (no gap, no repeat), one kill, a recovery and a
           re-dispatch, both replicas dispatched, offloaded and ran a
           host-tier chunk, the pools are back at baseline after
           drop_cache, the path's kernels launched, the first token of
           each request that started before the kill equals the fused
           run's, and the revived replica 0 serves one more request alone
           with the fused run's first token; prints the stream agreement
           with the fused run, wall TTFT / TPOT and decode tokens per
           second per replica. Launch counts are zeroed just before the
           cluster run and read just after it.
  train    granite-3-2b (hf:ibm-granite/granite-3.0-2b-base) at full
           width and depth, bf16, random weights from a seeded generator
           on the card, trained by the port's `train_loop.train` for a
           few AdamW steps on `SyntheticLM` batches of 4 x 1024 tokens,
           every block under activation checkpointing. Asserts every loss
           and grad norm is finite, the step-0 loss is within 1 of
           ln(vocab), and the RMSNorm and flash kernels ran forward and
           backward; prints the launches per step, step time, tokens/s
           and peak device memory. The serve, fused and moe paths also
           assert RMSNorm launches (every norm of the model runs it).
  train-moe  deepseek-moe-16b (arXiv:2401.06066) at full width (d 2048,
           16 heads of 128, 64 routed experts top-6 + 2 shared, d_expert
           1408, vocab 102400) with its depth cut to 4 of 28 layers
           (TRAIN_MOE), bf16, 5 AdamW steps of 4 x 1024 tokens through the
           MoE capacity-factor dispatch (capacity factor 1.25, C = 480),
           every block checkpointed. Asserts finite losses, grad norms and
           lb_loss, a step-0 ce within 1 of ln(vocab), 0 <= dropped_frac
           < 1, and the RMSNorm and flash kernels forward and backward
           (flash at D = 128, G = 1); prints step time, tokens/s, peak
           memory, lb_loss and dropped_frac. The kernels phase times the
           two flash kernels at this shape too (at_moe_train_shape).
  profile  (only with --profile) torch.profiler over a few decode-only
           steps of an exclusive vllm llama2-7b run at B = 8, over one
           more layerkv run of the fused path (the paged kernels' device
           time and launches, the two-pool calls apart, the side
           stream's staging copies with the share that overlaps compute
           kernels, and staging host calls, runs and host time per
           step), and over one
           train step after each of the train and train-moe phases: wall
           and device-busy time, device ops, top device ops.

The line before the last is a JSON object {"kernels": [...]}, the last
line {"ok": true, "device": {...}}. Without a CUDA device, or without
the repository's `src/repro_torch` beside it, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
BF16_FLOPS_PER_S = 989e12      # H100 SXM data sheet, dense bf16
PCIE_BYTES_PER_S = 64e9        # PCIe Gen5 x16, one direction (spec)
F32_FLOPS_PER_S = 67e12       # H100 SXM data sheet, f32 outside tensor cores
TOL = {"bfloat16": 2e-2, "float32": 2e-5}
FLASH_SHAPES = {"llama2-7b": (32, 32, 128), "granite-3-2b": (32, 8, 64)}
# (H, KV, D) that complete G = H / KV in {1, 4, 8} at D = 64 and 128 for
# the flash checks
FLASH_GQA_SHAPES = [(32, 32, 64), (32, 4, 64), (32, 8, 128), (32, 4, 128)]
# paged prefill's checks: FLASH_SHAPES and G = 16 (512 rows per 32-token
# tile, the kernel's largest group)
PP_SHAPES = {**FLASH_SHAPES, "G 16": (32, 2, 128)}
# the smoke configs' attention (D = 32: bf16 takes the CUDA-core kernels)
SMOKE_SHAPES = {"granite-3-2b smoke": (8, 2, 32),
                "deepseek-moe-16b smoke": (4, 4, 32)}
# the train path: model, steps, batch x sequence (tokens per step)
TRAIN = dict(arch="granite-3-2b", steps=5, batch=4, seq=1024)
# the MoE train path: deepseek-moe-16b at full width, its depth cut from
# 28 layers to `layers`, through the capacity-factor dispatch at the
# model's factor (moe.CAPACITY_FACTOR: C = 480 slots per expert at
# 4 x 1024 tokens)
TRAIN_MOE = dict(arch="deepseek-moe-16b", layers=4, steps=5, batch=4,
                 seq=1024)
# its attention (H = KV = 16, D = 128: G = 1)
MOE_TRAIN_ATTN = (16, 16, 128)
# RMSNorm shapes: the train path's activations, llama2-7b prefill / decode
NORM_SHAPES = {"train": (TRAIN["batch"], TRAIN["seq"], 2048),
               "llama2-7b prefill": (1, 1024, 4096),
               "llama2-7b decode": (8, 1, 4096)}


def _say(*a):
    print(*a, flush=True)


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


def _time_ms(fn, reps=20, warm=3):
    """Device milliseconds per call of `fn`: CUDA events around `reps`
    calls, after `warm` warm-up calls. A spin kernel holds the stream
    while the host enqueues the timed calls, so the events see them run
    back to back and a slow host's launch overhead does not stretch a
    short kernel's time (unless `fn` synchronises)."""
    import torch
    t0 = time.perf_counter()
    for _ in range(warm):
        fn()
    host_s = (time.perf_counter() - t0) / warm
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    # spin for ~1.5x the host's enqueue time of the timed calls (cycles
    # at up to 2 GHz), at most one second
    torch.cuda._sleep(int(min(1.5 * reps * host_s, 1.0) * 2e9))
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


def _max_err_grad(got, want, tol):
    """As `_max_err` for a gradient, a sum over rows or keys taken in
    another order: atol = tol * max |want|, rtol = tol. Returns (max
    |got - want|, ok, max |want|)."""
    d = (got.float() - want.float()).abs()
    w = want.float().abs()
    scale = float(w.max())
    return float(d.max()), bool((d <= tol * scale + tol * w).all()), scale


# ------------------------------------------------------------------ build --

def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    secs = _build.build()
    _say(f"[build] {', '.join(f'{k} {v:.1f}s' for k, v in secs.items())} "
         f"(wall {time.perf_counter() - t0:.1f}s, parallel nvcc, sm_90a)")
    for name in _build.SOURCES:
        for line in _build.log_text(name).splitlines():
            if "registers" in line or "spill" in line or "arning" in line:
                _say(f"[build] {name}: {line.strip()}")
    sass = {}
    for name in ("flash_prefill", "flash_backward", "paged_prefill"):
        sass[name] = _build.sass_counts(name)
        _say(f"[build] {name}: tensor-core instructions in its SASS "
             f"(cuobjdump -sass): {sass[name]}")
    if not sass["flash_prefill"]["HGMMA"]:
        raise AssertionError("the flash forward holds no HGMMA (wgmma)")
    for name in ("flash_backward", "paged_prefill"):
        if not any(sass[name].values()):
            raise AssertionError(f"{name} holds no HMMA / HGMMA")
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


def check_flash(gen, sizes=None):
    """The flash forward against its plain version: the engine's cases
    (bucket padding, ragged kv_len, chunk q_offset, scalar and per row)
    at both serving shapes, and the edges of the kernel's tiling (128
    query rows x 128 keys) at G = H / KV in {1, 4, 8} and D in {64, 128}:
    Sq and Skv off the tile grid, kv_len below one tile, per-row q_offset
    with kv_len across a tile boundary, and a sliding window; and the
    train-moe path's shape (B 4, S 1024, H = KV = 16, D 128). With
    `sizes` ({name: (H, KV, D)}), every case at those shapes only."""
    import torch
    from repro_torch.kernels import flash_prefill as fp
    worst = {}
    engine_cases = [
        ("prompt 11 in bucket 16", 1, 16, 16, [11], 0, 0),
        ("ragged bucket 1024", 2, 1024, 1024, [1000, 617], 0, 0),
        ("chunk q_offset 512", 1, 32, 1024, [544], 512, 0),
        ("chunk per-row q_offset", 2, 32, 1024, [32, 732], [0, 700], 0),
    ]
    edge_cases = [
        ("Sq 1000 Skv 1037 q_offset 37", 1, 1000, 1037, [1037], 37, 0),
        ("kv_len below one tile", 2, 200, 256, [5, 100], 0, 0),
        ("per-row q_offset, kv_len across a tile", 2, 96, 512, [200, 300],
         [104, 250], 0),
        ("window 200", 1, 1000, 1037, [1037], 37, 200),
    ]
    B, S = TRAIN_MOE["batch"], TRAIN_MOE["seq"]
    moe_train = [(f"train B {B} S {S}", B, S, S, [S] * B, 0, 0)]
    shapes = [(arch, hkd, engine_cases + edge_cases)
              for arch, hkd in (sizes or FLASH_SHAPES).items()]
    if sizes is None:
        shapes += [(f"G={H // KV} D={D}", (H, KV, D), edge_cases)
                   for H, KV, D in FLASH_GQA_SHAPES]
        shapes += [(TRAIN_MOE["arch"], MOE_TRAIN_ATTN, moe_train)]
    for arch, (H, KV, D), cases in shapes:
        for dtype in (torch.bfloat16, torch.float32):
            tol = TOL[str(dtype).split(".")[1]]
            for name, B, Sq, Skv, kv_len, q_off, window in cases:
                q, k, v, lens, off = _flash_case(gen, H, KV, D, dtype, B, Sq,
                                                 Skv, kv_len, q_off)
                got = fp.flash_attention(q, k, v, kv_len=lens, q_offset=off,
                                         window=window)
                want = fp.flash_attention_plain(q, k, v, kv_len=lens,
                                                q_offset=off, window=window)
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


def _paged_case(gen, H, KV, D, dtype, B, n_real, max_ctx=4096):
    """B rows, the first n_real with random contexts (one at max_ctx), the
    rest pow2 pad rows (`_paged_rows`)."""
    import torch
    ctx = torch.randint(1, max_ctx + 1, (n_real,), generator=gen,
                        device="cuda").tolist()
    ctx[0] = max_ctx
    return _paged_rows(gen, H, KV, D, dtype, ctx + [0] * (B - n_real))


def _paged_rows(gen, H, KV, D, dtype, lens, BS=16):
    """Decode inputs for rows at `lens` (kv_len 0 rows are pad rows on the
    trash block, id NB - 1), MAXB a multiple of 8."""
    import torch
    dev = "cuda"
    maxb = max(-(-max(lens) // BS), 1)
    MAXB = -(-maxb // 8) * 8
    B = len(lens)
    NB = B * maxb + 1
    pool = torch.randn(NB, BS, 2, KV, D, generator=gen,
                       device=dev).to(dtype)
    perm = torch.randperm(NB - 1, generator=gen, device=dev)
    tab = torch.full((B, MAXB), NB - 1, dtype=torch.int32, device=dev)
    tab[:, :maxb] = perm[:B * maxb].reshape(B, maxb).int()
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    tab[lens_t == 0] = NB - 1
    q = torch.randn(B, H, D, generator=gen, device=dev).to(dtype)
    return q, pool, tab, lens_t


def check_paged(gen, sizes=FLASH_SHAPES):
    """Paged decode (the split kernel, whose last split block per row
    merges the row's splits) against its plain version and the plain
    split algorithm: B = 1, 8, 32 with pow2 pad rows (kv_len 0 on a
    trash block) and contexts up to 4096, and rows at the split's edges;
    every row finite, pad rows 0. Batch invariance: each row of a batch
    of 8 has the same bits alone and in a repeated call. The in-kernel
    merge against its plain version (`combine_plain`) on the partials the
    same launch left. Returns the worst error per dtype."""
    import torch
    from repro_torch.kernels import paged_attention as pa
    SP = pa.SPLIT
    edges = [1, SP - 1, SP, SP + 1, 2 * SP - 1, 2 * SP, 2 * SP + 1, 4096, 0]
    worst = {}
    for arch, (H, KV, D) in sizes.items():
        for dtype in (torch.bfloat16, torch.float32):
            tol = TOL[str(dtype).split(".")[1]]
            key = str(dtype)[6:]
            cases = [(f"B={B} ({B - n} pad rows)",
                      _paged_case(gen, H, KV, D, dtype, B, n))
                     for B, n in ((1, 1), (8, 5), (32, 20))]
            cases.append(("split edges", _paged_rows(gen, H, KV, D, dtype,
                                                     edges)))
            for name, (q, pool, tab, lens) in cases:
                got = pa.paged_attention(q, pool, tab, lens)
                want = pa.paged_attention_plain(q, pool, tab, lens)
                split = pa.paged_attention_split_plain(q, pool, tab, lens)
                torch.cuda.synchronize()
                live = lens > 0
                if not torch.isfinite(got).all() or (got[~live] != 0).any():
                    raise AssertionError("paged kernel: non-finite output or "
                                         "a pad row not 0")
                err, ok = _max_err(got[live], want[live], tol)
                err2, ok2 = _max_err(got, split, tol)
                _say(f"[kernels] paged {arch} {key} {name}: max_abs_err "
                     f"{err:.3g}, against the plain split algorithm "
                     f"{err2:.3g} (tol {tol})")
                if not (ok and ok2):
                    raise AssertionError(f"paged kernel disagrees: {arch} "
                                         f"{dtype} {name} err {err} / {err2}")
                worst[key] = max(worst.get(key, 0.0), err, err2)
                del q, pool, tab, lens, got, want, split
            # batch invariance, and the merge on the launch's partials
            q, pool, tab, lens = _paged_rows(gen, H, KV, D, dtype,
                                             [1040, 281, 700, 4096, 513, 256,
                                              0, 17])
            full, part_o, part_ml = pa.split_pass(q, pool, tab, lens,
                                                  D ** -0.5)
            if not torch.equal(pa.paged_attention(q, pool, tab, lens), full):
                raise AssertionError(f"paged kernel differs between two "
                                     f"calls: {arch} {dtype}")
            for i in range(q.shape[0]):
                alone = pa.paged_attention(q[i:i + 1].contiguous(), pool,
                                           tab[i:i + 1].contiguous(),
                                           lens[i:i + 1].contiguous())
                if not torch.equal(alone[0], full[i]):
                    raise AssertionError(f"paged kernel is not batch "
                                         f"invariant: {arch} {dtype} row {i}")
            ctx = tab.shape[1] * 16
            rows = pa.n_splits(lens, ctx) > 1
            want = pa.combine_plain(part_o, part_ml,
                                    pa.n_splits(lens, ctx)).to(dtype)
            torch.cuda.synchronize()
            err, ok = _max_err(full[rows], want[rows], tol)
            _say(f"[kernels] paged {arch} {key}: batch-invariant (8 rows "
                 f"alone = in the batch = a second call, bit for bit); "
                 f"in-kernel merge max_abs_err {err:.3g} (tol {tol})")
            if not ok:
                raise AssertionError(f"paged merge disagrees: {arch} "
                                     f"{dtype} err {err}")
            worst[key] = max(worst.get(key, 0.0), err)
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
    """The flash forward, bf16 causal, at llama2-7b prefill attention at
    the main path's largest bucket (one prompt of 1024 tokens) and at the
    train path's shape (granite-3-2b, B 4, S 1024, GQA 4:1), each beside
    its plain version and scaled_dot_product_attention (enable_gqa at the
    train shape), and at the MoE train path's (deepseek-moe-16b, B 4,
    S 1024, H = KV = 16, D 128). Returns the serve shape's row with the
    train shapes' under "at_train_shape" and "at_moe_train_shape"."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_prefill as fp
    S = TRAIN["seq"]
    rows = []
    for (H, KV, D), B, lens_arg in ((FLASH_SHAPES["llama2-7b"], 1, True),
                                    (FLASH_SHAPES["granite-3-2b"],
                                     TRAIN["batch"], False),
                                    (MOE_TRAIN_ATTN, TRAIN_MOE["batch"],
                                     False)):
        q, k, v, lens, _ = _flash_case(gen, H, KV, D, torch.bfloat16, B, S,
                                       S, [S] * B, 0)
        lens = lens if lens_arg else None   # the train path passes none
        ms = _time_ms(lambda: fp.flash_attention(q, k, v, kv_len=lens))
        plain = _time_ms(lambda: fp.flash_attention_plain(
            q, k, v, kv_len=lens), reps=5)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))  # (B, H, S, D)
        lib = _time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=KV != H))
        nbytes = 2 * (q.numel() + k.numel()) * q.element_size() \
            + (lens.numel() * 4 if lens is not None else 0)
        flops = 4 * D * H * _flash_pairs(S, [0] * B, [S] * B)
        rows.append(_bound(ms, plain, lib, nbytes, flops, BF16_FLOPS_PER_S,
                           f"B={B} Sq=Skv={S} H={H} KV={KV} D={D} bf16 "
                           f"causal"))
        del q, k, v, qt, kt, vt
    rows[0]["at_train_shape"] = rows[1]
    rows[0]["at_moe_train_shape"] = rows[2]
    return rows[0]


def _decode_bound(ctx, H, KV, D, BS, B):
    """Bytes and operations of one decode call over contexts `ctx`, bf16:
    each live K/V row, q and out once, the live table entries and
    kv_len."""
    nbytes = sum(ctx) * 2 * KV * D * 2 + 2 * B * H * D * 2 \
        + sum(-(-c // BS) for c in ctx) * 4 + B * 4
    return nbytes, 4 * H * D * sum(ctx)


def time_paged(gen):
    """llama2-7b decode attention of one layer at the serve phase's batch
    (8 sequences at their prompt lengths + 16) and at B 1, ctx 4096, bf16,
    BS 16: one wrapper call (the split kernel, which merges a row's
    splits itself) beside the plain version. On a tree from before the
    merge was folded in (its module has `combine_pass`, as a parent
    checkout run by tools/paged_ab.py may), the separate combine kernel
    is also timed alone on the serve batch's partials ("combine_ms").
    Returns the decode row with "at_b1_ctx4096"."""
    import torch
    from repro_torch.kernels import paged_attention as pa
    H, KV, D = FLASH_SHAPES["llama2-7b"]
    BS = 16
    rows = []
    for ctx in ([len(p) + 16 for p in _prompts()], [4096]):
        q, pool, tab, lens = _paged_rows(gen, H, KV, D, torch.bfloat16, ctx)
        B = len(ctx)
        ms = _time_ms(lambda: pa.paged_attention(q, pool, tab, lens))
        plain = _time_ms(lambda: pa.paged_attention_plain(q, pool, tab,
                                                          lens), reps=5)
        nbytes, flops = _decode_bound(ctx, H, KV, D, BS, B)
        rows.append(_bound(ms, plain, None, nbytes, flops, BF16_FLOPS_PER_S,
                           f"B={B} ctx {min(ctx)}-{max(ctx)} H=KV={H} D={D} "
                           f"bf16 BS={BS}"))
        if B > 1 and hasattr(pa, "combine_pass"):
            out, part_o, part_ml = pa.split_pass(q, pool, tab, lens,
                                                 D ** -0.5)
            ctx_t = tab.shape[1] * BS
            rows[0]["combine_ms"] = _time_ms(lambda: pa.combine_pass(
                part_o, part_ml, lens, out, ctx_t))
        del q, pool, tab, lens
    rows[0]["at_b1_ctx4096"] = rows[1]
    rows[0]["note"] = ("one launch per call: the split kernel's last block "
                       "per row merges the row's splits (the separate "
                       "combine kernel is folded in)")
    return rows[0]


def _pp_batch(gen, H, KV, D, dtype, specs, tq=32, BS=16, tail=0):
    """A flat tq-padded batch of (q_offset, n_tokens) segments on the
    card, followed by `tail` tail tiles that map to the last segment slot
    with positions counting from 0, as `PagedExecutor.mixed_step` lays
    out its bucketed chunk part: (q, seg_ids, q_pos, kv_len, live row
    mask, MAXB). Tail rows are never live."""
    import torch
    dev = "cuda"
    pads = [-(-max(n, 1) // tq) * tq for _, n in specs]
    seg = torch.repeat_interleave(
        torch.arange(len(specs), dtype=torch.int32, device=dev),
        torch.tensor(pads, device=dev))
    pos = torch.cat([off + torch.arange(p, dtype=torch.int32, device=dev)
                     for (off, _), p in zip(specs, pads)])
    klen = torch.tensor([off + n for off, n in specs], dtype=torch.int32,
                        device=dev)
    live = klen[seg.long()] > 0
    if tail:
        seg = torch.cat([seg, torch.full((tail * tq,), len(specs) - 1,
                                         dtype=torch.int32, device=dev)])
        pos = torch.cat([pos, torch.arange(tail * tq, dtype=torch.int32,
                                           device=dev)])
        live = torch.cat([live, torch.zeros(tail * tq, dtype=torch.bool,
                                            device=dev)])
    maxb = max(8, -(-max(-(-int(k) // BS) for k in klen.tolist()) // 8) * 8)
    q = torch.randn(seg.numel(), H, D, generator=gen, device=dev).to(dtype)
    return q, seg, pos, klen, live, maxb


def _pp_route_call(route, fn):
    """Run `fn` (one paged_prefill call) and assert that its body ran on
    `route` ("mma": the tensor-core kernel, "fma": the CUDA-core one):
    one launch on that route's counter, none on the other's."""
    from repro_torch.kernels import paged_prefill as pp
    before = (pp.launches_mma, pp.launches_fma)
    out = fn()
    got = (pp.launches_mma - before[0], pp.launches_fma - before[1])
    if got != ((1, 0) if route == "mma" else (0, 1)):
        raise AssertionError(f"paged_prefill body: expected the {route} "
                             f"route, launches (mma, fma) {got}")
    return out


def check_paged_prefill(gen, sizes=PP_SHAPES):
    """The cases of tests/test_fused.py at the fused step's tile (tq =
    MIXED_TQ = 32) and block size (16): chunk edges one segment at a
    time, a chunk + decode tokens + a kv_len = 0 dummy in one call (live
    rows compared, every row finite), and the two-pool variant with the
    host pool pinned on the CPU and host ids above the device pool's
    size, at each of `sizes` ({name: (H, KV, D)}). For every two-pool
    case also: the staging (the copy engine) writes exactly the live host
    slots, each equal to its plain version (`_check_staging`), and the
    two-pool output equals the one-pool output over the same blocks bit
    for bit. Every
    call's body must take its route (`_pp_route_call`): the tensor-core
    kernel for bf16 at D 64 and 128, the CUDA-core one for f32 and for
    D 32. Returns the worst error per dtype for each variant, for each
    body route and for the staging."""
    import torch
    from repro_torch.kernels import paged_prefill as pp
    from repro_torch.serving.executor import MIXED_TQ as TQ
    BS = 16
    worst = {"paged_prefill": {}, "paged_prefill_tiered": {},
             "stage_host_blocks": {}, "paged_prefill_mma": {},
             "paged_prefill_fma": {}}
    for arch, (H, KV, D) in sizes.items():
        for dtype in (torch.bfloat16, torch.float32):
            tol = TOL[str(dtype).split(".")[1]]
            key = str(dtype)[6:]
            route = "mma" if dtype == torch.bfloat16 and D >= 64 else "fma"
            cases = [
                ("chunk straddling a block", [(29, 11)], None),
                ("block-aligned first chunk", [(0, 32)], None),
                ("single-token final chunk", [(47, 1)], None),
                ("mid-block start and end", [(5, 3)], None),
                ("chunk + 2 decodes + dummy",
                 [(9, 40), (300, 1), (170, 1), (0, 0)], None),
                ("two pools, host ids > device pool",
                 [(100, 60), (33, 17), (600, 1)], [True, False, True]),
            ]
            # the fused step's own layout at the main path's size: a
            # 512-token chunk at offset 512 (kv_len 1024, MAXB 64), two
            # one-token segments, a kv_len = 0 dummy slot, and 13 tail
            # tiles on that slot bucketing T to 1024; one pool and two
            big = [(512, 512), (1000, 1), (777, 1), (0, 0)]
            cases += [("fused layout T=1024, one pool", big, None),
                      ("fused layout T=1024, two pools", big,
                       [True, False, True, False])]
            for name, specs, tiers in cases:
                tail = 13 if specs is big else 0
                q, seg, pos, klen, live, maxb = _pp_batch(gen, H, KV, D,
                                                          dtype, specs,
                                                          tail=tail)
                S = len(specs)
                nb_dev = 8 if tiers else S * maxb
                dpool = torch.randn(nb_dev, BS, 2, KV, D, generator=gen,
                                    device="cuda").to(dtype)
                if tiers:
                    nb_host = 256
                    hpool = torch.randn(nb_host, BS, 2, KV, D, generator=gen,
                                        device="cuda").to(dtype).cpu() \
                        .pin_memory()
                    tier = torch.tensor(tiers, device="cuda")
                    lo = torch.where(tier, nb_dev, 0)[:, None]
                    hi = torch.where(tier, nb_host, nb_dev)[:, None]
                    u = torch.rand(S, maxb, generator=gen, device="cuda")
                    tab = (lo + (u * (hi - lo)).long()).int()
                    runs = pp.host_block_runs(tab.cpu(), klen.cpu(),
                                              tier.cpu(), BS, nb_host)
                    staged = torch.empty((S * maxb, BS, 2, KV, D),
                                         dtype=dtype, device="cuda")
                    variant = "paged_prefill_tiered"
                else:
                    tab = torch.randperm(nb_dev, generator=gen,
                                         device="cuda")[:S * maxb] \
                        .reshape(S, maxb).int()
                    variant = "paged_prefill"
                def call():
                    if not tiers:
                        return pp.paged_prefill(q, dpool, tab, seg, pos,
                                                klen, tq=TQ)
                    return staged_two_pool_call(
                        hpool, runs, staged, lambda: pp.paged_prefill(
                            q, dpool, tab, seg, pos, klen, tq=TQ,
                            staged=staged, tier=tier))
                got = _pp_route_call(route, call)
                want = pp.paged_prefill_plain(
                    q, dpool, tab, seg, pos, klen, tq=TQ,
                    **({"host_pool": hpool, "tier": tier} if tiers else {}))
                torch.cuda.synchronize()
                if not torch.isfinite(got).all():
                    raise AssertionError(f"{variant}: non-finite output")
                err, ok = _max_err(got[live], want[live], tol)
                _say(f"[kernels] {variant} {arch} {key} {name}: "
                     f"max_abs_err {err:.3g} (tol {tol})")
                if not ok:
                    raise AssertionError(f"{variant} kernel disagrees: "
                                         f"{arch} {dtype} {name} err {err}")
                for row in (variant, f"paged_prefill_{route}"):
                    worst[row][key] = max(worst[row].get(key, 0.0), err)
                if tiers:
                    n = _check_staging(hpool, tab, klen, tier)
                    same = torch.cat([dpool, hpool[nb_dev:].to("cuda")])
                    one = _pp_route_call(route, lambda: pp.paged_prefill(
                        q, same, tab, seg, pos, klen, tq=TQ))
                    torch.cuda.synchronize()
                    if not torch.equal(got, one):
                        raise AssertionError(f"two pools differ from one "
                                             f"pool on the same blocks: "
                                             f"{arch} {dtype} {name}")
                    _say(f"[kernels] {variant} {arch} {key} {name}: staged "
                         f"{n} live host blocks (= the plain version); "
                         f"bit-identical to one pool on the same blocks")
                    worst["stage_host_blocks"][key] = 0.0
    return worst


def _check_staging(hpool, tab, klen, tier, BS=16):
    """Stage the live host blocks (`host_block_runs`, then the copy
    engine on the side stream: `staged_two_pool_call`) into a NaN-filled
    buffer: the written slots must be exactly the live host slots, each
    equal to the plain version (torch.equal). Returns the number of
    blocks staged."""
    import torch
    from repro_torch.kernels import paged_prefill as pp
    S, MAXB = tab.shape
    buf = torch.full((S * MAXB, *hpool.shape[1:]), float("nan"),
                     dtype=hpool.dtype, device="cuda")
    runs = pp.host_block_runs(tab.cpu(), klen.cpu(), tier.cpu(), BS,
                              hpool.shape[0])
    got = staged_two_pool_call(hpool, runs, buf, lambda: buf)
    want = pp.stage_host_blocks_plain(hpool, tab, klen, tier)
    live = pp.live_host_slots(tab, klen, tier, BS).reshape(-1)
    torch.cuda.synchronize()
    written = ~got.reshape(S * MAXB, -1).isnan().all(dim=1)
    if not torch.equal(written, live):
        raise AssertionError(f"staging wrote {int(written.sum())} slots, "
                             f"{int(live.sum())} are live host blocks")
    if not torch.equal(got[live], want[live]):
        raise AssertionError("staged blocks differ from the plain version")
    return int(live.sum())


def _kernel_ms(fn, n=10):
    """Device milliseconds per call of each kernel `fn` launches, from
    torch.profiler over `n` calls after one more (`_trace`)."""
    fn()
    return {name[:80]: ms for name, ms, _ in _trace(fn, n, top=None)["top"]
            if ms}


def _time_pp_one_pool(gen, H, KV, D, dtype, C, off, route, BS=16):
    """One layer's chunk attention over the device pool: a C-token chunk
    at offset `off` (kv_len off + C), tq = MIXED_TQ, held against the
    plain version with its body on `route` asserted, then timed beside
    the plain version, with its bound. Returns the timing row."""
    import torch
    from repro_torch.kernels import paged_prefill as pp
    from repro_torch.serving.executor import MIXED_TQ as TQ
    q, seg, pos, klen, _, maxb = _pp_batch(gen, H, KV, D, dtype, [(off, C)])
    pool = torch.randn(4 * maxb, BS, 2, KV, D, generator=gen,
                       device="cuda").to(dtype)
    tab = torch.randperm(4 * maxb, generator=gen, device="cuda")[:maxb] \
        .reshape(1, maxb).int()
    got = _pp_route_call(route, lambda: pp.paged_prefill(
        q, pool, tab, seg, pos, klen, tq=TQ))
    want = pp.paged_prefill_plain(q, pool, tab, seg, pos, klen, tq=TQ)
    torch.cuda.synchronize()
    key = str(dtype)[6:]
    err, ok = _max_err(got, want, TOL[key])
    if not ok or not torch.isfinite(got).all():
        raise AssertionError(f"paged_prefill {route} disagrees: H {H} KV "
                             f"{KV} D {D} {key}, err {err}")
    esize = q.element_size()
    kvl = off + C
    nbytes = (2 * q.numel() + kvl * 2 * KV * D) * esize + maxb * 4 \
        + 2 * q.shape[0] * 4 + 4
    flops = 4 * D * H * _flash_pairs(C, [off], [kvl])
    t = _bound(_time_ms(lambda: pp.paged_prefill(q, pool, tab, seg, pos,
                                                 klen, tq=TQ)),
               _time_ms(lambda: pp.paged_prefill_plain(
                   q, pool, tab, seg, pos, klen, tq=TQ), reps=5),
               None, nbytes, flops, BF16_FLOPS_PER_S if esize == 2
               else F32_FLOPS_PER_S,
               f"T={C} at offset {off} (kv_len {kvl}) H={H} KV={KV} D={D} "
               f"{key} BS={BS} tq={TQ}")
    t["max_abs_err"] = err
    return t


def staged_two_pool_call(hpool, runs, staged, body):
    """One two-pool paged_prefill call composed as the executor issues it,
    from a host-side list of runs and with no host sync: the copy engine
    stages `runs` into `staged` on the side stream after the current
    stream's work, the current stream waits for it, then `body()` runs
    (the body reading `staged`). Returns body()'s result."""
    import torch
    from repro_torch.kernels import paged_prefill as pp
    main = torch.cuda.current_stream()
    side = pp.staging_stream(staged.device)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        pp.stage_host_runs(hpool, runs, staged)
    main.wait_stream(side)
    return body()


def time_paged_prefill(gen):
    """llama2-7b chunk attention of one layer at the fused path's shape:
    one 512-token chunk at offset 512 (kv_len 1024), bf16, BS 16, tq 32,
    over the device pool and, for the two-pool variant, over the same
    blocks in the pinned host pool. Each variant is held against its
    plain version, the two-pool output against the one-pool output bit
    for bit, the staged blocks against the plain staging
    (`_check_staging`, and the timed buffer's live slots), and each body
    call's route asserted (the tensor-core kernel). The two-pool call is
    timed as the executor issues it, from a host-side list of runs
    (`staged_two_pool_call`: staging on the side stream, then the body;
    no host sync inside the timed calls), and split by kernel with
    torch.profiler. The staging is also timed alone on the side stream,
    for the timed table (64 live blocks in random order) and for the same
    bytes as one run, beside the copy engine moving them from one
    contiguous pinned buffer (a copy_: a yardstick the port never calls).
    The tensor-core body is also
    timed at granite-3-2b's heads (H 32, KV 8, D 64) on the same chunk,
    and the CUDA-core body at the smoke paths' shape (granite-3-2b smoke,
    D 32, bf16: a 64-token chunk at offset 64). Returns the rows of
    paged_prefill, paged_prefill_tiered, stage_host_blocks and of the two
    body kernels, paged_prefill_mma and paged_prefill_fma."""
    import numpy as np
    import torch
    from repro_torch.kernels import paged_prefill as pp
    from repro_torch.serving.executor import MIXED_TQ as TQ
    H, KV, D = FLASH_SHAPES["llama2-7b"]
    BS, C, off = 16, 512, 512
    q, seg, pos, klen, _, maxb = _pp_batch(gen, H, KV, D, torch.bfloat16,
                                           [(off, C)])
    NB = 4 * maxb
    pool = torch.randn(NB, BS, 2, KV, D, generator=gen,
                       device="cuda").to(torch.bfloat16)
    tab = torch.randperm(NB, generator=gen, device="cuda")[:maxb] \
        .reshape(1, maxb).int()
    hpool = pool.cpu().pin_memory()
    tier = torch.ones(1, dtype=torch.bool, device="cuda")
    runs = pp.host_block_runs(tab.cpu(), klen.cpu(), tier.cpu(), BS, NB)
    staged = torch.empty((maxb, BS, 2, KV, D), dtype=torch.bfloat16,
                         device="cuda")
    kvl = off + C
    pairs = _flash_pairs(C, [off], [kvl])
    flops = 4 * D * H * pairs
    kv_bytes = kvl * 2 * KV * D * 2     # the live K/V: 64 whole blocks
    nbytes = 2 * q.numel() * 2 + kv_bytes + maxb * 4 + 2 * C * 4 + 4
    shape = (f"T={C} at offset {off} (kv_len {kvl}) H=KV={H} D={D} bf16 "
             f"BS={BS} tq={TQ}")
    out, one = {}, None

    def body(**kw):
        return pp.paged_prefill(q, pool, tab, seg, pos, klen, tq=TQ, **kw)

    def two_pool():
        return staged_two_pool_call(hpool, runs, staged, lambda: body(
            staged=staged, tier=tier))
    for name, kw in (("paged_prefill", {}),
                     ("paged_prefill_tiered",
                      {"host_pool": hpool, "tier": tier})):
        got = _pp_route_call("mma", two_pool if kw else body)
        want = pp.paged_prefill_plain(q, pool, tab, seg, pos, klen, tq=TQ,
                                      **kw)
        torch.cuda.synchronize()
        tol = TOL["bfloat16"]
        err, ok = _max_err(got, want, tol)
        _say(f"[kernels] {name} llama2-7b bfloat16 timed shape: "
             f"max_abs_err {err:.3g} (tol {tol})")
        if not ok or not torch.isfinite(got).all():
            raise AssertionError(f"{name} kernel disagrees at the timed "
                                 f"shape: err {err}")
        if one is None:
            one = got
        elif not torch.equal(got, one):
            raise AssertionError("two pools differ from one pool on the "
                                 "same blocks at the timed shape")
        del want
        ms = _time_ms(two_pool if kw else body)
        plain = _time_ms(lambda: pp.paged_prefill_plain(
            q, pool, tab, seg, pos, klen, tq=TQ, **kw), reps=5)
        t = _bound(ms, plain, None, nbytes, flops, BF16_FLOPS_PER_S,
                   shape + (" (K/V in the pinned host pool; staging from "
                            "a host-side list, then the body)"
                            if kw else ""))
        t["max_abs_err"] = err
        if kw:   # the same K/V bytes over PCIe Gen5 x16 (spec, one way)
            t["bound_ms_pcie"] = kv_bytes / PCIE_BYTES_PER_S * 1e3
            t["staged_blocks"] = _check_staging(hpool, tab, klen, tier)
            t["staged_bytes"] = t["staged_blocks"] * BS * 2 * KV * D * 2
            t["by_kernel_ms"] = _kernel_ms(two_pool)
        out[name] = t
    live = pp.live_host_slots(tab, klen, tier, BS).reshape(-1)
    torch.cuda.synchronize()
    if not torch.equal(staged[live], pp.stage_host_blocks_plain(
            hpool, tab, klen, tier)[live]):
        raise AssertionError("staged blocks differ from the plain version")
    _say(f"[kernels] paged_prefill_tiered at the timed shape: bit-identical "
         f"to one pool; staged {out['paged_prefill_tiered']['staged_blocks']}"
         f" blocks = {out['paged_prefill_tiered']['staged_bytes']} bytes "
         f"(the live K/V: {kv_bytes}) in {len(runs)} runs; by kernel "
         f"(profiler, ms/call): {out['paged_prefill_tiered']['by_kernel_ms']}")
    # the staging alone on the side stream, as the timed table's runs and
    # as one run of the same bytes, and the copy engine on one buffer
    src = torch.empty(kv_bytes // 2, dtype=torch.bfloat16).pin_memory()
    dst = torch.empty(kv_bytes // 2, dtype=torch.bfloat16, device="cuda")
    one_run = np.asarray([[0, 0, maxb]], np.int64)
    with torch.cuda.stream(pp.staging_stream(pool.device)):
        ce_ms = _time_ms(lambda: dst.copy_(src, non_blocking=True))
        st_ms = _time_ms(lambda: pp.stage_host_runs(hpool, runs, staged))
        one_ms = _time_ms(lambda: pp.stage_host_runs(hpool, one_run, staged))
    st = _bound(st_ms, _time_ms(lambda: pp.stage_host_blocks_plain(
                    hpool, tab, klen, tier), reps=5),
                ce_ms, 2 * kv_bytes + maxb * 4 + 8, 0, BF16_FLOPS_PER_S,
                f"{kvl // BS} live host blocks of {BS * 2 * KV * D * 2} "
                f"bytes (llama2-7b, bf16) to the device, {len(runs)} runs "
                f"(random table) in one copy-engine batch")
    st["bound_ms_pcie"] = kv_bytes / PCIE_BYTES_PER_S * 1e3
    st["one_run_ms"] = one_ms
    st["runs"] = len(runs)
    st["library_note"] = ("library_ms: copy_ of the same live bytes from "
                          "one contiguous pinned buffer (the copy engine)")
    _say(f"[kernels] stage_host_blocks at the timed shape (copy engine, "
         f"side stream): {st_ms:.4f} ms for {len(runs)} runs, {one_ms:.4f} "
         f"ms as one run, copy_ of one buffer {ce_ms:.4f} ms, bound over "
         f"PCIe {st['bound_ms_pcie']:.4f} ms")
    out["stage_host_blocks"] = st
    out["paged_prefill_tiered"]["copy_engine_ms"] = ce_ms
    # the body kernels: the one-pool call launches only the body
    out["paged_prefill_mma"] = dict(
        out["paged_prefill"], at_other_shapes=[_time_pp_one_pool(
            gen, *FLASH_SHAPES["granite-3-2b"], torch.bfloat16, C, off,
            "mma")])
    out["paged_prefill_fma"] = _time_pp_one_pool(
        gen, *SMOKE_SHAPES["granite-3-2b smoke"], torch.bfloat16, 64, 64,
        "fma")
    return out


def check_rmsnorm(gen):
    """RMSNorm forward against its plain version, and its backward (dx,
    dw) against autograd through the plain version, at NORM_SHAPES in
    bf16 and f32. Returns the worst errors per dtype of each."""
    import torch
    from repro_torch.kernels import rmsnorm as rn
    worst = {"rmsnorm": {}, "rmsnorm_bwd": {}}
    for name, shape in NORM_SHAPES.items():
        for dtype in (torch.bfloat16, torch.float32):
            key = str(dtype)[6:]
            tol = TOL[key]
            x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            w = (1 + 0.1 * torch.randn(shape[-1], generator=gen,
                                       device="cuda")).to(dtype)
            dy = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            errs = {}
            errs["rmsnorm"] = _max_err(rn.rmsnorm(x, w),
                                       rn.rmsnorm_plain(x, w), tol)
            grads = []
            for fn in (rn.rmsnorm, rn.rmsnorm_plain):
                xg, wg = (t.clone().requires_grad_() for t in (x, w))
                fn(xg, wg).backward(dy)
                grads.append((xg.grad, wg.grad))
            torch.cuda.synchronize()
            (gx, gw), (px, pw) = grads
            ex, ok_x, sx = _max_err_grad(gx, px, tol)
            ew, ok_w, sw = _max_err_grad(gw, pw, tol)
            errs["rmsnorm_bwd"] = (max(ex, ew), ok_x and ok_w)
            for kern, (err, ok) in errs.items():
                grad = (f", grad: dx {ex:.3g} of max |dx| {sx:.3g}, dw "
                        f"{ew:.3g} of max |dw| {sw:.3g}"
                        if kern.endswith("bwd") else "")
                _say(f"[kernels] {kern} {name} {tuple(shape)} {key}: "
                     f"max_abs_err {err:.3g} (tol {tol}{grad})")
                if not ok:
                    raise AssertionError(f"{kern} kernel disagrees: {name} "
                                         f"{dtype} err {err}")
                worst[kern][key] = max(worst[kern].get(key, 0.0), err)
    return worst


def _flash_grads(fn, q, k, v, do, **kw):
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    fn(*leaves, **kw).backward(do)
    return [t.grad for t in leaves]


def check_flash_bwd(gen, sizes=None):
    """The flash backward (dq, dk, dv) against autograd through the plain
    flash attention, causal: at the train path's shape (B 4, S 1024,
    granite-3-2b heads, GQA 4:1), the train-moe path's (B 4, S 1024,
    H = KV = 16, D 128) and llama2-7b's (B 1, S 1024), and at
    the edges of the kernels' tiling: Sq and Skv off the 64-row grid (a
    chunk at q_offset 37), a sliding window, and G in {1, 4, 8} at D in
    {64, 128}; bf16 and f32. With `sizes` ({name: (H, KV, D)}), B 1 S
    512 and the two edge cases at those shapes only. Returns the worst
    error per dtype."""
    import torch
    from repro_torch.kernels import flash_prefill as fp
    worst = {}
    S = TRAIN["seq"]
    gran, llama = FLASH_SHAPES["granite-3-2b"], FLASH_SHAPES["llama2-7b"]
    Sm = TRAIN_MOE["seq"]
    cases = [("train granite-3-2b", TRAIN["batch"], gran, S, S, 0, 0),
             ("train-moe deepseek-moe-16b", TRAIN_MOE["batch"],
              MOE_TRAIN_ATTN, Sm, Sm, 0, 0),
             ("llama2-7b", 1, llama, S, S, 0, 0),
             ("Sq 1000 Skv 1037 q_offset 37", 1, gran, 1000, 1037, 37, 0),
             ("window 200", 1, llama, 1000, 1037, 37, 200)]
    cases += [(f"G={H // KV} D={D}", 1, (H, KV, D), 512, 512, 0, 0)
              for H, KV, D in [gran, llama] + FLASH_GQA_SHAPES]
    if sizes is not None:
        cases = [c for name, hkd in sizes.items() for c in (
            (name, 1, hkd, 512, 512, 0, 0),
            (f"{name} Sq 1000 Skv 1037 q_offset 37", 1, hkd, 1000, 1037,
             37, 0),
            (f"{name} window 200", 1, hkd, 1000, 1037, 37, 200))]
    for name, B, (H, KV, D), Sq, Skv, q_off, window in cases:
        for dtype in (torch.bfloat16, torch.float32):
            key = str(dtype)[6:]
            tol = TOL[key]
            q, k, v, _, _ = _flash_case(gen, H, KV, D, dtype, B, Sq, Skv,
                                        [Skv], 0)
            do = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
            kw = dict(q_offset=q_off, window=window)
            got = _flash_grads(fp.flash_attention, q, k, v, do, **kw)
            want = _flash_grads(fp.flash_attention_plain, q, k, v, do, **kw)
            torch.cuda.synchronize()
            res = [_max_err_grad(g, p, tol) for g, p in zip(got, want)]
            err, ok = max(r[0] for r in res), all(r[1] for r in res)
            each = ", ".join(f"{n} {e:.3g} of max |{n}| {m:.3g}"
                             for n, (e, _, m) in zip(("dq", "dk", "dv"), res))
            _say(f"[kernels] flash_attention_bwd {name} B={B} Sq={Sq} "
                 f"Skv={Skv} H={H} KV={KV} D={D} {key} causal: max_abs_err "
                 f"{err:.3g} (tol {tol}, grad: {each})")
            if not ok:
                raise AssertionError(f"flash backward disagrees: {name} "
                                     f"{dtype} err {err}")
            worst[key] = max(worst.get(key, 0.0), err)
            del q, k, v, do, got, want
    return worst


def _norm_inputs(gen, shape):
    import torch
    d = shape[-1]
    x = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    w = (1 + 0.1 * torch.randn(d, generator=gen, device="cuda")) \
        .to(torch.bfloat16)
    return x, w, x.numel() // d, d


def time_rmsnorm_fwd(gen, shape):
    """The RMSNorm forward at `shape` (bf16) beside its plain version and
    F.rms_norm."""
    import torch.nn.functional as F
    from repro_torch.kernels import rmsnorm as rn
    x, w, rows, d = _norm_inputs(gen, shape)
    n = rows * d
    return _bound(
        _time_ms(lambda: rn.rmsnorm(x, w)),
        _time_ms(lambda: rn.rmsnorm_plain(x, w), reps=5),
        _time_ms(lambda: F.rms_norm(x, (d,), w, eps=1e-6)),
        2 * n * 2 + d * 2, 4 * n, F32_FLOPS_PER_S,
        f"{rows} rows x d={d} bf16")


def time_rmsnorm(gen):
    """RMSNorm at the train path's activations (4096 rows of 2048, bf16):
    the forward and the backward, each beside its plain version and
    F.rms_norm (forward; its autograd backward). The forward's row also
    holds its times at llama2-7b's serve shapes ("at_serve_shapes": a
    1024-token prefill and an 8-row decode step, 4096 wide), where the
    serve path's launches run."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import rmsnorm as rn
    fwd = time_rmsnorm_fwd(gen, NORM_SHAPES["train"])
    fwd["at_serve_shapes"] = [
        time_rmsnorm_fwd(gen, NORM_SHAPES[k])
        for k in ("llama2-7b prefill", "llama2-7b decode")]
    shape = NORM_SHAPES["train"]
    x, w, rows, d = _norm_inputs(gen, shape)
    n = rows * d
    dy = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    desc = f"{rows} rows x d={d} bf16"
    _, rstd = rn._forward(x, w, 1e-6, keep_rstd=True)

    def grad_ms(fn, reps):
        xg, wg = (t.clone().requires_grad_() for t in (x, w))
        y = fn(xg, wg)
        return _time_ms(lambda: torch.autograd.grad(
            y, (xg, wg), dy, retain_graph=True), reps=reps)
    bwd = _bound(
        _time_ms(lambda: rn.rmsnorm_bwd(dy, x, w, rstd)),
        grad_ms(rn.rmsnorm_plain, 5),
        grad_ms(lambda a, b: F.rms_norm(a, (d,), b, eps=1e-6), 20),
        3 * n * 2 + 2 * d * 2 + n // d * 4, 10 * n, F32_FLOPS_PER_S, desc)
    return fwd, bwd


def time_flash_bwd(gen):
    """The flash backward at the train path's shape (B 4, S 1024, H 32,
    KV 8, D 64, bf16, causal), beside autograd through the plain version
    and the backward of scaled_dot_product_attention with enable_gqa;
    the same at the MoE train path's shape (H = KV = 16, D 128) under
    "at_moe_train_shape"."""
    rows = [_time_flash_bwd_at(gen, *FLASH_SHAPES["granite-3-2b"],
                               TRAIN["batch"], TRAIN["seq"]),
            _time_flash_bwd_at(gen, *MOE_TRAIN_ATTN, TRAIN_MOE["batch"],
                               TRAIN_MOE["seq"])]
    rows[0]["at_moe_train_shape"] = rows[1]
    return rows[0]


def _time_flash_bwd_at(gen, H, KV, D, B, S):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_prefill as fp
    q, k, v, _, _ = _flash_case(gen, H, KV, D, torch.bfloat16, B, S, S,
                                [S] * B, 0)
    do = torch.randn(q.shape, generator=gen, device="cuda") \
        .to(torch.bfloat16)
    out, lse = fp._launch_fwd(q, k, v, True, 0, None, 0, D ** -0.5,
                              keep_lse=True)
    ms = _time_ms(lambda: fp.flash_attention_bwd(q, k, v, out, do, lse))

    def grad_ms(fn, leaves, g, reps):
        leaves = [t.clone().requires_grad_() for t in leaves]
        y = fn(*leaves)
        return _time_ms(lambda: torch.autograd.grad(
            y, leaves, g, retain_graph=True), reps=reps)
    plain = grad_ms(fp.flash_attention_plain, (q, k, v), do, 3)
    lib = grad_ms(lambda a, b, c: F.scaled_dot_product_attention(
        a, b, c, is_causal=True, enable_gqa=KV != H),
        [t.transpose(1, 2).contiguous() for t in (q, k, v)],
        do.transpose(1, 2).contiguous(), 20)
    nbytes = (4 * q.numel() + 4 * k.numel()) * 2 + lse.numel() * 4
    # five products of 2 * D operations per visible (query, key) pair:
    # S and dP recomputed, dV, dQ, dK
    flops = 10 * D * H * _flash_pairs(S, [0] * B, [S] * B)
    return _bound(ms, plain, lib, nbytes, flops, BF16_FLOPS_PER_S,
                  f"B={B} S={S} H={H} KV={KV} D={D} bf16 causal")


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
    pp_err = check_paged_prefill(gen)
    norm_err = check_rmsnorm(gen)
    fbwd_err = check_flash_bwd(gen)
    torch.cuda.empty_cache()
    flash_t = time_flash(gen)
    paged_t = time_paged(gen)
    pp_t = time_paged_prefill(gen)
    norm_t, norm_bwd_t = time_rmsnorm(gen)
    fbwd_t = time_flash_bwd(gen)
    torch.cuda.empty_cache()
    for name in ("paged_prefill", "paged_prefill_tiered",
                 "paged_prefill_mma", "paged_prefill_fma"):
        # the timed shapes' checks count too
        pp_err[name]["bfloat16"] = max(
            [pp_err[name].get("bfloat16", 0.0), pp_t[name]["max_abs_err"]]
            + [t["max_abs_err"] for t in pp_t[name].get("at_other_shapes",
                                                        [])])
    res = {"flash_attention": (flash_err, flash_t),
           "paged_attention": (paged_err, paged_t),
           "paged_prefill": (pp_err["paged_prefill"],
                             pp_t["paged_prefill"]),
           "paged_prefill_tiered": (pp_err["paged_prefill_tiered"],
                                    pp_t["paged_prefill_tiered"]),
           "stage_host_blocks": (pp_err["stage_host_blocks"],
                                 pp_t["stage_host_blocks"]),
           "paged_prefill_mma": (pp_err["paged_prefill_mma"],
                                 pp_t["paged_prefill_mma"]),
           "paged_prefill_fma": (pp_err["paged_prefill_fma"],
                                 pp_t["paged_prefill_fma"]),
           "rmsnorm": (norm_err["rmsnorm"], norm_t),
           "rmsnorm_bwd": (norm_err["rmsnorm_bwd"], norm_bwd_t),
           "flash_attention_bwd": (fbwd_err, fbwd_t)}
    def lib(t):
        return "none" if t["library_ms"] is None \
            else f"{t['library_ms']:.4f}"
    for name, (err, t) in res.items():
        errs = ", ".join(f"{k} {v:.3g}" for k, v in sorted(err.items()))
        _say(f"[kernels] {name} [{t['shape']}]: max_abs_err {errs}, "
             f"kernel_ms {t['ms']:.4f} plain_ms {t['plain_ms']:.4f} "
             f"library_ms {lib(t)} bound_ms {t['bound_ms']:.4f} "
             f"({t['bound_by']})")
        for also in [t[k] for k in ("at_train_shape", "at_moe_train_shape")
                     if k in t] + t.get("at_serve_shapes", []) \
                + t.get("at_other_shapes", []):
            _say(f"[kernels] {name} [{also['shape']}]: kernel_ms "
                 f"{also['ms']:.4f} plain_ms {also['plain_ms']:.4f} "
                 f"library_ms {lib(also)} bound_ms "
                 f"{also['bound_ms']:.4f} ({also['bound_by']})")
    b1 = paged_t["at_b1_ctx4096"]
    _say(f"[kernels] paged_attention [{b1['shape']}]: kernel_ms "
         f"{b1['ms']:.4f} plain_ms {b1['plain_ms']:.4f} bound_ms "
         f"{b1['bound_ms']:.4f} ({b1['bound_by']})")
    _say(f"[kernels] paged_attention: {paged_t['note']}")
    _say(f"[kernels] phase {time.perf_counter() - t0:.1f}s")
    return res


# ------------------------------------------------------------------ serve --

def _sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _serve(cfg, params, policy, ndb, nhb, prompts, out_len, seed,
           device="cuda", **ec_kw):
    """Drive one engine through a ServingSession; returns (engine, done,
    wall stats). `ec_kw` goes to ServeConfig (chunked / fused /
    max_prefill_tokens)."""
    from repro_torch.serving.engine import LayerKVEngine
    from repro_torch.serving.request import Request
    from repro_torch.serving.scheduler import ServeConfig
    from repro_torch.serving.session import ServingSession
    ec = ServeConfig.for_engine(policy=policy, slo_aware=False,
                                block_size=16, num_device_blocks=ndb,
                                num_host_blocks=nhb, **ec_kw)
    eng = LayerKVEngine(cfg, params, ec, device=device, seed=seed)
    _sync(device)
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
        _sync(device)
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


def _zero_launches():
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import paged_prefill as pp
    from repro_torch.kernels import rmsnorm as rn
    fp.launches = pa.launches = pp.launches = pp.launches_tiered = 0
    pp.launches_stage = pp.stage_runs = 0
    pp.stage_host_s = 0.0
    pp.launches_mma = pp.launches_fma = 0
    fp.launches_bwd = rn.launches = rn.launches_bwd = 0


def _launches():
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import paged_prefill as pp
    from repro_torch.kernels import rmsnorm as rn
    return {"flash_attention": fp.launches, "paged_attention": pa.launches,
            "paged_prefill": pp.launches,
            "paged_prefill_tiered": pp.launches_tiered,
            "stage_host_blocks": pp.launches_stage,
            "paged_prefill_mma": pp.launches_mma,
            "paged_prefill_fma": pp.launches_fma,
            "rmsnorm": rn.launches, "rmsnorm_bwd": rn.launches_bwd,
            "flash_attention_bwd": fp.launches_bwd}


def _staging(eng):
    """The staging counters since `_zero_launches` (the copy-engine runs
    and the host seconds of listing and issuing them) and the device
    bytes engine `eng`'s two staging buffers hold."""
    from repro_torch.kernels import paged_prefill as pp
    return {"staging_bytes": eng.ex.staging_bytes,
            "stage_runs": pp.stage_runs, "stage_host_s": pp.stage_host_s}


def _serve_pair(tag, cfg, params, prompts, out_len, kernels, ndb, nhb,
                ndb_ref, device="cuda", **ec_kw):
    """One main path and its reference. The main path is a layerkv run
    on a device pool of `ndb` blocks, tight enough to force layer-wise
    offload and reload, with every kernel launch count zeroed just before
    it and read just after it; the reference is a vllm run, same config,
    on a pool of `ndb_ref` blocks that fits every request whole. Asserts
    every request finishes with `out_len` tokens, offload and reload both
    happened, each kernel in `kernels` was launched, no logits went
    non-finite (either run), and every first token equals the
    reference's; prints the full-stream agreement and wall-clock TTFT /
    TPOT / decode tokens per second. Returns a result dict (tokens,
    stats, launches, params)."""
    import torch
    on_cuda = torch.device(device).type == "cuda"
    _zero_launches()
    t0 = time.perf_counter()
    eng, done, st = _serve(cfg, params, "layerkv", ndb, nhb, prompts,
                           out_len, seed=0, device=device, **ec_kw)
    launches = _launches()
    staging = _staging(eng)
    _say(f"[{tag}] layerkv: {len(done)} done in {st['wall_s']:.2f}s wall "
         f"({st['steps']} steps; setup+run {time.perf_counter() - t0:.1f}s)"
         f", launches {launches}; staging: {launches['stage_host_blocks']} "
         f"calls, {staging['stage_runs']} copy-engine runs, "
         f"{staging['stage_host_s'] * 1e3:.2f} ms host, staging buffers "
         f"{staging['staging_bytes']} bytes (both, kept)")
    kinds = [x.kind for x in eng.off.ledger.log]
    n_off, n_rel = kinds.count("offload"), kinds.count("reload")
    mem = (f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB"
           if on_cuda else "n/a (cpu)")
    _say(f"[{tag}] layerkv ledger: {n_off} offloads, {n_rel} reloads, "
         f"peak device memory {mem}")
    if len(done) != len(prompts):
        raise AssertionError(f"only {len(done)} of {len(prompts)} finished")
    for r in done:
        if len(r.generated) != out_len or r.tokens_out != out_len:
            raise AssertionError(f"{r.rid}: {len(r.generated)} tokens, "
                                 f"expected {out_len}")
    if not (n_off > 0 and n_rel > 0):
        raise AssertionError("the pool did not force offload and reload")
    if on_cuda and not all(launches[k] > 0 for k in kernels):
        raise AssertionError(f"a kernel was never launched: {launches}")
    if launches["stage_host_blocks"] != launches["paged_prefill_tiered"]:
        raise AssertionError(f"one staging call per two-pool body: "
                             f"{launches}")
    if launches["paged_prefill_mma"] + launches["paged_prefill_fma"] != \
            launches["paged_prefill"] + launches["paged_prefill_tiered"]:
        raise AssertionError(f"one body launch per paged_prefill call: "
                             f"{launches}")
    if eng.ex.nonfinite_logits():
        raise AssertionError("non-finite logits on the layerkv run")
    host_steps = sum(1 for fn, sig in eng.ex._jit_sigs
                     if fn == "mixed" and sig[-1])
    lk_tokens = {r.rid: list(r.generated) for r in done}
    params = eng.ex.params

    # ---- reference run: vllm on a pool that fits every request whole
    del eng, done
    eng_v, done_v, st_v = _serve(cfg, params, "vllm", ndb_ref, 16, prompts,
                                 out_len, seed=0, device=device, **ec_kw)
    if eng_v.ex.nonfinite_logits():
        raise AssertionError("non-finite logits on the vllm run")
    v_tokens = {r.rid: list(r.generated) for r in done_v}
    bad = [rid for rid in lk_tokens if lk_tokens[rid][0] != v_tokens[rid][0]]
    if bad:
        raise AssertionError(f"first tokens differ from vllm for {bad}")
    agree = sum(a == b for rid in lk_tokens
                for a, b in zip(lk_tokens[rid], v_tokens[rid]))
    total = sum(len(t) for t in lk_tokens.values())
    _say(f"[{tag}] first tokens identical to vllm for all "
         f"{len(lk_tokens)} requests; full-stream agreement "
         f"{agree}/{total} = {agree / total:.3f} (not asserted: bf16 decode "
         f"batches differ between policies)")
    for name, s in (("layerkv", st), ("vllm", st_v)):
        ttft = sorted(s["ttft_s"].values())
        tpot = sorted(s["tpot_s"].values())
        tps = s["decode_tokens"] / s["decode_wall_s"] \
            if s["decode_wall_s"] else float("nan")
        s["decode_tok_per_s"] = tps
        _say(f"[{tag}] {name} wall-clock: TTFT s "
             f"{[round(x, 4) for x in ttft]}; TPOT ms "
             f"{[round(x * 1e3, 2) for x in tpot]}; decode "
             f"{s['decode_tokens']} tokens in {s['decode_wall_s']:.3f}s of "
             f"decode-only steps = {tps:.1f} tok/s")
    return {"layerkv": st, "vllm": st_v, "offloads": n_off,
            "reloads": n_rel, "agreement": agree / total,
            "launches": launches, **staging,
            "host_tier_signatures": host_steps,
            "tokens": lk_tokens, "params": params}


# device blocks of the smoke paths' layerkv runs (2 layers, 16-token blocks)
SMOKE_NDB = 24
# The serving paths: model (its full config, or with `smoke` its smoke
# config), prompts (count, seed, and lengths when not 256-1024), output
# tokens, the device blocks of the layerkv run (tight: forces layer-wise
# offload and reload, and in fused mode chunks with host-resident layers)
# and of its vllm reference (fits everything), the engine mode, and the
# kernels the path must launch. serve / fused / moe are the main paths at
# full size; the *-smoke paths run the smoke configs, whose head dim is 32.
# tests/test_torch_chip_smoke.py dry-runs the scheduler on these settings.
PATHS = {
    "serve": dict(arch="llama2-7b", n=8, seed=0, out_len=32, ndb=4096,
                  ndb_ref=20000, nhb=16384, mode={},
                  kernels=("flash_attention", "paged_attention",
                           "rmsnorm")),
    "fused": dict(arch="llama2-7b", n=8, seed=0, out_len=32, ndb=4096,
                  ndb_ref=20000, nhb=16384,
                  mode=dict(chunked=True, fused=True,
                            max_prefill_tokens=512),
                  kernels=("paged_prefill", "paged_prefill_tiered",
                           "stage_host_blocks", "paged_prefill_mma",
                           "paged_attention", "rmsnorm")),
    "moe": dict(arch="deepseek-moe-16b", n=6, seed=1, out_len=16, ndb=2048,
                ndb_ref=20000, nhb=16384,
                mode=dict(chunked=True, fused=True, max_prefill_tokens=512),
                kernels=("paged_prefill", "paged_prefill_tiered",
                         "stage_host_blocks", "paged_prefill_mma",
                         "paged_attention", "rmsnorm")),
    "serve-smoke": dict(arch="granite-3-2b", smoke=True, n=6, seed=2,
                        prompt_lens=(40, 160), out_len=8, ndb=SMOKE_NDB,
                        ndb_ref=1024, nhb=1024, mode={},
                        kernels=("flash_attention", "paged_attention",
                                 "rmsnorm")),
    "fused-smoke": dict(arch="granite-3-2b", smoke=True, n=6, seed=2,
                        prompt_lens=(40, 160), out_len=8, ndb=SMOKE_NDB,
                        ndb_ref=1024, nhb=1024,
                        mode=dict(chunked=True, fused=True,
                                  max_prefill_tokens=64),
                        kernels=("paged_prefill", "paged_prefill_tiered",
                                 "stage_host_blocks", "paged_prefill_fma",
                                 "paged_attention", "rmsnorm")),
    # Eq. 4 keeps both layers of this 2-layer model on the device at these
    # prompts, so no chunk reads the host pool (fused-smoke's do)
    "moe-smoke": dict(arch="deepseek-moe-16b", smoke=True, n=6, seed=2,
                      prompt_lens=(40, 160), out_len=8, ndb=SMOKE_NDB,
                      ndb_ref=1024, nhb=1024,
                      mode=dict(chunked=True, fused=True,
                                max_prefill_tokens=64),
                      kernels=("paged_prefill", "paged_prefill_fma",
                               "paged_attention", "rmsnorm")),
}


def path_config(tag):
    """The model config of serving path `tag`: full width and depth, or
    the smoke config for the *-smoke paths."""
    from repro_torch.configs import get_config, get_smoke_config
    pc = PATHS[tag]
    return (get_smoke_config if pc.get("smoke") else get_config)(pc["arch"])


def _path_prompts(tag, cfg):
    pc = PATHS[tag]
    lo, hi = pc.get("prompt_lens", (256, 1024))
    return _prompts(cfg.vocab_size, n=pc["n"], lo=lo, hi=hi, seed=pc["seed"])


def _run_path(tag, cfg, params, device):
    """Drive path `tag` (settings from PATHS) through `_serve_pair`.
    Returns (result, prompts, out_len)."""
    pc = PATHS[tag]
    prompts = _path_prompts(tag, cfg)
    res = _serve_pair(tag, cfg, params, prompts, pc["out_len"],
                      pc["kernels"], pc["ndb"], pc["nhb"], pc["ndb_ref"],
                      device=device, **pc["mode"])
    if "paged_prefill_tiered" in pc["kernels"] \
            and not res["host_tier_signatures"]:
        raise AssertionError("no fused step ran with a host-tier chunk")
    return res, prompts, pc["out_len"]


def _describe(tag, cfg):
    pc = PATHS[tag]
    lens = sorted(len(p) for p in _path_prompts(tag, cfg))
    _say(f"[{tag}] {cfg.arch_id} L={cfg.n_layers} d={cfg.d_model} "
         f"H={cfg.n_heads} KV={cfg.n_kv_heads} {cfg.dtype}, {pc['n']} "
         f"requests, prompts {lens}, {pc['out_len']} output tokens each, "
         f"mode {pc['mode'] or 'exclusive prefill'}")


def phase_head_dim_32():
    """Every attention kernel against its plain version at D = 32, the
    smoke configs' head dim (granite-3-2b H 8 KV 2, deepseek-moe-16b H 4
    KV 4), in bf16 (the CUDA-core kernels, which the dispatch picks by
    shape) and f32, on the kernels phase's cases. Returns the worst
    error per kernel and dtype."""
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    t0 = time.perf_counter()
    pp = check_paged_prefill(gen, SMOKE_SHAPES)
    paged = check_paged(gen, SMOKE_SHAPES)
    worst = {"flash_attention": check_flash(gen, SMOKE_SHAPES),
             "paged_attention": paged,
             "paged_prefill": pp["paged_prefill"],
             "paged_prefill_tiered": pp["paged_prefill_tiered"],
             "stage_host_blocks": pp["stage_host_blocks"],
             "paged_prefill_fma": pp["paged_prefill_fma"],
             "flash_attention_bwd": check_flash_bwd(gen, SMOKE_SHAPES)}
    for name, err in worst.items():
        _say(f"[d32] {name}: max_abs_err bf16 {err['bfloat16']:.3g} f32 "
             f"{err['float32']:.3g}")
    _say(f"[d32] phase {time.perf_counter() - t0:.1f}s")
    return worst


def phase_smoke():
    """The smoke configs (head dim 32) through the engine on the card:
    granite-3-2b exclusive and fused, deepseek-moe-16b fused, each a
    layerkv run on a tight pool against vllm, random weights from a
    seed. Every path kernel must launch and first tokens must equal
    vllm's (`_serve_pair`)."""
    out = {}
    for tag in ("serve-smoke", "fused-smoke", "moe-smoke"):
        cfg = path_config(tag)
        _describe(tag, cfg)
        res, _, _ = _run_path(tag, cfg, None, "cuda")
        res.pop("params")
        out[tag] = res
    return out


def phase_serve(profile=False):
    """llama2-7b, exclusive prefill (flash prefill + paged decode)."""
    from repro_torch.configs import get_config
    cfg = get_config(PATHS["serve"]["arch"])   # full width and depth, bf16
    _describe("serve", cfg)
    res, prompts, out_len = _run_path("serve", cfg, None, "cuda")
    if profile:
        res["profile"] = _profile_decode(cfg, res["params"], prompts,
                                         out_len)
    return res


def phase_fused(params, excl_tokens, profile=False):
    """llama2-7b through the fused mixed step with the serve phase's
    weights and prompts: paged prefill over one pool and over two (chunks
    with host-resident layers), paged decode for the decode rows. With
    `profile`, one more layerkv run under torch.profiler
    (`_profile_run`)."""
    from repro_torch.configs import get_config
    cfg = get_config(PATHS["fused"]["arch"])
    _describe("fused", cfg)
    res, prompts, _ = _run_path("fused", cfg, params, "cuda")
    if profile:
        res["profile"] = _profile_run(cfg, res["params"], "fused", prompts)
    agree = sum(a == b for rid, t in res["tokens"].items()
                for a, b in zip(t, excl_tokens[rid]))
    total = sum(len(t) for t in res["tokens"].values())
    _say(f"[fused] agreement with the exclusive-prefill layerkv run: "
         f"{agree}/{total} = {agree / total:.3f} (not asserted)")
    res["agreement_exclusive"] = agree / total
    return res


def phase_moe():
    """deepseek-moe-16b (arXiv:2401.06066) at full width and depth, bf16,
    random weights from a seeded generator on the card, served through
    the fused mixed step: MoE FFN (dropless, grouped by expert), paged
    prefill over one and two pools, paged decode."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import flatten_params
    cfg = get_config(PATHS["moe"]["arch"])
    m = cfg.moe
    _describe("moe", cfg)
    _say(f"[moe] {m.n_experts} routed experts top-{m.top_k} + "
         f"{m.n_shared} shared, d_expert={m.d_expert}, vocab "
         f"{cfg.vocab_size}")
    res, _, _ = _run_path("moe", cfg, None, "cuda")
    n = sum(t.numel() for t in flatten_params(res["params"]).values())
    _say(f"[moe] {n / 1e9:.2f} B parameters")
    res["n_params"] = n
    return res


# The cluster path: llama2-7b at full width and depth, the fused path's
# prompts and mode, `replicas` engines sharing one set of weights behind
# the `router`, each with a device pool of `ndb` blocks (tight: each
# replica offloads and runs host-tier chunks; a 1024-token request needs
# 66 x 32 = 2112 blocks to decode, so half the fused path's 4096 would
# wedge) and `nhb` host blocks (the replica that takes the whole load
# runs its host pool short mid-eviction: the partial eviction of ROADMAP
# C6), and a crash of replica 0 at a virtual time when it has streamed
# tokens of live requests, revived `recover` seconds later (the
# FaultPlan grammar of serving/faults.py).
# tests/test_torch_chip_smoke.py dry-runs it on the CPU.
CLUSTER = dict(arch="llama2-7b", prompts="fused", replicas=2,
               router="slo_aware", ndb=2304, nhb=8192,
               fault="crash@0.06:r0:recover=0.05",
               kernels=PATHS["fused"]["kernels"])


def _run_cluster(cfg, params, device, ref_tokens=None):
    """Drive the cluster path (settings from CLUSTER) through a
    `ClusterSession` of port engines that share `params` (or the first
    engine's seeded weights), with every kernel launch count zeroed just
    before the run and read just after it. Asserts every request
    finishes with all its tokens; every stream read with `take_new`
    equals the request's whole output (the tokens a restart folded into
    its prompt, then `generated`); one kill, a recovery and a
    re-dispatch, the kill hitting replica 0 while it held streamed
    tokens; every replica dispatched work, offloaded, and ran a fused
    step with a host-tier chunk; no logits went non-finite; after
    `drop_cache` every pool is back at its baseline; on CUDA the path's
    kernels launched; and, given `ref_tokens` (the single-engine fused
    run's), each request whose first token came before the kill has the
    reference's first token. Then one more request goes through the
    cluster, whose router must place it on the revived, idle replica 0;
    it must finish there with a whole stream, every replica must have
    served a request, and its first token must equal the reference's.
    Prints the stream agreement with `ref_tokens` (not asserted) and
    wall TTFT / TPOT and decode tokens per second per replica. Returns a
    result dict."""
    import torch
    from repro_torch.core import DEVICE, HOST
    from repro_torch.serving.cluster import ClusterSession
    from repro_torch.serving.engine import LayerKVEngine
    from repro_torch.serving.faults import FaultPlan
    from repro_torch.serving.request import Request
    from repro_torch.serving.scheduler import ServeConfig
    pc = CLUSTER
    prompts = _path_prompts(pc["prompts"], cfg)
    out_len = PATHS[pc["prompts"]]["out_len"]
    R = pc["replicas"]
    ec = ServeConfig.for_engine(policy="layerkv", slo_aware=False,
                                block_size=16, num_device_blocks=pc["ndb"],
                                num_host_blocks=pc["nhb"],
                                **PATHS[pc["prompts"]]["mode"])
    engines = [LayerKVEngine(cfg, params, ec, device=device, seed=0)]
    engines += [LayerKVEngine(cfg, engines[0].ex.params, ec, device=device)
                for _ in range(R - 1)]
    plan = FaultPlan.parse(pc["fault"], n_replicas=R)
    cl = ClusterSession(engines, router=pc["router"], fault_plan=plan)
    handles = [cl.submit(Request(rid=f"r{i}", prompt_len=len(p),
                                 output_len=out_len, arrival=0.0, prompt=p))
               for i, p in enumerate(prompts)]
    _sync(device)
    streams = {h.rid: [] for h in handles}
    first, last, before_kill = {}, {}, set()
    dec_wall, dec_tok = [0.0] * R, [0] * R
    _zero_launches()
    t0 = time.perf_counter()
    while True:
        steps = [s.steps for s in cl.stats]
        ts = time.perf_counter()
        n_first = len(first)
        if not cl.step():
            break
        _sync(device)
        now = time.perf_counter()
        stepped = [i for i in range(R) if cl.stats[i].steps != steps[i]]
        n_new = 0
        for h in handles:
            new = h.take_new()
            if new:
                if h.rid not in first and not cl.n_kills:
                    before_kill.add(h.rid)
                first.setdefault(h.rid, now)
                last[h.rid] = now
                streams[h.rid] += new
                n_new += len(new)
        if len(stepped) == 1 and len(first) == n_first and n_new:
            dec_wall[stepped[0]] += now - ts    # a step that only decoded
            dec_tok[stepped[0]] += n_new
    wall = time.perf_counter() - t0
    launches = _launches()
    done = cl.drain()
    _say(f"[cluster] {len(done)} done in {wall:.2f}s wall, launches "
         f"{launches}")
    for line in cl.recovery_log:
        _say(f"[cluster]   {line}")
    if len(done) != len(prompts):
        raise AssertionError(f"only {len(done)} of {len(prompts)} finished")
    for h, p in zip(handles, prompts):
        # a restart folds the tokens its dead incarnation streamed into
        # the prompt: the request's whole output is that tail + generated
        r = h.request
        whole = r.prompt[len(p):] + r.generated
        if len(whole) != out_len or streams[h.rid] != whole:
            raise AssertionError(
                f"{h.rid}: streamed {len(streams[h.rid])} tokens, "
                f"generated {len(whole)} of {out_len}, equal "
                f"{streams[h.rid] == whole}")
    n_red = len(cl.redispatch_priorities)
    if not (cl.n_kills == 1 and cl.n_recoveries >= 1 and n_red >= 1):
        raise AssertionError(f"kills {cl.n_kills}, recoveries "
                             f"{cl.n_recoveries}, re-dispatched {n_red}")
    salvaged = {h.rid: h.request.tokens_salvaged for h in handles
                if h.request.tokens_salvaged}
    if not salvaged:
        raise AssertionError("the crash hit no streamed tokens")
    per = []
    for i, (eng, st) in enumerate(zip(engines, cl.stats)):
        kinds = [x.kind for x in eng.off.ledger.log]
        host = sum(1 for fn, sig in eng.ex._jit_sigs
                   if fn == "mixed" and sig[-1])
        per.append({"dispatched": st.dispatched, "served": len(eng.core.done),
                    "steps": st.steps, "offloads": kinds.count("offload"),
                    "reloads": kinds.count("reload"),
                    "host_tier_signatures": host,
                    "partial_evictions":
                        eng.core.registry.total("partial_evictions"),
                    "decode_tokens": dec_tok[i], "decode_wall_s": dec_wall[i],
                    "decode_tok_per_s": dec_tok[i] / dec_wall[i]
                    if dec_wall[i] else float("nan")})
        _say(f"[cluster] replica {i}: {per[-1]}")
        if not (st.dispatched and per[-1]["offloads"] and host):
            raise AssertionError(f"replica {i} did not dispatch, offload "
                                 f"and run a host-tier chunk: {per[-1]}")
        if eng.ex.nonfinite_logits():
            raise AssertionError(f"non-finite logits on replica {i}")
    if torch.device(device).type == "cuda" \
            and not all(launches[k] > 0 for k in pc["kernels"]):
        raise AssertionError(f"a kernel was never launched: {launches}")
    for eng in engines:
        eng.bm.drop_cache()
        eng.bm.check()
        for tier in (DEVICE, HOST):
            if eng.bm.num_free(tier) != eng.bm.pools[tier].num_blocks:
                raise AssertionError(f"{tier} pool not back at baseline")
    res = {"wall_s": wall, "launches": launches, "replicas": per,
           "n_kills": cl.n_kills, "n_recoveries": cl.n_recoveries,
           "redispatched": n_red, "salvaged": salvaged,
           "recovery_log": list(cl.recovery_log),
           "first_before_kill": sorted(before_kill),
           "routed": {h.rid: h.replica for h in handles},
           "tokens": dict(streams),
           "ttft_s": {rid: first[rid] - t0 for rid in first},
           "tpot_s": {rid: (last[rid] - first[rid])
                      / max(len(streams[rid]) - 1, 1) for rid in first}}
    _say(f"[cluster] wall-clock: TTFT s "
         f"{[round(x, 4) for x in sorted(res['ttft_s'].values())]}; TPOT "
         f"ms {[round(x * 1e3, 2) for x in sorted(res['tpot_s'].values())]}")
    # the revived replica's executor serves again through the cluster
    # (its pools and staging buffers survived; only its block manager
    # state was reset): with both replicas idle, slo_aware breaks the tie
    # toward replica 0
    late = min(range(len(prompts)), key=lambda i: len(prompts[i]))
    hl = cl.submit(Request(rid="late", prompt_len=len(prompts[late]),
                           output_len=2, arrival=0.0, prompt=prompts[late]))
    cl.drain()
    late_tok = hl.take_new()
    served = [len(eng.core.done) for eng in engines]
    _say(f"[cluster] late request on replica {hl.replica}: tokens "
         f"{late_tok}; served per replica {served}")
    if hl.replica != 0 or late_tok != hl.request.generated \
            or len(late_tok) != 2 or not all(served):
        raise AssertionError(f"the revived replica 0 did not serve the late"
                             f" request: replica {hl.replica}, tokens "
                             f"{late_tok}, served per replica {served}")
    for eng in engines:
        eng.bm.drop_cache()
        eng.bm.check()
    res["revived_first_token"] = late_tok[0]
    res["late_replica"] = hl.replica
    res["served"] = served
    if ref_tokens is not None:
        bad = [rid for rid in before_kill
               if streams[rid][0] != ref_tokens[rid][0]]
        if late_tok[0] != ref_tokens[f"r{late}"][0]:
            bad.append(f"late (r{late} on the revived replica 0)")
        if bad:
            raise AssertionError(f"first tokens differ from the fused "
                                 f"run's for {bad}")
        agree = sum(a == b for rid, t in streams.items()
                    for a, b in zip(t, ref_tokens[rid]))
        total = sum(len(t) for t in streams.values())
        res["agreement_fused"] = agree / total
        _say(f"[cluster] first tokens equal the fused run's for the "
             f"{len(before_kill)} requests that started before the kill "
             f"and for r{late} served again by the revived replica 0; "
             f"full-stream agreement {agree}/{total} = {agree / total:.3f}"
             f" (not asserted: bf16, another batch mix)")
    return res


def phase_cluster(params, fused_tokens):
    """llama2-7b served by two replicas that share the serve phase's
    weights, the fused mode and prompts, a crash of replica 0 mid-stream
    and its recovery (`_run_cluster`)."""
    import torch
    from repro_torch.configs import get_config
    cfg = get_config(CLUSTER["arch"])
    pc = CLUSTER
    _say(f"[cluster] {cfg.arch_id} L={cfg.n_layers} d={cfg.d_model} "
         f"{cfg.dtype}, {pc['replicas']} replicas sharing one set of "
         f"weights, router {pc['router']}, {pc['ndb']} device / "
         f"{pc['nhb']} host blocks each, fault plan {pc['fault']!r}, the "
         f"{pc['prompts']} path's prompts and mode")
    _say(f"[cluster] device memory in use before: "
         f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    return _run_cluster(cfg, params, "cuda", ref_tokens=fused_tokens)


def _dense_params(cfg):
    """Parameter count of a dense decoder (`DecoderModel._init`)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    attn = d * cfg.n_q_heads * hd * 2 + d * cfg.n_kv_heads * hd * 2
    layer = attn + 3 * d * cfg.d_ff + 2 * d
    head = 0 if cfg.tie_embeddings else d * cfg.padded_vocab
    return cfg.padded_vocab * d + cfg.n_layers * layer + d + head


def phase_train(profile=False):
    """granite-3-2b at full width and depth, bf16, trained for
    TRAIN["steps"] AdamW steps by the port's `train_loop.train` from
    random weights (a seeded generator on the card) on SyntheticLM
    batches: the kernels' launch counts are zeroed just before and read
    just after. Asserts finite losses and grad norms, a step-0 loss near
    ln(vocab), and RMSNorm and flash launches forward and backward."""
    import math
    import torch
    from repro_torch.configs import get_config
    from repro_torch.training.data import DataConfig
    from repro_torch.training.train_loop import train
    cfg = get_config(TRAIN["arch"])
    steps, B, S = TRAIN["steps"], TRAIN["batch"], TRAIN["seq"]
    n_params = _dense_params(cfg)
    _say(f"[train] {cfg.arch_id} L={cfg.n_layers} d={cfg.d_model} "
         f"H={cfg.n_heads} KV={cfg.n_kv_heads} d_ff={cfg.d_ff} vocab "
         f"{cfg.vocab_size} (padded {cfg.padded_vocab}) {cfg.dtype}, "
         f"{n_params / 1e9:.3f} B parameters; {steps} AdamW steps of "
         f"{B} x {S} tokens, remat on")
    _say(f"[train] device memory in use before: "
         f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    res = train(cfg, steps=steps, dc=DataConfig(batch_size=B, seq_len=S),
                seed=0, device="cuda", log_every=1)
    launches = _launches()
    peak = torch.cuda.max_memory_allocated()
    per_step = {k: v / steps for k, v in launches.items() if v}
    steady = sorted(res.step_s[1:])[len(res.step_s[1:]) // 2]
    _say(f"[train] launches {launches}; per step {per_step}")
    _say(f"[train] step wall s {[round(t, 4) for t in res.step_s]}; "
         f"steady (median of steps 1..) {steady:.4f} s = "
         f"{B * S / steady:.0f} tokens/s; peak device memory "
         f"{peak / 2**30:.2f} GiB")
    if not all(math.isfinite(x) for x in res.losses + res.grad_norms):
        raise AssertionError(f"non-finite loss or grad norm: {res.losses} "
                             f"{res.grad_norms}")
    ln_v = math.log(cfg.vocab_size)
    if abs(res.losses[0] - ln_v) > 1.0:
        raise AssertionError(f"step-0 loss {res.losses[0]} is not near "
                             f"ln(vocab) = {ln_v:.3f}")
    missing = [k for k in ("rmsnorm", "rmsnorm_bwd", "flash_attention",
                           "flash_attention_bwd") if not launches[k]]
    if missing:
        raise AssertionError(f"kernels never launched in training: "
                             f"{missing}")
    out = {"losses": res.losses, "grad_norms": res.grad_norms,
           "step_s": res.step_s, "steady_step_s": steady,
           "tokens_per_s": B * S / steady, "peak_bytes": peak,
           "n_params": n_params, "launches": launches,
           "launches_per_step": per_step}
    if profile:
        del res
        gc.collect()
        torch.cuda.empty_cache()
        out["profile"] = _profile_train(cfg, B, S)
    return out


def phase_train_moe(profile=False):
    """deepseek-moe-16b at full width (d 2048, 16 heads of 128, 64 routed
    experts top-6 + 2 shared, d_expert 1408, vocab 102400) with its depth
    cut to TRAIN_MOE["layers"] of 28, bf16, trained for
    TRAIN_MOE["steps"] AdamW steps by the port's `train_loop.train` from
    random weights on SyntheticLM batches through the capacity-factor
    dispatch, every block checkpointed: launch counts zeroed just before
    and read just after. Asserts finite losses, grad norms and
    `lb_loss`, a step-0 `ce` near ln(vocab), 0 <= dropped_frac < 1, and
    the RMSNorm and flash kernels launched forward and backward. With
    `profile`, one more step under torch.profiler (`_profile_train`)."""
    import dataclasses
    import math
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.moe import CAPACITY_FACTOR as cf
    from repro_torch.training.data import DataConfig
    from repro_torch.training.train_loop import train
    full = get_config(TRAIN_MOE["arch"])
    cfg = dataclasses.replace(full, n_layers=TRAIN_MOE["layers"])
    m = cfg.moe
    steps, B, S = TRAIN_MOE["steps"], TRAIN_MOE["batch"], TRAIN_MOE["seq"]
    # the factor the model's capacity path runs at, and its slots
    C = max(1, int(B * S * m.top_k / m.n_experts * cf))
    n_params = cfg.param_count()
    # bf16 weights and gradients, f32 AdamW moments: 12 bytes a parameter
    # before activations and the optimizer's per-leaf f32 temporaries
    reckon = 12 * n_params
    _say(f"[train-moe] {cfg.arch_id} L={cfg.n_layers} (cut from "
         f"{full.n_layers}) d={cfg.d_model} H={cfg.n_heads} "
         f"KV={cfg.n_kv_heads} D={cfg.resolved_head_dim}, {m.n_experts} "
         f"routed experts top-{m.top_k} + {m.n_shared} shared, d_expert "
         f"{m.d_expert}, vocab {cfg.vocab_size}, {cfg.dtype}, "
         f"{n_params / 1e9:.3f} B parameters ({reckon / 2**30:.1f} GiB of "
         f"weights, gradients and moments); {steps} AdamW steps of {B} x "
         f"{S} tokens, capacity factor {cf} (C = {C}), remat on")
    _say(f"[train-moe] device memory in use before: "
         f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    res = train(cfg, steps=steps, dc=DataConfig(batch_size=B, seq_len=S),
                seed=0, device="cuda", log_every=1)
    launches = _launches()
    peak = torch.cuda.max_memory_allocated()
    per_step = {k: v / steps for k, v in launches.items() if v}
    steady = sorted(res.step_s[1:])[len(res.step_s[1:]) // 2]
    _say(f"[train-moe] launches {launches}; per step {per_step}")
    _say(f"[train-moe] step wall s {[round(t, 4) for t in res.step_s]}; "
         f"steady (median of steps 1..) {steady:.4f} s = "
         f"{B * S / steady:.0f} tokens/s; peak device memory "
         f"{peak / 2**30:.2f} GiB; lb_loss {res.lb_losses}; dropped_frac "
         f"{res.dropped_fracs}")
    vals = res.losses + res.grad_norms + res.lb_losses
    if not all(math.isfinite(x) for x in vals):
        raise AssertionError(f"non-finite loss, grad norm or lb_loss: "
                             f"{vals}")
    # the step-0 loss is ce + 0.01 * lb_loss
    ce0 = res.losses[0] - 0.01 * res.lb_losses[0]
    ln_v = math.log(cfg.vocab_size)
    if abs(ce0 - ln_v) > 1.0:
        raise AssertionError(f"step-0 ce {ce0} is not near ln(vocab) = "
                             f"{ln_v:.3f}")
    if not all(0.0 <= f < 1.0 for f in res.dropped_fracs):
        raise AssertionError(f"dropped_frac out of [0, 1): "
                             f"{res.dropped_fracs}")
    missing = [k for k in ("rmsnorm", "rmsnorm_bwd", "flash_attention",
                           "flash_attention_bwd") if not launches[k]]
    if missing:
        raise AssertionError(f"kernels never launched in MoE training: "
                             f"{missing}")
    out = {"losses": res.losses, "grad_norms": res.grad_norms,
           "lb_losses": res.lb_losses, "dropped_fracs": res.dropped_fracs,
           "step_s": res.step_s, "steady_step_s": steady,
           "tokens_per_s": B * S / steady, "peak_bytes": peak,
           "n_params": n_params, "n_layers": cfg.n_layers,
           "capacity": C, "launches": launches,
           "launches_per_step": per_step}
    if profile:
        del res
        gc.collect()
        torch.cuda.empty_cache()
        out["profile"] = _profile_train(cfg, B, S)
    return out


def _profile_decode(cfg, params, prompts, out_len, steps=4):
    """torch.profiler over `steps` decode-only steps of a vllm run (all
    requests resident, B = len(prompts)): wall per step, device-busy time
    and share, launches per step, and the top device ops."""
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
    out = _trace(session.step, steps)
    out["batch"] = len(prompts)
    _say(f"[profile] vllm decode B={len(prompts)}: "
         f"{out['wall_ms_per_step']:.2f} ms wall/step, device busy "
         f"{out['device_busy_ms_per_step']:.2f} ms/step "
         f"({out['device_busy_share']:.3f}), "
         f"{out['device_ops_per_step']:.0f} device ops/step")
    for name, ms, n in out["top"]:
        _say(f"[profile]   {ms:8.3f} ms/step  x{n:<5d} {name[:90]}")
    return out


# the paged kernels of the serving paths, by the name the profiler shows
# (stage_host_blocks_kernel and paged_decode_combine: a tree from before
# the staging moved to the copy engine and the combine was folded in, as
# tools/paged_ab.py traces it)
PAGED_KERNELS = ("paged_prefill_mma", "paged_prefill_kernel",
                 "stage_host_blocks_kernel",
                 "paged_decode_kernel", "paged_decode_combine")
TWO_POOL_RANGE = "paged_prefill two pools"


def _profile_run(cfg, params, tag, prompts):
    """torch.profiler over one layerkv run of serving path `tag` (settings
    from PATHS, weights `params`): wall time, device-busy time and share,
    device ops, and per paged kernel (PAGED_KERNELS, matched by name) its
    device time and launches. Every two-pool paged_prefill call runs
    inside a record_function range (TWO_POOL_RANGE), so the two-pool
    calls' device span shows apart from the one-pool calls' even where
    both launch one kernel name. Every staging call (`stage_host_runs`,
    where the tree has it) runs between two marker kernels on its stream,
    so `_side_copies` can read each call's device span off the compute
    stream and the part of it that overlapped compute kernels; per fused
    step also the staging host calls, their copy-engine runs and the host
    time of listing and issuing them (`stage_host_s`). The markers add
    two tiny kernels per staging call to the traced run only. Uses only
    the port's public wrappers (reading counters a tree may lack as 0),
    so it runs on any checkout's port."""
    import torch
    from torch.profiler import record_function
    from repro_torch.kernels import paged_prefill as pp
    pc = PATHS[tag]
    inner, done, stats = pp.paged_prefill, [], {}

    def two_pool_marked(*a, **kw):
        if kw.get("tier") is None:
            return inner(*a, **kw)
        with record_function(TWO_POOL_RANGE):
            return inner(*a, **kw)

    def run():
        _, d, st = _serve(cfg, params, "layerkv", pc["ndb"], pc["nhb"],
                          prompts, pc["out_len"], seed=0, device="cuda",
                          **pc["mode"])
        done.extend(d)
        stats.update(st)
    stage = getattr(pp, "stage_host_runs", None)

    def stage_marked(*a, **kw):
        torch.cuda._sleep(1)          # STAGE_MARKER, on the staging stream
        try:
            return stage(*a, **kw)
        finally:
            torch.cuda._sleep(1)
    _zero_launches()
    pp.paged_prefill = two_pool_marked
    if stage is not None:
        pp.stage_host_runs = stage_marked
    try:
        out = _trace(run, 1, top=12, kernels=PAGED_KERNELS,
                     ranges=(TWO_POOL_RANGE,), side_copies=True)
    finally:
        pp.paged_prefill = inner
        if stage is not None:
            pp.stage_host_runs = stage
    steps = stats["steps"]
    calls = pp.launches_stage
    out.update(tag=tag, requests=len(done), steps=steps, staging={
        "host_calls": calls, "host_calls_per_step": calls / steps,
        "runs": getattr(pp, "stage_runs", 0),
        "runs_per_call": getattr(pp, "stage_runs", 0) / max(calls, 1),
        "host_ms_per_step": getattr(pp, "stage_host_s", 0.0) * 1e3 / steps,
        "two_pool_bodies": pp.launches_tiered})
    two = out["ranges"][TWO_POOL_RANGE]
    _say(f"[profile] {tag} layerkv run traced: {len(done)} requests, "
         f"{steps} steps, {out['wall_ms_per_step'] / 1e3:.2f} s wall under "
         f"the profiler, device busy "
         f"{out['device_busy_ms_per_step'] / 1e3:.3f} s "
         f"({out['device_busy_share']:.3f}), "
         f"{out['device_ops_per_step']:.0f} device ops")
    for name, k in out["kernels"].items():
        _say(f"[profile]   {name}: {k['ms']:.3f} ms device over "
             f"{k['launches']} launches")
    _say(f"[profile]   {TWO_POOL_RANGE}: {two['calls']} calls, "
         f"{two['ms']:.3f} ms device")
    sc = out["side_copies"]
    _say(f"[profile]   staging on the side stream: {sc['calls']} calls "
         f"({sc['markers']} markers), {sc['ms']:.3f} ms device, "
         f"{sc['overlap_ms']:.3f} ms of it beside compute kernels on the "
         f"compute stream ({sc['overlap_share']:.3f}); the compute stream "
         f"ran kernels {sc['compute_stream_kernels_ms']:.3f} ms")
    _say(f"[profile]   staging: {out['staging']}")
    for name, ms, n in out["top"]:
        _say(f"[profile]   {ms:9.3f} ms  x{n:<6d} {name[:90]}")
    return out


def _union(iv):
    """Sorted disjoint (start, end) intervals covering `iv`."""
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


# the marker kernel `_profile_run` puts on the staging stream around each
# staging call (torch.cuda._sleep's kernel): the profiler does not record
# the copies of a cudaMemcpyBatchAsync, so the markers bound them
STAGE_MARKER = "spin_kernel"


def _side_copies(prof, ranges=()):
    """From a finished profiler's raw device events: the compute stream
    (the stream whose kernels took the most device time) and the staging
    calls on any other stream, each the span from the end of the marker
    before it to the start of the marker after it (STAGE_MARKER, in
    pairs): their count, summed device time, and how much of it
    overlapped kernels running on the compute stream; and the time the
    compute stream had a kernel running."""
    evs = [e for e in prof.profiler.kineto_results.events()
           if str(e.device_type()).endswith("CUDA")
           and e.name() not in ranges]
    kern = [e for e in evs if not e.name().startswith(("Memcpy", "Memset"))]
    by_stream = {}
    for e in kern:
        by_stream[e.device_resource_id()] = \
            by_stream.get(e.device_resource_id(), 0) + e.duration_ns()
    main = max(by_stream, key=by_stream.get) if by_stream else None
    marks = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in kern if STAGE_MARKER in e.name()
                   and e.device_resource_id() != main)
    spans = [(marks[i][1], marks[i + 1][0])
             for i in range(0, len(marks) - 1, 2)]
    compute = _union([(e.start_ns(), e.start_ns() + e.duration_ns())
                      for e in kern if e.device_resource_id() == main])
    overlap, i = 0, 0
    for a, b in _union(spans):
        while i < len(compute) and compute[i][1] <= a:
            i += 1
        j = i
        while j < len(compute) and compute[j][0] < b:
            overlap += min(b, compute[j][1]) - max(a, compute[j][0])
            j += 1
    total = sum(b - a for a, b in spans)
    return {"calls": len(spans), "markers": len(marks), "ms": total / 1e6,
            "overlap_ms": overlap / 1e6,
            "overlap_share": overlap / total if total else 0.0,
            "compute_stream": main,
            "compute_stream_kernels_ms": sum(b - a for a, b in compute)
            / 1e6}


def _trace(step, steps, top=10, kernels=(), ranges=(), side_copies=False):
    """torch.profiler over `steps` calls of `step()`: wall per step,
    device-busy time and share, device ops per step, and the `top` device
    ops by time (all with None). With `kernels`, the summed device time
    and launches of the device ops whose name holds each; with `ranges`,
    the device-side span of each record_function range of that name
    (from the first kernel launched inside to the end of the last) and
    its calls; with `side_copies`, `_side_copies` of the trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = [e for e in prof.key_averages()
           if str(getattr(e, "device_type", "")).endswith("CUDA")]
    # a record_function range also shows as a device-side span of its
    # name: it is no device op, so it counts in `ranges` only
    spans = [e for e in dev if e.key in ranges]
    dev = [e for e in dev if e.key not in ranges]

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    busy_us = sum(dev_us(e) for e in dev)
    launches = sum(e.count for e in dev)
    best = sorted(dev, key=dev_us, reverse=True)[:top]
    out = {"steps": steps,
           "wall_ms_per_step": wall / steps * 1e3,
           "device_busy_ms_per_step": busy_us / steps / 1e3,
           "device_busy_share": busy_us / (wall * 1e6),
           "device_ops_per_step": launches / steps,
           "top": [(e.key, dev_us(e) / steps / 1e3, e.count // steps)
                   for e in best]}
    if kernels:
        out["kernels"] = {
            name: {"ms": sum(dev_us(e) for e in dev if name in e.key) / 1e3,
                   "launches": sum(e.count for e in dev if name in e.key)}
            for name in kernels}
    if side_copies:
        out["side_copies"] = _side_copies(prof, ranges)
    if ranges:
        out["ranges"] = {
            name: {"ms": sum(dev_us(e) for e in spans if e.key == name)
                   / 1e3,
                   "calls": sum(e.count for e in spans if e.key == name)}
            for name in ranges}
    return out


def _profile_train(cfg, B, S):
    """torch.profiler over one train step of `cfg` (random weights, after
    one warm-up step): where the step's device time goes."""
    import torch
    from repro_torch.models import DecoderModel
    from repro_torch.training.data import DataConfig, SyntheticLM
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state
    from repro_torch.training.train_loop import make_train_step
    model = DecoderModel(cfg, device="cuda", seed=0)
    model.requires_grad_(True)
    state = [init_opt_state(model.params)]
    step_fn = make_train_step(model, AdamWConfig(lr=1e-3))
    data = SyntheticLM(cfg, DataConfig(batch_size=B, seq_len=S),
                       device="cuda").batches()
    batches = [next(data), next(data)]

    def step():
        state[0], _ = step_fn(state[0], batches.pop())
    step()
    out = _trace(step, 1, top=15)
    _say(f"[profile] train step {cfg.arch_id} {B} x {S}: "
         f"{out['wall_ms_per_step']:.1f} ms wall, device busy "
         f"{out['device_busy_ms_per_step']:.1f} ms "
         f"({out['device_busy_share']:.3f}), "
         f"{out['device_ops_per_step']:.0f} device ops")
    for name, ms, n in out["top"]:
        _say(f"[profile]   {ms:8.3f} ms  x{n:<5d} {name[:90]}")
    return out


# ------------------------------------------------------------------- main --

_NO_PALLAS_BWD = ("the JAX package has no Pallas backward: its training "
                  "differentiates the jnp ")
# per kernel: source, the TPU kernel it replaces, its pallas_call, a note
REPLACES = {
    "flash_attention": ("src/repro_torch/csrc/flash_prefill.cu",
                        "src/repro/kernels/flash_prefill.py:83", None, None),
    "paged_attention": ("src/repro_torch/csrc/paged_attention.cu",
                        "src/repro/kernels/paged_attention.py:73",
                        "src/repro/kernels/paged_attention.py:110",
                        "one launch per call: the last split block of a "
                        "row merges its splits (the former separate "
                        "combine kernel is folded in)"),
    "paged_prefill": ("src/repro_torch/csrc/paged_prefill.cu",
                      "src/repro/kernels/paged_prefill.py:140",
                      "src/repro/kernels/paged_prefill.py:186", None),
    "paged_prefill_tiered": ("src/repro_torch/csrc/paged_prefill.cu",
                             "src/repro/kernels/paged_prefill.py:140",
                             "src/repro/kernels/paged_prefill.py:210", None),
    "stage_host_blocks": (
        "src/repro_torch/csrc/paged_prefill.cu",
        "src/repro/kernels/paged_prefill.py:140",
        "src/repro/kernels/paged_prefill.py:210",
        "the first half of the two-pool call, now on the copy engine "
        "(stage_host_runs_fwd: one cudaMemcpyBatchAsync of the live host "
        "blocks' runs, on a side stream one layer ahead in the executor); "
        "the Pallas kernel fetched the host-pool blocks by DMA inside its "
        "grid"),
    "paged_prefill_mma": (
        "src/repro_torch/csrc/paged_prefill.cu",
        "src/repro/kernels/paged_prefill.py:140",
        "src/repro/kernels/paged_prefill.py:186",
        "the body of both forms on the tensor cores (tc::paged_prefill_mma,"
        " mma.sync): bf16 at D 64 and 128, every main path"),
    "paged_prefill_fma": (
        "src/repro_torch/csrc/paged_prefill.cu",
        "src/repro/kernels/paged_prefill.py:140",
        "src/repro/kernels/paged_prefill.py:186",
        "the body of both forms on the CUDA cores (paged_prefill_kernel): "
        "f32, and bf16 at D 32 (the smoke paths)"),
    "rmsnorm": ("src/repro_torch/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm.py:29",
                "src/repro/kernels/rmsnorm.py:44", None),
    "rmsnorm_bwd": ("src/repro_torch/csrc/rmsnorm.cu",
                    "src/repro/kernels/rmsnorm.py:29", None,
                    _NO_PALLAS_BWD + "norm, src/repro/models/layers.py:35"),
    "flash_attention_bwd": ("src/repro_torch/csrc/flash_backward.cu",
                            "src/repro/kernels/flash_prefill.py:83", None,
                            _NO_PALLAS_BWD + "oracle, src/repro/kernels/"
                            "ref.py flash_attention_reference"),
}
# the main path whose launch count each kernel's row reports
MAIN_PATH = {"flash_attention": "serve", "paged_attention": "serve",
             "paged_prefill": "fused", "paged_prefill_tiered": "fused",
             "stage_host_blocks": "fused", "paged_prefill_mma": "fused",
             "paged_prefill_fma": "fused-smoke",
             "rmsnorm": "train", "rmsnorm_bwd": "train",
             "flash_attention_bwd": "train"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write every number of the run here (JSON)")
    ap.add_argument("--profile", action="store_true",
                    help="trace a few decode steps of the serve phase, "
                         "one layerkv run of the fused phase and one step "
                         "of each train phase with torch.profiler and "
                         "print where they go")
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
    for name, err in phase_head_dim_32().items():   # rows hold the worst
        for key, e in err.items():
            kern[name][0][key] = max(kern[name][0].get(key, 0.0), e)
    paths = phase_smoke()
    paths["serve"] = phase_serve(profile=args.profile)
    params = paths["serve"].pop("params")
    paths["fused"] = phase_fused(params, paths["serve"]["tokens"],
                                 profile=args.profile)
    paths["fused"].pop("params")
    paths["cluster"] = phase_cluster(params, paths["fused"]["tokens"])
    del params
    gc.collect()                     # the cluster's engines hold cycles
    torch.cuda.empty_cache()         # llama2-7b's weights go before MoE's
    torch.cuda.reset_peak_memory_stats()
    paths["moe"] = phase_moe()
    paths["moe"].pop("params")
    gc.collect()        # the engines hold reference cycles: free the MoE
    torch.cuda.empty_cache()     # weights and pools before training
    paths["train"] = phase_train(profile=args.profile)
    gc.collect()
    torch.cuda.empty_cache()
    paths["train-moe"] = phase_train_moe(profile=args.profile)
    torch.cuda.empty_cache()

    rows = []
    for name, (err, t) in kern.items():
        src_path, replaces, call, note = REPLACES[name]
        rows.append({
            "name": name, "route": "cuda", "source": src_path,
            "replaces": replaces,
            "launches": paths[MAIN_PATH[name]]["launches"][name],
            "launches_by_path": {k: v["launches"][name]
                                 for k, v in paths.items()},
            "max_abs_err": err["bfloat16"],
            "max_abs_err_f32": err.get("float32"),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "shape": t["shape"]})
        for extra in ("at_train_shape", "at_moe_train_shape",
                      "at_serve_shapes", "at_other_shapes",
                      "at_b1_ctx4096", "bound_ms_pcie", "copy_engine_ms",
                      "by_kernel_ms", "staged_bytes", "library_note",
                      "one_run_ms", "runs"):
            if extra in t:
                rows[-1][extra] = t[extra]
        if name == "stage_host_blocks":
            rows[-1]["staging_by_path"] = {
                k: {x: v[x] for x in ("staging_bytes", "stage_runs",
                                      "stage_host_s")}
                for k, v in paths.items() if "staging_bytes" in v}
        if call:
            rows[-1]["pallas_call"] = call
        if note:
            rows[-1]["note"] = note
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"nvidia_smi": smi, "kernels": rows, "paths": paths,
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
