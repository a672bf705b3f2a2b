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
           has no HGMMA or no HMMA, its bf16 and its 3xTF32 kernels, or
           the backward neither), and the card's name and power limit as
           nvidia-smi gives them.
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
           asserted on its route (bf16 at D 64 / 128 on the bf16
           tensor-core kernel, f32 and bf16 at D 32 on the 3xTF32 one),
           on the cases
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
           the bf16 tensor-core body also at granite-3-2b's heads, the
           3xTF32 body at the smoke paths' D = 32 in bf16 and f32 and at
           the timed chunk in f32 at llama2-7b's and granite-3-2b's
           heads, one pool and, at llama2-7b's, two) with CUDA events
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
           path's launches run. The examples' own training shapes are
           held and timed too: flash forward and backward at train_tiny's
           G = 3 (H 12, KV 4, D 64, B 4 x S 256, causal) and RMSNorm both
           ways at its d 768 (1024 rows) and quickstart's d 256 (512
           rows), checked in bf16 and f32 and timed in f32, their dtype.
           f32 flash (every D) and bf16 flash at D 32 run the 3xTF32
           kernels (mma.sync .tf32 on each operand's TF32 pair): held at
           the f32 tolerance at D 32, 64, 80 and 128, on the edge cases
           (Sq != Skv at q_offset 37, a window, a few rows past a
           16-key tile), at G = 3 and for the one-row decode; and timed
           in f32 at train_tiny's shape and granite-3-2b's train shape,
           and at quickstart's (granite-3-2b smoke: B 8, S 64, H 8, KV 2,
           D 32) in f32 and bf16, an f32 row's bound at a third of
           TF32's 495 TFLOP/s (three passes a product), with the bound
           at the f32 FMA peak beside it ("bound_ms_f32_fma"); so is
           the f32 paged prefill body (`tf::paged_prefill_tf32`, the
           same arithmetic over the paged pool). The plain
           versions run with TF32 off (torch's default; main sets and
           prints it), so f32 means f32.
  d32      every attention kernel (flash forward and backward, paged
           decode, paged prefill over one pool and two) against its plain
           version at head dim 32, the smoke configs' (granite-3-2b H 8
           KV 2, deepseek-moe-16b H 4 KV 4), in bf16 (flash and the paged
           prefill body: the 3xTF32 kernels; paged decode: its one
           kernel) and f32,
           on the kernels phase's cases; the worst errors fold into the
           kernels' rows.
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
           Its decode steps run the executor's compiled steps: a
           signature's first step eagerly, then one CUDA graph captured
           and replayed (`serving.executor._StepGraph`).
  graphs   the serve phase's weights in an executor of its own with a
           twin that shares them and a copy of its pool: three dense
           decode steps of one signature (8 rows, contexts 900-1000)
           and three host-free fused steps of one signature (two chunks,
           four decode rows), each held against the same step run
           eagerly by the twin on fresh tensors: tokens equal, logits and
           the pool (but its trash block) bit for bit; the first step of
           each runs eagerly, the second is captured and replayed, the
           third replayed.
  fused    the same model, weights and prompts through the fused mixed
           step (chunked, fused, 512-token prefill budget): chunk rows on
           the paged-prefill kernel, over the pinned host pool for layers
           offloaded mid-prefill, decode rows on the paged decode kernel.
  moe      deepseek-moe-16b (arXiv:2401.06066) at full width and depth
           (28 layers, 64 routed experts top-6 + 2 shared), bf16, random
           weights made on the card after llama2-7b's are freed, through
           the fused step: 6 requests of 256-1024 tokens, 16 output tokens.
           Its decode and host-free fused steps run compiled, as the
           serve phase's do (the dropless dispatch reads nothing on the
           host). Then the graphs phase's check on its weights: three
           MoE decode steps and three host-free MoE fused steps of one
           signature each against the eager twin, bit for bit.
           Each of serve / fused / moe is a main path: kernel launch counts
           are zeroed just before its layerkv run and read just after it.
           Each asserts every request finishes, offload and reload both
           happened, its kernels were launched, no logits went non-finite,
           and every first token equals a 'vllm' run (same mode) on a pool
           that fits everything; fused and moe also assert a step ran with
           a host-tier chunk. Each prints the agreement share of the full
           token streams and wall-clock TTFT / TPOT / decode tokens per
           second, and each run's compiled steps: signatures captured,
           replays, eager steps by reason and the graph pool's bytes;
           serve, fused and moe assert replays, at most one capture per
           signature and no step eager for a reason but 'first' (a
           signature's warm-up) or 'host-tier'.
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
  generate llama2-7b (the serve phase's weights and 8 prompts, batched
           with prompt_len) through the port's Model API with no engine:
           `DecoderModel.prefill` into a dense (L, B, S, KV, hd) cache,
           then 32 greedy `decode` steps, each attention call on the flash
           forward kernel (one query row, non-causal, runtime kv_len:
           `decode_attention`); again with kv_quant (int8 codes, bf16
           scales) fed the bf16 run's tokens, whose logits must stay
           within rel 5e-2 at every step; prints TTFT / TPOT (wall), the
           launches, and the first-token and stream agreement with the
           serve phase's engine (not gated). Then decode against teacher
           forcing at full width, 2 layers, f32: prefill(200) + 8
           decodes against prefill(208), rel < 5e-3. Launch counts are
           zeroed just before each run and read just after; every flash
           and decode launch is accounted for.
  generate-vlm  qwen2-vl-7b (arXiv:2409.12191) at full width and depth
           (28 layers, d 3584, 28 query heads over 4 KV heads of 128,
           G = 7), bf16, random weights made on the card: 4 prompts of
           256-1024 positions from stub embeds with mrope positions, 32
           decode steps of text tokens.
  train-vlm  qwen2-vl-7b at full width with its depth cut to 8 of 28
           layers (TRAIN_VLM; 2.95 B parameters), 5 AdamW steps of 4 x
           1024 positions on the data stream's vlm stub, every block
           checkpointed: RMSNorm and flash (G = 7) forward and backward.
  encdec   whisper-base (arXiv:2212.04356) at full width and depth (6 + 6
           layers, d 512, H = KV = 8, D 64, 1500 encoder frames), bf16:
           8 stub encoder inputs and a 4-token prompt, then 64 decode
           steps over the cached cross K/V (flash non-causal: the encoder
           over 1500 x 1500, cross-attention Sq != Skv, one decode row
           over 1500 frames); decode against teacher forcing in f32; 5
           AdamW steps of 8 x 448 tokens (flash forward and backward,
           non-causal Sq != Skv included). The kernels phase also holds
           the flash forward and backward at these shapes and at G = 7,
           and decode_attention at every generate path's heads, against
           their plain versions, and times them beside SDPA.
  generate-hybrid  zamba2-2.7b (arXiv:2411.15242) at full width and depth
           (54 Mamba2 layers in 9 superblocks, each opened by the one
           shared attention + MLP block; H = KV = 32 heads of D 80), bf16,
           random weights made on the card: 4 random prompts of 1024
           tokens (`HybridModel.prefill` takes one S for the batch) into a
           1056-slot cache, 32 greedy decodes; flash at D 80 (the
           wgmma kernel, a 64-column block and a 16-column tail block
           a row) in prefill, decode_attention at
           D 80, RMSNorm at d 2560 and 5120. Decode against teacher
           forcing in f32 at full width over one superblock (6 layers):
           prefill(120) + 8 decodes against prefill(128), rel < 5e-3.
  train-hybrid  zamba2-2.7b at full width and depth (2.42 B parameters,
           TRAIN_HYBRID), 5 AdamW steps of 4 x 1024 tokens, every
           superblock checkpointed: flash at D 80 forward (wgmma) and
           backward (mma.sync), RMSNorm both ways.
  generate-ssm  xlstm-1.3b (arXiv:2405.04517) at full width and depth (6
           superblocks of 7 mLSTM + 1 sLSTM, 3.53 B parameters as the
           reference builds it), as generate-hybrid: 4 x 1024 prompts, 32
           decodes (the exact recurrence), teacher forcing in f32 over
           one superblock (8 layers); RMSNorm at d 2048 and 4096, no
           attention.
  train-ssm  xlstm-1.3b at full width with its depth cut to 16 of 48
           layers (TRAIN_SSM; 1.31 B parameters), 5 AdamW steps of
           4 x 1024 tokens: RMSNorm both ways. The sLSTM runs one step per
           token (host-bound). The kernels phase holds flash forward and
           backward and decode_attention at D 80 and RMSNorm at d 2048,
           2560, 4096 and 5120 at these paths' shapes (their train rows
           and 4-row decode steps), and times them.
  examples the port's examples (`repro_torch.examples`) on the card, each
           at its own size, launch counts zeroed just before each part
           and read just after: quickstart (granite-3-2b smoke, f32: 60
           AdamW steps of 8 x 64 tokens, then 6 requests through a
           ServingSession over a layerkv engine on a 24-block pool, r0
           streamed), serve_comparison (10 requests: vllm on 1024 blocks
           as ground truth, then vllm and layerkv on 20; losslessness and
           the TTFT ratio), train_tiny (TINY_100M: 12 layers, d 768, 32k
           vocab, f32, 50 steps of 4 x 256, its npz + manifest checkpoint
           written to a temporary directory and removed). Asserts finite
           losses, RMSNorm and flash forward and backward launched in
           each training part, flash prefill, paged decode and RMSNorm in
           each engine part, r0's stream equal to its output; prints the
           losses, tokens/s, TTFT, offload / reload counts and the
           stream agreement (on a mismatch the diverging step's top-2
           logit gap in f32, teacher-forced at B 1).
  dryrun   `python -m repro_torch.launch.dryrun` in a subprocess a
           pair (CPU only, fake tensors: no kernel runs): chatglm3-6b x
           decode_32k on the 16x16 and 2x16x16 placeholder meshes,
           granite-3-2b x train_4k, deepseek-moe-16b x prefill_32k and
           zamba2-2.7b x decode_32k (the SSD's decode step on each
           rank's (b, h) block) on 16x16, then `roofline.analysis` over
           their records (the H100's spec-sheet peaks), then `python -m
           repro_torch.examples.offload_dryrun`. Every record must be
           ok and fit the 80 GB HBM; prints bytes per rank, FLOPs,
           collective counts, the three roofline terms and each
           record's notes.
  profile  (only with --profile) torch.profiler over a few decode-only
           steps of an exclusive vllm llama2-7b run at B = 8 and of a
           deepseek-moe-16b one at B = 6 (graph replays: the profiler's
           paged_decode_kernel count must equal the launch counter's),
           over one
           more layerkv run of the fused path (the paged kernels' device
           time and launches, the two-pool calls apart, the side
           stream's staging copies with the share that overlaps compute
           kernels, and staging host calls, runs and host time per
           step), and over one train step after each train phase and
           of train_tiny: wall and device-busy
           time, device ops, top device ops; for the hybrid and ssm
           paths each sequence core's device span (`_ssm_ranges`).

The line before the last is a JSON object {"kernels": [...]}, the last
line {"ok": true, "device": {...}}. Without a CUDA device, or without
the repository's `src/repro_torch` beside it, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
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
TF32_FLOPS_PER_S = 495e12     # H100 SXM data sheet, dense TF32
TOL = {"bfloat16": 2e-2, "float32": 2e-5}
FLASH_SHAPES = {"llama2-7b": (32, 32, 128), "granite-3-2b": (32, 8, 64)}
# (H, KV, D) that complete G = H / KV in {1, 4, 8} at D = 64 and 128 for
# the flash checks
FLASH_GQA_SHAPES = [(32, 32, 64), (32, 4, 64), (32, 8, 128), (32, 4, 128)]
# paged prefill's checks: FLASH_SHAPES and G = 16 (512 rows per 32-token
# tile, the kernel's largest group)
PP_SHAPES = {**FLASH_SHAPES, "G 16": (32, 2, 128)}
# the smoke configs' attention (D = 32: bf16 flash and the bf16 paged
# prefill body take the 3xTF32 kernels, paged decode its one kernel)
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
# The Model-API paths (no engine: `prefill` + `decode` over a dense cache,
# and training), random weights from a seed:
# generate: llama2-7b on the serve phase's weights and prompts (batched
#   with prompt_len, a cache of the longest prompt + `steps`), `steps`
#   greedy decode steps, with a bf16 cache and again with an int8 one
#   (fed the bf16 run's tokens); and decode held against teacher forcing
#   at full width, `tf_layers` layers, f32: prefill(S) + N decodes
#   against prefill(S + N)
GENERATE = dict(arch="llama2-7b", steps=32, tf_layers=2, tf_batch=2,
                tf_prompt=200, tf_steps=8)
# generate-vlm: qwen2-vl-7b at full width and depth, `n` prompts of
#   256-1024 positions (lengths from `seed`) from stub embeds with
#   text-stream mrope positions, `steps` decode steps
GENERATE_VLM = dict(arch="qwen2-vl-7b", n=4, seed=3, steps=32)
# encdec: whisper-base at full width and depth, `batch` stub encoder
#   inputs of encoder_len (1500) frames and a `prompt`-token prompt, then
#   `steps` decode steps; decode against teacher forcing in f32; and
#   `train_steps` AdamW steps at batch x `train_seq` (its text context)
ENCDEC = dict(arch="whisper-base", batch=8, prompt=4, steps=64,
              train_steps=5, train_seq=448)
# the kernels every train path with RMSNorm must launch
TRAIN_KERNELS = ("rmsnorm", "rmsnorm_bwd", "flash_attention",
                 "flash_attention_bwd")
# train-vlm: qwen2-vl-7b at full width, depth cut from 28 to `layers`
TRAIN_VLM = dict(arch="qwen2-vl-7b", layers=8, steps=5, batch=4, seq=1024)
# the new paths' attention: qwen2-vl-7b (28 query heads over 4 KV heads,
# G = 7, D 128) and whisper-base (H = KV = 8, D 64; 1500 encoder frames,
# a 448-token text context)
G7_ATTN = (28, 4, 128)
WHISPER_ATTN = (8, 8, 64)
WHISPER_FRAMES, WHISPER_TEXT = 1500, 448
# The last two families' paths (random bf16 weights made on the card):
# generate-hybrid: zamba2-2.7b at full width and depth, `batch` prompts of
#   `prompt` tokens (one S for the batch: the hybrid's prefill takes no
#   prompt_len, and the SSD wants S <= 128 or a multiple of 128) into a
#   cache of prompt + steps slots, `steps` greedy decodes; decode against
#   teacher forcing in f32 over one superblock, prefill(tf_prompt) +
#   tf_steps decodes against prefill(tf_prompt + tf_steps) (both <= 128)
GENERATE_HYBRID = dict(arch="zamba2-2.7b", batch=4, prompt=1024, steps=32,
                       tf_batch=2, tf_prompt=120, tf_steps=8)
# train-hybrid: zamba2-2.7b at full width and depth (2.42 B parameters)
TRAIN_HYBRID = dict(arch="zamba2-2.7b", layers=54, steps=5, batch=4,
                    seq=1024)
# generate-ssm / train-ssm: xlstm-1.3b as generate-hybrid; training at
#   full width with its depth cut from 48 to `layers` (two superblocks of
#   7 mLSTM + 1 sLSTM), so the sLSTM's per-token loop stays short
GENERATE_SSM = dict(arch="xlstm-1.3b", batch=4, prompt=1024, steps=32,
                    tf_batch=2, tf_prompt=120, tf_steps=8)
TRAIN_SSM = dict(arch="xlstm-1.3b", layers=16, steps=5, batch=4, seq=1024)
# zamba2-2.7b's shared attention: H = KV = 32, D = 2560 / 32 = 80 (bf16
# on the tensor-core kernels: the wgmma forward, the mma.sync backward)
D80_ATTN = (32, 32, 80)
# generate-hybrid's decode keys: 4 rows over 1025-1056 of 1056 slots
D80_DECODE_LENS, D80_DECODE_SLOTS = [1025, 1036, 1047, 1056], 1056
# decode_attention's checks: one query row per sequence over a dense cache
DECODE_SHAPES = {"llama2-7b": FLASH_SHAPES["llama2-7b"],
                 "qwen2-vl-7b": G7_ATTN, "whisper-base": WHISPER_ATTN,
                 "zamba2-2.7b": D80_ATTN,
                 "granite-3-2b smoke": SMOKE_SHAPES["granite-3-2b smoke"]}
# the examples phase (f32): quickstart trains granite-3-2b smoke (d 256,
# D 32) on batches of QUICK_TRAIN; train_tiny trains TINY_100M (d 768,
# 12 query heads over 4 KV heads of 64: G = 3) on tiny_batch x tiny_seq
EXAMPLES = dict(quick_steps=60, tiny_steps=50, tiny_batch=4, tiny_seq=256)
QUICK_TRAIN = (8, 64)
TINY_ATTN, TINY_D = (12, 4, 64), 768
# RMSNorm shapes: the train path's activations, llama2-7b prefill / decode,
# and qwen2-vl-7b's (d 3584: 448 16-byte vectors a row, not a multiple of
# the 256 lanes of the reduction tree) at train-vlm's 4 x 1024 rows and
# generate-vlm's decode step
NORM_SHAPES = {"train": (TRAIN["batch"], TRAIN["seq"], 2048),
               "llama2-7b prefill": (1, 1024, 4096),
               "llama2-7b decode": (8, 1, 4096),
               "qwen2-vl-7b train": (TRAIN_VLM["batch"], TRAIN_VLM["seq"],
                                     3584),
               "qwen2-vl-7b decode": (GENERATE_VLM["n"], 1, 3584),
               # zamba2-2.7b: d 2560 (every block norm) and d_in 5120 (the
               # Mamba2 gated norm): 320 and 640 16-byte vectors a row,
               # uneven last passes; xlstm-1.3b's block norms (d 2048) and
               # mLSTM gated norm (d_in 4096) at train-ssm's rows (its
               # d 2048 there is "train") and generate-ssm's 4-row decode
               "zamba2-2.7b train d 2560": (TRAIN_HYBRID["batch"],
                                            TRAIN_HYBRID["seq"], 2560),
               "zamba2-2.7b train d 5120": (TRAIN_HYBRID["batch"],
                                            TRAIN_HYBRID["seq"], 5120),
               "zamba2-2.7b decode d 2560": (GENERATE_HYBRID["batch"], 1,
                                             2560),
               "zamba2-2.7b decode d 5120": (GENERATE_HYBRID["batch"], 1,
                                             5120),
               "xlstm-1.3b train d 4096": (TRAIN_SSM["batch"],
                                           TRAIN_SSM["seq"], 4096),
               "xlstm-1.3b decode d 2048": (GENERATE_SSM["batch"], 1, 2048),
               "xlstm-1.3b decode d 4096": (GENERATE_SSM["batch"], 1, 4096),
               # the examples' training norms: train_tiny's d 768 (192
               # 16-byte vectors a row in bf16, 96 in f32: fewer than the
               # reduction tree's 256 lanes) and quickstart's d 256
               "train_tiny d 768": (EXAMPLES["tiny_batch"],
                                    EXAMPLES["tiny_seq"], TINY_D),
               "quickstart d 256": (*QUICK_TRAIN, 256)}


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
    if not sass["flash_prefill"]["HMMA"]:
        raise AssertionError("the flash forward holds no HMMA (its 3xTF32 "
                             "kernel's mma.sync .tf32)")
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
    train-moe path's shape (B 4, S 1024, H = KV = 16, D 128); qwen2-vl-7b's
    G = 7 (H 28, KV 4, D 128) on the engine and edge cases, at train-vlm's
    B 4 x S 1024 and at generate-vlm's 4 ragged prompts; whisper-base's
    shapes at its paths' batch of 8 (the non-causal encoder over 1500
    frames, cross-attention from 448 decoder rows or one decode row to
    1500 frames, with and without enc_len, and the causal 448-token
    decoder); zamba2-2.7b's D = 80 (H = KV = 32) on the engine and edge
    cases and at train-hybrid's and generate-hybrid's B 4 x S 1024;
    train_tiny's G = 3 (TINY_ATTN) on the edge cases and at its B 4 x
    S 256. With `sizes` ({name: (H, KV, D)}), the engine and edge cases
    at those shapes only."""
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
    Bv, Sv = TRAIN_VLM["batch"], TRAIN_VLM["seq"]
    vlm_lens = [len(p) for p in _prompts(n=GENERATE_VLM["n"],
                                         seed=GENERATE_VLM["seed"])]
    vlm = engine_cases + edge_cases + [
        (f"train-vlm B {Bv} S {Sv}", Bv, Sv, Sv, [Sv] * Bv, 0, 0),
        (f"generate-vlm prompts {vlm_lens}", len(vlm_lens), max(vlm_lens),
         max(vlm_lens), vlm_lens, 0, 0)]
    T, F, Be = WHISPER_TEXT, WHISPER_FRAMES, ENCDEC["batch"]
    # whisper-base: non-causal, Sq != Skv (the key tile's tail at 1500 =
    # 11 x 128 + 92), a cross call's one decode row, and enc_len masks
    whisper = [(f"encoder Sq = Skv = {F}", 2, F, F, [F] * 2, 0, 0, False),
               (f"encoder B {Be} Sq = Skv = {F}", Be, F, F, [F] * Be, 0, 0,
                False),
               (f"decoder B {Be} S {T}", Be, T, T, [T] * Be, 0, 0),
               (f"cross Sq {T} Skv {F}", 8, T, F, [F] * 8, 0, 0, False),
               (f"cross decode Sq 1 Skv {F}", 8, 1, F, [F] * 8, 0, 0, False),
               (f"cross Sq {T} Skv {F} enc_len 1000 / 93", 2, T, F,
                [1000, 93], 0, 0, False)]
    # train-hybrid's batch is generate-hybrid's prefill (4 x 1024, causal)
    Bh, Sh = TRAIN_HYBRID["batch"], TRAIN_HYBRID["seq"]
    hybrid = engine_cases + edge_cases + [
        (f"train-/generate-hybrid B {Bh} S {Sh}", Bh, Sh, Sh, [Sh] * Bh, 0,
         0)]
    Bt, St = EXAMPLES["tiny_batch"], EXAMPLES["tiny_seq"]
    tiny = edge_cases + [(f"train_tiny B {Bt} S {St}", Bt, St, St,
                          [St] * Bt, 0, 0)]
    shapes = [(arch, hkd, engine_cases + edge_cases)
              for arch, hkd in (sizes or FLASH_SHAPES).items()]
    if sizes is None:
        shapes += [(f"G={H // KV} D={D}", (H, KV, D), edge_cases)
                   for H, KV, D in FLASH_GQA_SHAPES]
        shapes += [(TRAIN_MOE["arch"], MOE_TRAIN_ATTN, moe_train),
                   ("qwen2-vl-7b G=7", G7_ATTN, vlm),
                   ("whisper-base", WHISPER_ATTN, whisper),
                   ("zamba2-2.7b D=80", D80_ATTN, hybrid),
                   ("train_tiny G=3", TINY_ATTN, tiny)]
    for arch, (H, KV, D), cases in shapes:
        for dtype in (torch.bfloat16, torch.float32):
            tol = TOL[str(dtype).split(".")[1]]
            for name, B, Sq, Skv, kv_len, q_off, window, *c in cases:
                causal = c[0] if c else True
                q, k, v, lens, off = _flash_case(gen, H, KV, D, dtype, B, Sq,
                                                 Skv, kv_len, q_off)
                got = fp.flash_attention(q, k, v, kv_len=lens, q_offset=off,
                                         window=window, causal=causal)
                want = fp.flash_attention_plain(q, k, v, kv_len=lens,
                                                q_offset=off, window=window,
                                                causal=causal)
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


def check_decode(gen):
    """decode_attention (the flash forward at one query row, non-causal,
    with the runtime kv_len) against its plain version at the generate
    paths' heads (llama2-7b, qwen2-vl-7b's G = 7, whisper-base's D 64,
    zamba2-2.7b's D 80, the smoke D 32): 8 rows over a 1056-slot cache
    with kv_len at the 128-key tile's edges and up to the whole cache;
    and generate-hybrid's own: 4 rows over 1025-1056 keys at D 80. One
    launch per call (`launches_decode`). Returns the worst error per
    dtype."""
    import torch
    from repro_torch.kernels import flash_prefill as fp
    lens, S = [1, 127, 128, 129, 281, 700, 1040, 1056], 1056
    worst = {}
    cases = [(arch, hkd, lens, S) for arch, hkd in DECODE_SHAPES.items()]
    cases.append(("generate-hybrid", D80_ATTN, D80_DECODE_LENS,
                  D80_DECODE_SLOTS))
    for arch, (H, KV, D), lens, S in cases:
        for dtype in (torch.bfloat16, torch.float32):
            key = str(dtype)[6:]
            tol = TOL[key]
            q, k, v, kv_len, _ = _flash_case(gen, H, KV, D, dtype, len(lens),
                                             1, S, lens, 0)
            before = fp.launches_decode
            got = fp.decode_attention(q, k, v, kv_len)
            want = fp.decode_attention_plain(q, k, v, kv_len)
            torch.cuda.synchronize()
            if fp.launches_decode != before + 1:
                raise AssertionError("decode_attention: not one launch")
            err, ok = _max_err(got, want, tol)
            _say(f"[kernels] decode_attention {arch} H={H} KV={KV} D={D} "
                 f"{key} B={len(lens)} Sq=1 cache {S} kv_len {lens}: "
                 f"max_abs_err "
                 f"{err:.3g} (tol {tol})")
            if not ok or not torch.isfinite(got).all():
                raise AssertionError(f"decode_attention disagrees: {arch} "
                                     f"{dtype} err {err}")
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
    """The flash forward, bf16, causal, at llama2-7b prefill attention at
    the main path's largest bucket (one prompt of 1024 tokens) and at the
    train path's shape (granite-3-2b, B 4, S 1024, GQA 4:1), each beside
    its plain version and scaled_dot_product_attention (enable_gqa where
    G > 1), at the MoE train path's (deepseek-moe-16b, B 4, S 1024,
    H = KV = 16, D 128), and at the new paths' ("at_other_shapes"):
    train-vlm's G = 7 (B 4, S 1024, H 28, KV 4, D 128, causal) and
    whisper-base's non-causal cross-attention (B 8, 448 rows over 1500
    frames) and encoder (B 8, 1500 x 1500), and zamba2-2.7b's D = 80 at
    train-hybrid's and generate-hybrid's B 4 x S 1024 (H = KV = 32,
    causal), and the f32 route (3xTF32): train_tiny's G = 3 at its B 4 x
    S 256 (TINY_ATTN, causal), granite-3-2b's train shape in f32, and
    quickstart's (QUICK_TRAIN, the smoke heads at D 32) in f32 and bf16.
    Returns the serve shape's row with the
    train shapes' under "at_train_shape" and "at_moe_train_shape"; each
    row names the kernel the dispatch takes ("kernel")."""
    S = TRAIN["seq"]
    B8, T, F = ENCDEC["batch"], WHISPER_TEXT, WHISPER_FRAMES
    rows = [_time_flash_fwd_at(gen, *FLASH_SHAPES["llama2-7b"], 1, S, S,
                               True, lens_arg=True),
            _time_flash_fwd_at(gen, *FLASH_SHAPES["granite-3-2b"],
                               TRAIN["batch"], S, S, True),
            _time_flash_fwd_at(gen, *MOE_TRAIN_ATTN, TRAIN_MOE["batch"], S, S,
                               True)]
    rows[0]["at_train_shape"] = rows[1]
    rows[0]["at_moe_train_shape"] = rows[2]
    rows[0]["at_other_shapes"] = [
        _time_flash_fwd_at(gen, *G7_ATTN, TRAIN_VLM["batch"],
                           TRAIN_VLM["seq"], TRAIN_VLM["seq"], True),
        _time_flash_fwd_at(gen, *WHISPER_ATTN, B8, T, F, False),
        _time_flash_fwd_at(gen, *WHISPER_ATTN, B8, F, F, False),
        _time_flash_fwd_at(gen, *D80_ATTN, TRAIN_HYBRID["batch"],
                           TRAIN_HYBRID["seq"], TRAIN_HYBRID["seq"], True),
        _time_flash_fwd_at(gen, *TINY_ATTN, EXAMPLES["tiny_batch"],
                           EXAMPLES["tiny_seq"], EXAMPLES["tiny_seq"], True,
                           dtype="float32"),
        _time_flash_fwd_at(gen, *FLASH_SHAPES["granite-3-2b"],
                           TRAIN["batch"], S, S, True, dtype="float32")] + [
        _time_flash_fwd_at(gen, *SMOKE_SHAPES["granite-3-2b smoke"],
                           QUICK_TRAIN[0], QUICK_TRAIN[1], QUICK_TRAIN[1],
                           True, dtype=dtype)
        for dtype in ("float32", "bfloat16")]
    rows[0]["routes"] = _flash_routes()
    return rows[0]


def _flash_routes(bwd=False):
    """{dtype D: the kernel the dispatch takes} for every head dim."""
    return {f"{_short(dtype)} D {D}": _flash_kernel(D, bwd, dtype)
            for dtype in ("bfloat16", "float32") for D in (32, 64, 80, 128)}


def _time_flash_fwd_at(gen, H, KV, D, B, Sq, Skv, causal, lens_arg=False,
                       dtype="bfloat16"):
    """One forward shape (bf16 unless `dtype`) beside its plain version
    and SDPA; with `lens_arg` the kernel also takes kv_len (every key
    valid), as the engine's prefill passes it."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_prefill as fp
    q, k, v, lens, _ = _flash_case(gen, H, KV, D, getattr(torch, dtype), B,
                                   Sq, Skv, [Skv] * B, 0)
    lens = lens if lens_arg else None   # the train path passes none
    ms = _time_ms(lambda: fp.flash_attention(q, k, v, kv_len=lens,
                                             causal=causal))
    plain = _time_ms(lambda: fp.flash_attention_plain(
        q, k, v, kv_len=lens, causal=causal), reps=5)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))  # (B, H, S, D)
    lib = _time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, enable_gqa=KV != H))
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size() \
        + (lens.numel() * 4 if lens is not None else 0)
    pairs = _flash_pairs(Sq, [0] * B, [Skv] * B) if causal \
        else B * Sq * Skv
    row = _flash_bound(ms, plain, lib, nbytes, 4 * D * H * pairs, dtype,
                       f"B={B} Sq={Sq} Skv={Skv} H={H} KV={KV} D={D} "
                       f"{_short(dtype)} "
                       f"{'causal' if causal else 'non-causal'}")
    row["kernel"] = _flash_kernel(D, dtype=dtype)
    return row


def _flash_bound(ms, plain, lib, nbytes, flops, dtype, shape):
    """`_bound` of a flash row at the floor of its products: the bf16
    tensor cores' rate for bf16 (at D 32 the 3xTF32 kernel takes one or
    two TF32 passes a product, and the bf16 rate bounds the same work
    lower), a third of TF32's for f32 (3xTF32: three passes a product).
    An f32 row also gives the bound at the f32 FMA peak
    ("bound_ms_f32_fma", 67 TFLOP/s), the CUDA-core kernels' bound, so
    that it compares with their rows."""
    f32 = dtype == "float32"
    row = _bound(ms, plain, lib, nbytes, flops,
                 TF32_FLOPS_PER_S / 3 if f32 else BF16_FLOPS_PER_S, shape)
    if f32:
        row["bound_ms_f32_fma"] = max(nbytes / HBM_BYTES_PER_S,
                                      flops / F32_FLOPS_PER_S) * 1e3
    return row


def _short(dtype):
    return {"bfloat16": "bf16", "float32": "f32"}[dtype]


def _flash_kernel(D, bwd=False, dtype="bfloat16"):
    """The kernel that flash_prefill.cu (with `bwd` flash_backward.cu)
    dispatches `dtype` at head dim D to: bf16 at D 64, 80 and 128 on
    wgmma (forward) and mma.sync (backward), f32 at every D and bf16 at
    D 32 in 3xTF32 on mma.sync .tf32."""
    if dtype == "float32" or D == 32:
        t = "float" if dtype == "float32" else "bf16"
        return (f"tf::flash_bwd_{{dq,dkdv}}_tf32<{t}, {D}> (3xTF32, "
                f"mma.sync)" if bwd
                else f"tf::flash_fwd_tf32<{t}, {D}> (3xTF32, mma.sync)")
    return (f"tc::flash_bwd_{{dq,dkdv}}_mma<{D}> (mma.sync)" if bwd
            else f"tc::flash_fwd_wgmma<{D}> (wgmma + TMA)")


def time_decode(gen):
    """decode_attention (the flash forward at one query row) at the
    generate path's llama2-7b step: B 8, the serve prompts' contexts at
    the middle decode step (prompt + 16) in a 1056-slot cache, H = KV =
    32, D 128, bf16; beside its plain version and SDPA with a key mask
    (one call computing the same function); at qwen2-vl-7b's G = 7 (B 4),
    at whisper-base's cross decode (B 8, one row over 1500 frames) and at
    generate-hybrid's middle step (zamba2-2.7b D 80, B 4, 1040 keys of
    1056) under "at_other_shapes". The note counts the tile the kernel wastes:
    one query row of its 128-row tile."""
    prompts = _prompts()
    S = max(len(p) for p in prompts) + GENERATE["steps"]
    row = _time_decode_at(gen, *DECODE_SHAPES["llama2-7b"],
                          [len(p) + 16 for p in prompts], S)
    row["at_other_shapes"] = [
        _time_decode_at(gen, *G7_ATTN, [len(p) + 16 for p in prompts[:4]],
                        S),
        _time_decode_at(gen, *WHISPER_ATTN, [WHISPER_FRAMES] * 8,
                        WHISPER_FRAMES),
        _time_decode_at(gen, *D80_ATTN, [GENERATE_HYBRID["prompt"] + 16]
                        * GENERATE_HYBRID["batch"], D80_DECODE_SLOTS)]
    t = row["tiles"]
    row["note"] = (f"the flash forward kernel at Sq = 1: one query row fills "
                   f"1 of its 128-row wgmma tile (two 64-row consumer "
                   f"warpgroups), so 127/128 of its tensor-core products "
                   f"are wasted; it loads {t['key_tiles']} 128-key tiles "
                   f"for {t['live_keys']} live keys per head. The reference "
                   f"has no Pallas kernel here (src/repro/kernels/ops.py:43, "
                   f"ref.decode_attention_reference)")
    return row


def _time_decode_at(gen, H, KV, D, ctx, S, dtype="bfloat16"):
    """decode_attention (bf16 unless `dtype`), one query row per sequence
    over contexts `ctx` of an S-slot cache, beside its plain version and
    SDPA with a key mask, and the kernel's tiles: the wgmma forward's 128
    query rows x 128 keys (bf16 at D 64, 80, 128), the 3xTF32 kernel's 64
    rows x 64 keys (32 at D 128; f32, and bf16 at D 32), where the one
    row's warp alone computes."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_prefill as fp
    B = len(ctx)
    q, k, v, lens, _ = _flash_case(gen, H, KV, D, getattr(torch, dtype), B,
                                   1, S, ctx, 0)
    ms = _time_ms(lambda: fp.decode_attention(q, k, v, lens))
    plain = _time_ms(lambda: fp.decode_attention_plain(q, k, v, lens),
                     reps=5)
    mask = (torch.arange(S, device="cuda")[None] < lens[:, None])[
        :, None, None]                                   # (B, 1, 1, S)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib = _time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=KV != H))
    n = sum(ctx)
    es = q.element_size()
    nbytes = n * 2 * KV * D * es + 2 * B * H * D * es + B * 4
    row = _flash_bound(ms, plain, lib, nbytes, 4 * H * D * n, dtype,
                       f"B={B} Sq=1 ctx {min(ctx)}-{max(ctx)} of {S} H={H} "
                       f"KV={KV} D={D} {_short(dtype)}")
    row["kernel"] = _flash_kernel(D, dtype=dtype)
    wgmma = dtype == "bfloat16" and D != 32
    rows, keys = (128, 128) if wgmma else (64, 32 if D == 128 else 64)
    row["tiles"] = {"query_rows_used": 1, "query_rows_per_tile": rows,
                    "key_tiles": sum(-(-c // keys) for c in ctx),
                    "live_keys": n}
    return row


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
    `route` ("mma": the bf16 tensor-core kernel, "tf32": the 3xTF32 one):
    one launch on that route's counter, none on the other's. With
    `route` None (another checkout's wrapper, tools/paged_ab.py) just
    run it."""
    from repro_torch.kernels import paged_prefill as pp
    if route is None:
        return fn()
    before = (pp.launches_mma, pp.launches_tf32)
    out = fn()
    got = (pp.launches_mma - before[0], pp.launches_tf32 - before[1])
    if got != ((1, 0) if route == "mma" else (0, 1)):
        raise AssertionError(f"paged_prefill body: expected the {route} "
                             f"route, launches (mma, tf32) {got}")
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
    for bit. Every call's body must take its route (`_pp_route_call`):
    the bf16 tensor-core kernel for bf16 at D 64 and 128, the 3xTF32 one
    for f32 and for bf16 at D 32. Returns the worst error per dtype for
    each variant, for each body route and for the staging."""
    import torch
    from repro_torch.kernels import paged_prefill as pp
    from repro_torch.serving.executor import MIXED_TQ as TQ
    BS = 16
    worst = {"paged_prefill": {}, "paged_prefill_tiered": {},
             "stage_host_blocks": {}, "paged_prefill_mma": {},
             "paged_prefill_tf32": {}}
    for arch, (H, KV, D) in sizes.items():
        for dtype in (torch.bfloat16, torch.float32):
            tol = TOL[str(dtype).split(".")[1]]
            key = str(dtype)[6:]
            route = "mma" if dtype == torch.bfloat16 and D >= 64 else "tf32"
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


def _time_pp_one_pool(gen, H, KV, D, dtype, C, off, route, BS=16,
                      two_pools=False):
    """One layer's chunk attention over the device pool: a C-token chunk
    at offset `off` (kv_len off + C), tq = MIXED_TQ, held against the
    plain version with its body on `route` asserted (`_pp_route_call`),
    then timed beside the plain version, with its bound (`_flash_bound`:
    an f32 row at the 3xTF32 floor, its f32 FMA bound beside it). With
    `two_pools` the same blocks also lie in the pinned host pool, and the
    two-pool call as the executor issues it (`staged_two_pool_call`) is
    held against the one-pool call bit for bit and timed instead.
    Returns the timing row."""
    import torch
    from repro_torch.kernels import paged_prefill as pp
    from repro_torch.serving.executor import MIXED_TQ as TQ
    q, seg, pos, klen, _, maxb = _pp_batch(gen, H, KV, D, dtype, [(off, C)])
    pool = torch.randn(4 * maxb, BS, 2, KV, D, generator=gen,
                       device="cuda").to(dtype)
    tab = torch.randperm(4 * maxb, generator=gen, device="cuda")[:maxb] \
        .reshape(1, maxb).int()

    def call():
        return pp.paged_prefill(q, pool, tab, seg, pos, klen, tq=TQ)
    kw = {}
    if two_pools:
        one = call
        hpool = pool.cpu().pin_memory()
        tier = torch.ones(1, dtype=torch.bool, device="cuda")
        runs = pp.host_block_runs(tab.cpu(), klen.cpu(), tier.cpu(), BS,
                                  hpool.shape[0])
        staged = torch.empty((maxb, BS, 2, KV, D), dtype=dtype,
                             device="cuda")
        kw = {"host_pool": hpool, "tier": tier}

        def call():
            return staged_two_pool_call(hpool, runs, staged, lambda:
                                        pp.paged_prefill(
                                            q, pool, tab, seg, pos, klen,
                                            tq=TQ, staged=staged, tier=tier))
    got = _pp_route_call(route, call)
    want = pp.paged_prefill_plain(q, pool, tab, seg, pos, klen, tq=TQ, **kw)
    torch.cuda.synchronize()
    key = str(dtype)[6:]
    err, ok = _max_err(got, want, TOL[key])
    if not ok or not torch.isfinite(got).all():
        raise AssertionError(f"paged_prefill {route} disagrees: H {H} KV "
                             f"{KV} D {D} {key}, err {err}")
    if two_pools and not torch.equal(got, one()):
        raise AssertionError(f"two pools differ from one pool on the same "
                             f"blocks: H {H} KV {KV} D {D} {key}")
    esize = q.element_size()
    kvl = off + C
    kv_bytes = kvl * 2 * KV * D * esize
    nbytes = 2 * q.numel() * esize + kv_bytes + maxb * 4 \
        + 2 * q.shape[0] * 4 + 4
    flops = 4 * D * H * _flash_pairs(C, [off], [kvl])
    t = _flash_bound(_time_ms(call), _time_ms(lambda: pp.paged_prefill_plain(
        q, pool, tab, seg, pos, klen, tq=TQ, **kw), reps=5), None, nbytes,
        flops, key,
        f"T={C} at offset {off} (kv_len {kvl}) H={H} KV={KV} D={D} "
        f"{_short(key)} BS={BS} tq={TQ}" + (
            " (K/V in the pinned host pool; staging from a host-side list, "
            "then the body; bit-identical to one pool)" if two_pools
            else ""))
    t["max_abs_err"] = err
    t["dtype"] = key
    if two_pools:   # the same K/V bytes over PCIe Gen5 x16 (spec, one way)
        t["bound_ms_pcie"] = kv_bytes / PCIE_BYTES_PER_S * 1e3
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
    The bf16 tensor-core body is also
    timed at granite-3-2b's heads (H 32, KV 8, D 64) on the same chunk,
    and the 3xTF32 body at the smoke paths' shape (granite-3-2b smoke,
    D 32: a 64-token chunk at offset 64) in bf16, their dtype, and in
    f32, and in f32 on the same chunk at llama2-7b's heads (one pool and
    two) and at granite-3-2b's. Returns the rows of paged_prefill,
    paged_prefill_tiered, stage_host_blocks and of the two body kernels,
    paged_prefill_mma and paged_prefill_tf32."""
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
    # the 3xTF32 body: its main path's row (fused-smoke's shape, bf16),
    # then f32 at D 32 and at the fused path's chunk, one pool and two
    smoke = SMOKE_SHAPES["granite-3-2b smoke"]
    rows = [_time_pp_one_pool(gen, *smoke, dt, 64, 64, "tf32")
            for dt in (torch.bfloat16, torch.float32)]
    rows += [_time_pp_one_pool(gen, *FLASH_SHAPES[arch], torch.float32, C,
                               off, "tf32", two_pools=two)
             for arch, two in (("llama2-7b", False), ("granite-3-2b", False),
                               ("llama2-7b", True))]
    out["paged_prefill_tf32"] = dict(rows[0], at_other_shapes=rows[1:])
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
    H = KV = 16, D 128), llama2-7b's (B 1, S 1024) and train-vlm's
    (B 4, S 1024, G = 7: H 28, KV 4, D 128), at whisper-base's training
    batch of 8: non-causal at its encoder (1500 x 1500) and
    cross-attention (448 rows over 1500 frames), causal at its decoder
    (448 tokens); the same G = 7 and whisper cases at B 1 and 2, and at
    the edges of the kernels' tiling: Sq and Skv off the 64-row grid (a
    chunk at q_offset 37), a sliding window, and G in {1, 4, 8} at D in
    {64, 128}; zamba2-2.7b's D = 80 (H = KV = 32) at train-hybrid's B 4
    x S 1024 and at the two edge cases; train_tiny's G = 3 (TINY_ATTN)
    at its B 4 x S 256 and at the chunk edge case; bf16 and f32. With
    `sizes`
    ({name: (H, KV, D)}), B 1 S 512 and the two edge cases at those
    shapes only. Returns the worst error per dtype."""
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
    T, F = WHISPER_TEXT, WHISPER_FRAMES
    Bv, Sv, Be = TRAIN_VLM["batch"], TRAIN_VLM["seq"], ENCDEC["batch"]
    cases += [("train-vlm qwen2-vl-7b G=7", 1, G7_ATTN, S, S, 0, 0),
              ("G=7 Sq 1000 Skv 1037 q_offset 37", 1, G7_ATTN, 1000, 1037,
               37, 0),
              ("whisper-base encoder", 1, WHISPER_ATTN, F, F, 0, 0, False),
              ("whisper-base cross", 2, WHISPER_ATTN, T, F, 0, 0, False),
              ("train-vlm qwen2-vl-7b G=7 at its batch", Bv, G7_ATTN, Sv,
               Sv, 0, 0),
              ("whisper-base encoder at its batch", Be, WHISPER_ATTN, F, F,
               0, 0, False),
              ("whisper-base cross at its batch", Be, WHISPER_ATTN, T, F, 0,
               0, False),
              ("whisper-base decoder at its batch", Be, WHISPER_ATTN, T, T,
               0, 0),
              ("train-hybrid zamba2-2.7b D=80", TRAIN_HYBRID["batch"],
               D80_ATTN, TRAIN_HYBRID["seq"], TRAIN_HYBRID["seq"], 0, 0),
              ("D=80 Sq 1000 Skv 1037 q_offset 37", 1, D80_ATTN, 1000,
               1037, 37, 0),
              ("D=80 window 200", 1, D80_ATTN, 1000, 1037, 37, 200),
              ("train_tiny TINY_100M G=3", EXAMPLES["tiny_batch"],
               TINY_ATTN, EXAMPLES["tiny_seq"], EXAMPLES["tiny_seq"], 0, 0),
              ("G=3 Sq 1000 Skv 1037 q_offset 37", 1, TINY_ATTN, 1000, 1037,
               37, 0),
              ("G=3 window 200", 1, TINY_ATTN, 1000, 1037, 37, 200),
              # 5 query rows (one warp's 16 partly live) over 37 keys (a
              # 16-key tile and 5 rows past two)
              ("G=3 Sq 5 Skv 37 q_offset 32", 2, TINY_ATTN, 5, 37, 32, 0)]
    if sizes is not None:
        cases = [c for name, hkd in sizes.items() for c in (
            (name, 1, hkd, 512, 512, 0, 0),
            (f"{name} Sq 1000 Skv 1037 q_offset 37", 1, hkd, 1000, 1037,
             37, 0),
            (f"{name} window 200", 1, hkd, 1000, 1037, 37, 200))]
    for name, B, (H, KV, D), Sq, Skv, q_off, window, *c in cases:
        causal = c[0] if c else True
        for dtype in (torch.bfloat16, torch.float32):
            key = str(dtype)[6:]
            tol = TOL[key]
            q, k, v, _, _ = _flash_case(gen, H, KV, D, dtype, B, Sq, Skv,
                                        [Skv], 0)
            do = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
            kw = dict(q_offset=q_off, window=window, causal=causal)
            got = _flash_grads(fp.flash_attention, q, k, v, do, **kw)
            want = _flash_grads(fp.flash_attention_plain, q, k, v, do, **kw)
            torch.cuda.synchronize()
            res = [_max_err_grad(g, p, tol) for g, p in zip(got, want)]
            err, ok = max(r[0] for r in res), all(r[1] for r in res)
            each = ", ".join(f"{n} {e:.3g} of max |{n}| {m:.3g}"
                             for n, (e, _, m) in zip(("dq", "dk", "dv"), res))
            _say(f"[kernels] flash_attention_bwd {name} B={B} Sq={Sq} "
                 f"Skv={Skv} H={H} KV={KV} D={D} {key} "
                 f"{'causal' if causal else 'non-causal'}: max_abs_err "
                 f"{err:.3g} (tol {tol}, grad: {each})")
            if not ok:
                raise AssertionError(f"flash backward disagrees: {name} "
                                     f"{dtype} err {err}")
            worst[key] = max(worst.get(key, 0.0), err)
            del q, k, v, do, got, want
    return worst


def _norm_inputs(gen, shape, dtype="bfloat16"):
    import torch
    d = shape[-1]
    dt = getattr(torch, dtype)
    x = torch.randn(shape, generator=gen, device="cuda").to(dt)
    w = (1 + 0.1 * torch.randn(d, generator=gen, device="cuda")).to(dt)
    return x, w, x.numel() // d, d


def time_rmsnorm_fwd(gen, shape, dtype="bfloat16"):
    """The RMSNorm forward at `shape` (bf16 unless `dtype`) beside its
    plain version and F.rms_norm."""
    import torch.nn.functional as F
    from repro_torch.kernels import rmsnorm as rn
    x, w, rows, d = _norm_inputs(gen, shape, dtype)
    n, e = rows * d, x.element_size()
    return _bound(
        _time_ms(lambda: rn.rmsnorm(x, w)),
        _time_ms(lambda: rn.rmsnorm_plain(x, w), reps=5),
        _time_ms(lambda: F.rms_norm(x, (d,), w, eps=1e-6)),
        2 * n * e + d * e, 4 * n, F32_FLOPS_PER_S,
        f"{rows} rows x d={d} {_short(dtype)}")


def time_rmsnorm_bwd(gen, shape, dtype="bfloat16"):
    """The RMSNorm backward at `shape` (bf16 unless `dtype`) beside
    autograd through its plain version and through F.rms_norm."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import rmsnorm as rn
    x, w, rows, d = _norm_inputs(gen, shape, dtype)
    n, e = rows * d, x.element_size()
    dy = torch.randn(shape, generator=gen, device="cuda").to(x.dtype)
    _, rstd = rn._forward(x, w, 1e-6, keep_rstd=True)

    def grad_ms(fn, reps):
        xg, wg = (t.clone().requires_grad_() for t in (x, w))
        y = fn(xg, wg)
        return _time_ms(lambda: torch.autograd.grad(
            y, (xg, wg), dy, retain_graph=True), reps=reps)
    return _bound(
        _time_ms(lambda: rn.rmsnorm_bwd(dy, x, w, rstd)),
        grad_ms(rn.rmsnorm_plain, 5),
        grad_ms(lambda a, b: F.rms_norm(a, (d,), b, eps=1e-6), 20),
        3 * n * e + 2 * d * e + n // d * 4, 10 * n, F32_FLOPS_PER_S,
        f"{rows} rows x d={d} {_short(dtype)}")


def time_rmsnorm(gen):
    """RMSNorm at the train path's activations (4096 rows of 2048, bf16):
    the forward and the backward, each beside its plain version and
    F.rms_norm (forward; its autograd backward). The forward's row also
    holds its times at llama2-7b's serve shapes ("at_serve_shapes": a
    1024-token prefill and an 8-row decode step, 4096 wide), where the
    serve path's launches run, and both rows at qwen2-vl-7b's d 3584,
    zamba2-2.7b's d 2560 and 5120 and xlstm-1.3b's d 4096
    ("at_other_shapes": the train paths' 4 x 1024 rows, and for the
    forward the generate paths' 4-row decode steps, xlstm-1.3b's at d
    2048 and 4096; then the examples' f32 training norms, train_tiny's d
    768 and quickstart's d 256, both ways)."""
    examples = ("train_tiny d 768", "quickstart d 256")
    other_train = ("qwen2-vl-7b train", "zamba2-2.7b train d 2560",
                   "zamba2-2.7b train d 5120", "xlstm-1.3b train d 4096")
    other_decode = ("qwen2-vl-7b decode", "zamba2-2.7b decode d 2560",
                    "zamba2-2.7b decode d 5120", "xlstm-1.3b decode d 2048",
                    "xlstm-1.3b decode d 4096")
    fwd = time_rmsnorm_fwd(gen, NORM_SHAPES["train"])
    fwd["at_serve_shapes"] = [
        time_rmsnorm_fwd(gen, NORM_SHAPES[k])
        for k in ("llama2-7b prefill", "llama2-7b decode")]
    fwd["at_other_shapes"] = [time_rmsnorm_fwd(gen, NORM_SHAPES[k])
                              for k in other_train + other_decode] + [
        time_rmsnorm_fwd(gen, NORM_SHAPES[k], "float32") for k in examples]
    bwd = time_rmsnorm_bwd(gen, NORM_SHAPES["train"])
    bwd["at_other_shapes"] = [time_rmsnorm_bwd(gen, NORM_SHAPES[k])
                              for k in other_train] + [
        time_rmsnorm_bwd(gen, NORM_SHAPES[k], "float32") for k in examples]
    return fwd, bwd


def time_flash_bwd(gen):
    """The flash backward at the train path's shape (B 4, S 1024, H 32,
    KV 8, D 64, bf16, causal), beside autograd through the plain version
    and the backward of scaled_dot_product_attention with enable_gqa;
    the same at the MoE train path's shape (H = KV = 16, D 128) under
    "at_moe_train_shape", and at train-vlm's G = 7 (B 4, S 1024) and
    whisper-base's non-causal cross-attention (B 8, 448 rows over 1500
    frames) and train-hybrid's D = 80 (B 4, S 1024, H = KV = 32) and the
    f32 route (3xTF32) at train_tiny's G = 3 (B 4, S 256) and
    granite-3-2b's train shape, and at quickstart's (the smoke heads at
    D 32, B 8 x S 64) in f32 and bf16, under "at_other_shapes"; each row
    names its kernels ("kernel")."""
    rows = [_time_flash_bwd_at(gen, *FLASH_SHAPES["granite-3-2b"],
                               TRAIN["batch"], TRAIN["seq"]),
            _time_flash_bwd_at(gen, *MOE_TRAIN_ATTN, TRAIN_MOE["batch"],
                               TRAIN_MOE["seq"])]
    rows[0]["at_moe_train_shape"] = rows[1]
    rows[0]["at_other_shapes"] = [
        _time_flash_bwd_at(gen, *G7_ATTN, TRAIN_VLM["batch"],
                           TRAIN_VLM["seq"]),
        _time_flash_bwd_at(gen, *WHISPER_ATTN, ENCDEC["batch"],
                           WHISPER_TEXT, WHISPER_FRAMES, causal=False),
        _time_flash_bwd_at(gen, *D80_ATTN, TRAIN_HYBRID["batch"],
                           TRAIN_HYBRID["seq"]),
        _time_flash_bwd_at(gen, *TINY_ATTN, EXAMPLES["tiny_batch"],
                           EXAMPLES["tiny_seq"], dtype="float32"),
        _time_flash_bwd_at(gen, *FLASH_SHAPES["granite-3-2b"],
                           TRAIN["batch"], TRAIN["seq"], dtype="float32")] + [
        _time_flash_bwd_at(gen, *SMOKE_SHAPES["granite-3-2b smoke"],
                           QUICK_TRAIN[0], QUICK_TRAIN[1], dtype=dtype)
        for dtype in ("float32", "bfloat16")]
    rows[0]["routes"] = _flash_routes(bwd=True)
    return rows[0]


def _time_flash_bwd_at(gen, H, KV, D, B, S, Skv=None, causal=True,
                       dtype="bfloat16"):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_prefill as fp
    Skv = Skv or S
    q, k, v, _, _ = _flash_case(gen, H, KV, D, getattr(torch, dtype), B, S,
                                Skv, [Skv] * B, 0)
    do = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
    out, lse = fp._launch_fwd(q, k, v, causal, 0, None, 0, D ** -0.5,
                              keep_lse=True)
    ms = _time_ms(lambda: fp.flash_attention_bwd(q, k, v, out, do, lse,
                                                 causal=causal))

    def grad_ms(fn, leaves, g, reps):
        leaves = [t.clone().requires_grad_() for t in leaves]
        y = fn(*leaves)
        return _time_ms(lambda: torch.autograd.grad(
            y, leaves, g, retain_graph=True), reps=reps)
    plain = grad_ms(lambda a, b, c: fp.flash_attention_plain(
        a, b, c, causal=causal), (q, k, v), do, 3)
    lib = grad_ms(lambda a, b, c: F.scaled_dot_product_attention(
        a, b, c, is_causal=causal, enable_gqa=KV != H),
        [t.transpose(1, 2).contiguous() for t in (q, k, v)],
        do.transpose(1, 2).contiguous(), 20)
    nbytes = (4 * q.numel() + 4 * k.numel()) * q.element_size() \
        + lse.numel() * 4
    # five products of 2 * D operations per visible (query, key) pair:
    # S and dP recomputed, dV, dQ, dK
    pairs = _flash_pairs(S, [0] * B, [Skv] * B) if causal else B * S * Skv
    row = _flash_bound(ms, plain, lib, nbytes, 10 * D * H * pairs, dtype,
                       f"B={B} Sq={S} Skv={Skv} H={H} KV={KV} D={D} "
                       f"{_short(dtype)} "
                       f"{'causal' if causal else 'non-causal'}")
    row["kernel"] = _flash_kernel(D, bwd=True, dtype=dtype)
    return row


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
    dec_err = check_decode(gen)
    paged_err = check_paged(gen)
    pp_err = check_paged_prefill(gen)
    norm_err = check_rmsnorm(gen)
    fbwd_err = check_flash_bwd(gen)
    torch.cuda.empty_cache()
    flash_t = time_flash(gen)
    dec_t = time_decode(gen)
    paged_t = time_paged(gen)
    pp_t = time_paged_prefill(gen)
    norm_t, norm_bwd_t = time_rmsnorm(gen)
    fbwd_t = time_flash_bwd(gen)
    torch.cuda.empty_cache()
    for name in ("paged_prefill", "paged_prefill_tiered",
                 "paged_prefill_mma", "paged_prefill_tf32"):
        # the timed shapes' checks count too, each in its dtype
        for t in [pp_t[name]] + pp_t[name].get("at_other_shapes", []):
            key = t.get("dtype", "bfloat16")
            pp_err[name][key] = max(pp_err[name].get(key, 0.0),
                                    t["max_abs_err"])
    res = {"flash_attention": (flash_err, flash_t),
           "decode_attention": (dec_err, dec_t),
           "paged_attention": (paged_err, paged_t),
           "paged_prefill": (pp_err["paged_prefill"],
                             pp_t["paged_prefill"]),
           "paged_prefill_tiered": (pp_err["paged_prefill_tiered"],
                                    pp_t["paged_prefill_tiered"]),
           "stage_host_blocks": (pp_err["stage_host_blocks"],
                                 pp_t["stage_host_blocks"]),
           "paged_prefill_mma": (pp_err["paged_prefill_mma"],
                                 pp_t["paged_prefill_mma"]),
           "paged_prefill_tf32": (pp_err["paged_prefill_tf32"],
                                  pp_t["paged_prefill_tf32"]),
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
            fma = (f", at the f32 FMA peak {also['bound_ms_f32_fma']:.4f}"
                   if "bound_ms_f32_fma" in also else "")
            err = (f", max_abs_err {also['max_abs_err']:.3g}"
                   if "max_abs_err" in also else "")
            _say(f"[kernels] {name} [{also['shape']}]: kernel_ms "
                 f"{also['ms']:.4f} plain_ms {also['plain_ms']:.4f} "
                 f"library_ms {lib(also)} bound_ms "
                 f"{also['bound_ms']:.4f} ({also['bound_by']}{fma}){err}")
    b1 = paged_t["at_b1_ctx4096"]
    _say(f"[kernels] paged_attention [{b1['shape']}]: kernel_ms "
         f"{b1['ms']:.4f} plain_ms {b1['plain_ms']:.4f} bound_ms "
         f"{b1['bound_ms']:.4f} ({b1['bound_by']})")
    _say(f"[kernels] paged_attention: {paged_t['note']}")
    _say(f"[kernels] decode_attention: {dec_t['note']}")
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
    pp.launches_mma = pp.launches_tf32 = 0
    fp.launches_bwd = fp.launches_decode = rn.launches = rn.launches_bwd = 0


def _launches():
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import paged_prefill as pp
    from repro_torch.kernels import rmsnorm as rn
    return {"flash_attention": fp.launches,
            "decode_attention": fp.launches_decode,
            "paged_attention": pa.launches,
            "paged_prefill": pp.launches,
            "paged_prefill_tiered": pp.launches_tiered,
            "stage_host_blocks": pp.launches_stage,
            "paged_prefill_mma": pp.launches_mma,
            "paged_prefill_tf32": pp.launches_tf32,
            "rmsnorm": rn.launches, "rmsnorm_bwd": rn.launches_bwd,
            "flash_attention_bwd": fp.launches_bwd}


def _staging(eng):
    """The staging counters since `_zero_launches` (the copy-engine runs
    and the host seconds of listing and issuing them) and the device
    bytes engine `eng`'s two staging buffers hold."""
    from repro_torch.kernels import paged_prefill as pp
    return {"staging_bytes": eng.ex.staging_bytes,
            "stage_runs": pp.stage_runs, "stage_host_s": pp.stage_host_s}


def _graph_stats(ex):
    """Executor `ex`'s compiled steps (`serving.executor._StepGraph`):
    signatures captured, steps replayed, steps run eagerly by reason, the
    device bytes its captures reserved in the graph pool, and its novel
    signatures of the steps it compiles (dense decode, host-free
    fused)."""
    return {"captures": ex.graph_captures, "replays": ex.graph_replays,
            "eager_steps": dict(ex.eager_steps),
            "graph_pool_bytes": ex.graph_pool_bytes,
            "compiled_signatures": sum(
                1 for fn, sig in ex._jit_sigs
                if fn == "decode" or (fn == "mixed" and not sig[-1]))}


def _say_graphs(tag, name, g):
    _say(f"[{tag}] {name} compiled steps: {g['captures']} graphs captured "
         f"of {g['compiled_signatures']} compiled signatures, "
         f"{g['replays']} replays, eager steps {g['eager_steps']}, graph "
         f"pool {g['graph_pool_bytes']} bytes")


def _check_graphs(tag, g):
    """The run's steps replayed graphs, at most one capture a signature,
    and no step ran eagerly but a signature's first or a host-tier
    one."""
    ok = (g["replays"] > 0 and g["captures"] <= g["compiled_signatures"]
          and set(g["eager_steps"]) <= {"first", "host-tier"})
    if not ok:
        raise AssertionError(f"[{tag}] compiled steps: {g}")


def bf16_step(x: float) -> float:
    """The gap between bf16 `x` (x != 0) and the next bf16 value away
    from 0: 2 ** (e - 8) for |x| in [2 ** (e - 1), 2 ** e) (7 stored
    mantissa bits)."""
    import math
    return 2.0 ** (math.frexp(abs(x))[1] - 8)


def solo_top2(ex, prompt):
    """The two largest logits at the last position of `prompt` prefilled
    alone through executor `ex` (B = 1, exclusive prefill, `ex`'s
    weights): ((token, logit), (token, logit)). The logits are the final
    features' product with the head taken in f32: the model's bf16 logits
    round both values, which can widen their gap by up to one step."""
    from repro_torch.models.model import mask_pad_logits
    model = ex.model
    cfg, p = model.cfg, model.params
    w = p["embed"].T if cfg.tie_embeddings else p["lm_head"]
    last = []
    bf16_unembed = model.unembed

    def unembed(x):
        logits = mask_pad_logits(cfg, x.float() @ w.float())
        last.append(logits.reshape(-1, logits.shape[-1])[-1])
        return bf16_unembed(x)
    model.unembed = unembed
    try:
        ex.prefill(prompt, len(prompt))
    finally:
        del model.unembed
    top = last[-1].topk(2)
    return tuple(zip(top.indices.tolist(), top.values.tolist()))


def check_first_tokens(tag, ex, prompts, got, want):
    """Hold the first tokens `got[rid]` against `want[rid]` (rid "r{i}"
    for prompts[i]; a rid in `got` only) and tell a near-tie from a
    fault. Where they differ, prompt i is prefilled alone (`solo_top2`,
    through executor `ex`: B = 1, exclusive prefill, the same weights) and
    the difference is accepted only if the two first tokens are that
    prefill's two largest logits and their gap is at most one bf16 step
    at the larger one's magnitude (`bf16_step`): the smallest non-zero
    gap two bf16 logits can have, so the two runs' bf16 roundings may
    order them either way. Any other difference raises, as does a
    difference with no prompt to prefill. Exact equality stays the check
    for every request whose tokens agree. Prints each accepted near-tie
    on its own line; returns them (rid, the two tokens, the two logits,
    the gap)."""
    ties, faults = [], []
    for rid in got:
        if got[rid] == want[rid]:
            continue
        i = int(rid[1:]) if rid[1:].isdigit() else -1
        if not 0 <= i < len(prompts):
            faults.append(rid)
            continue
        (t0, l0), (t1, l1) = solo_top2(ex, prompts[i])
        gap = l0 - l1
        if {got[rid], want[rid]} != {t0, t1} or gap > bf16_step(l0):
            faults.append(f"{rid} ({got[rid]} vs {want[rid]}; alone: top "
                          f"{t0} {l0:.6g}, {t1} {l1:.6g})")
            continue
        tie = {"rid": rid, "tokens": [t0, t1], "logits": [l0, l1],
               "gap": gap, "bf16_step": bf16_step(l0)}
        ties.append(tie)
        _say(f"[{tag}] near-tie accepted: {rid} tokens {t0} / {t1}, "
             f"logits {l0:.6g} / {l1:.6g}, gap {gap:.6g} <= one bf16 step "
             f"{bf16_step(l0):.6g}")
    if faults:
        raise AssertionError(f"[{tag}] first tokens differ, not a near-tie:"
                             f" {faults}")
    return ties


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
    if launches["paged_prefill_mma"] + launches["paged_prefill_tf32"] != \
            launches["paged_prefill"] + launches["paged_prefill_tiered"]:
        raise AssertionError(f"one body launch per paged_prefill call: "
                             f"{launches}")
    if eng.ex.nonfinite_logits():
        raise AssertionError("non-finite logits on the layerkv run")
    host_steps = sum(1 for fn, sig in eng.ex._jit_sigs
                     if fn == "mixed" and sig[-1])
    graphs = _graph_stats(eng.ex)
    _say_graphs(tag, "layerkv", graphs)
    if on_cuda and tag in GRAPH_PATHS:
        _check_graphs(tag, graphs)
    lk_tokens = {r.rid: list(r.generated) for r in done}
    params = eng.ex.params

    # ---- reference run: vllm on a pool that fits every request whole
    del eng, done
    eng_v, done_v, st_v = _serve(cfg, params, "vllm", ndb_ref, 16, prompts,
                                 out_len, seed=0, device=device, **ec_kw)
    if eng_v.ex.nonfinite_logits():
        raise AssertionError("non-finite logits on the vllm run")
    graphs_v = _graph_stats(eng_v.ex)
    _say_graphs(tag, "vllm", graphs_v)
    v_tokens = {r.rid: list(r.generated) for r in done_v}
    ties = check_first_tokens(
        tag, eng_v.ex, prompts, {rid: t[0] for rid, t in lk_tokens.items()},
        {rid: t[0] for rid, t in v_tokens.items()})
    agree = sum(a == b for rid in lk_tokens
                for a, b in zip(lk_tokens[rid], v_tokens[rid]))
    total = sum(len(t) for t in lk_tokens.values())
    _say(f"[{tag}] first tokens identical to vllm for "
         f"{len(lk_tokens) - len(ties)} of {len(lk_tokens)} requests, "
         f"{len(ties)} near-ties accepted; full-stream agreement "
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
            "host_tier_signatures": host_steps, "near_ties": ties,
            "graphs": graphs, "graphs_vllm": graphs_v,
            "tokens": lk_tokens, "params": params}


# device blocks of the smoke paths' layerkv runs (2 layers, 16-token blocks)
SMOKE_NDB = 24
# the full-size paths whose layerkv run must replay captured steps
GRAPH_PATHS = ("serve", "fused", "moe")
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
                                 "stage_host_blocks", "paged_prefill_tf32",
                                 "paged_attention", "rmsnorm")),
    # Eq. 4 keeps both layers of this 2-layer model on the device at these
    # prompts, so no chunk reads the host pool (fused-smoke's do)
    "moe-smoke": dict(arch="deepseek-moe-16b", smoke=True, n=6, seed=2,
                      prompt_lens=(40, 160), out_len=8, ndb=SMOKE_NDB,
                      ndb_ref=1024, nhb=1024,
                      mode=dict(chunked=True, fused=True,
                                max_prefill_tokens=64),
                      kernels=("paged_prefill", "paged_prefill_tf32",
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
    KV 4), in bf16 (flash's and the paged prefill body's 3xTF32 kernels,
    which the dispatch picks by shape) and f32, on the
    kernels phase's cases. Returns the worst error per kernel and
    dtype."""
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
             "paged_prefill_tf32": pp["paged_prefill_tf32"],
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


# the graphs phase: a pool of `ndb` 16-token blocks; decode steps of
# `rows` rows at contexts in `ctx`; fused steps of chunks of `chunks`
# (tokens, offset) with `decode_rows` decode rows at contexts in `ctx`;
# `steps` steps of each signature (eager, captured + replayed, replayed)
GRAPHS = dict(ndb=2048, rows=8, ctx=(900, 1000), chunks=((200, 300),
                                                        (150, 0)),
              decode_rows=4, steps=3, seed=5)


def _graph_batches(cfg, kind, rng, g=GRAPHS, BS=16):
    """`g["steps"]` steps of one signature: decode (tokens, tables,
    kv_lens) or fused (chunks, decodes). Each step's rows take disjoint
    blocks of the pool (the same table in every layer: a layer's writes
    never share a slot, and the twin makes the same writes in the same
    order); tokens, blocks and contexts differ between steps."""
    import numpy as np
    from repro_torch.serving.executor import MixedChunk, MixedDecode
    L, out = cfg.n_layers, []
    for _ in range(g["steps"]):
        ids = iter(rng.permutation(g["ndb"]).tolist())
        if kind == "decode":
            nb = g["ctx"][1] // BS + 1
            row = [[next(ids) for _ in range(nb)]
                   for _ in range(g["rows"])]
            lens = rng.randint(g["ctx"][0], g["ctx"][1], g["rows"])
            out.append((rng.randint(0, cfg.vocab_size, g["rows"]).tolist(),
                        np.array([row] * L, np.int32), lens.tolist()))
            continue
        chunks = []
        for C, off in g["chunks"]:
            tab = [next(ids) for _ in range(-(-(off + C) // BS))]
            chunks.append(MixedChunk(
                rng.randint(0, cfg.vocab_size, C).tolist(), off, [tab] * L,
                [False] * L))
        decodes = []
        for _ in range(g["decode_rows"]):
            ctx = int(rng.randint(*g["ctx"]))
            tab = [next(ids) for _ in range(ctx // BS + 1)]
            decodes.append(MixedDecode(int(rng.randint(0, cfg.vocab_size)),
                                       ctx, [tab] * L))
        out.append((chunks, decodes))
    return out


def check_step_graphs(cfg, params, device="cuda", g=GRAPHS):
    """Hold an executor's compiled steps against the same steps run
    eagerly: an executor on `params` (random weights from a seed if None)
    whose pool holds random values, and a twin with its weights and a
    copy of its pool. For each of a dense decode signature and a
    host-free fused one, `g["steps"]` steps (`_graph_batches`); each is
    run again by the twin on fresh tensors of the host arrays the step
    filled its static inputs from (`_paged_decode`, `_mixed_forward`):
    tokens equal, logits and the pool (but the trash block, padded rows'
    garbage) bit for bit. On CUDA the first step of a signature runs
    eagerly, the second is captured and replayed, the third replayed;
    on the CPU every step runs the static-buffer code eagerly. Raises on
    a mismatch; returns per kind the signature, the largest logit
    difference and the executor's compiled-step counts."""
    import numpy as np
    import torch
    from repro_torch.serving import executor as exm
    BS = 16
    ex = exm.PagedExecutor(cfg, params, g["ndb"], 16, BS, device=device,
                           seed=0)
    gen = torch.Generator(device=ex.device).manual_seed(g["seed"])
    ex.device_pool.copy_(torch.randn(ex.device_pool.shape, generator=gen,
                                     device=ex.device))
    twin = exm.PagedExecutor(cfg, ex.params, g["ndb"], 16, BS,
                             device=device)
    twin.device_pool.copy_(ex.device_pool)
    filled, seen = [], []
    run, note = exm._StepGraph.run, ex._note_logits

    def spy(self, arrays):
        filled.append({k: np.array(v) for k, v in arrays.items()})
        return run(self, arrays)
    ex._note_logits = lambda lg: (seen.append(lg.clone()), note(lg))
    rng = np.random.RandomState(g["seed"])
    cuda = torch.device(device).type == "cuda"
    out = {}
    exm._StepGraph.run = spy
    try:
        for kind in ("decode", "mixed"):
            step_fn = ex.decode if kind == "decode" else ex.mixed_step
            worst = 0.0
            for i, step in enumerate(_graph_batches(cfg, kind, rng, g)):
                got = step_fn(*step)
                sig = [s for fn, s in ex._graphs if fn == kind]
                if len(sig) != 1:
                    raise AssertionError(f"[graphs] {kind}: signatures "
                                         f"{sig}, not one")
                want = _graph_twin(twin, kind, filled[-1], sig[0])
                want = want[:len(got)]
                worst = max(worst, float((seen[-1].float()
                                          - want.float()).abs().max()))
                if got != torch.argmax(want, dim=-1).tolist() \
                        or not torch.equal(seen[-1], want) \
                        or not torch.equal(ex.device_pool[:g["ndb"]],
                                           twin.device_pool[:g["ndb"]]):
                    raise AssertionError(
                        f"[graphs] {kind} step {i} differs from the eager "
                        f"step: tokens equal {got == want.argmax(-1).tolist()}"
                        f", logits max |diff| {worst:.3g}")
            out[kind] = {"signature": sig[0], "max_abs_err": worst,
                         **_graph_stats(ex)}
            _say(f"[graphs] {cfg.arch_id} {kind} {sig[0]}: {g['steps']} "
                 f"steps equal the eager twin's (tokens, logits and pool "
                 f"bit for bit); {_graph_stats(ex)}")
    finally:
        exm._StepGraph.run = run
    if cuda and (ex.graph_captures, ex.graph_replays) != (
            2, 2 * (g["steps"] - 1)):
        raise AssertionError(f"[graphs] {_graph_stats(ex)}: not one "
                             f"capture per signature and a replay per "
                             f"later step")
    return out


def _graph_twin(twin, kind, a, sig):
    """Step `kind` of signature `sig` run eagerly by `twin` on fresh
    tensors of its host arrays `a`."""
    import numpy as np
    import torch
    dev = twin.device

    def t(name, dtype, n=None):
        return torch.as_tensor(np.array(a[name][:n]), dtype=dtype,
                               device=dev)
    i32, i64 = torch.int32, torch.int64
    if kind == "decode":
        return twin._paged_decode(t("tokens", i64), t("tables", i32),
                                  t("kv_lens", i32))
    L, Tc, Rb = twin.cfg.n_layers, sig[0], sig[2]
    return twin._mixed_forward(
        t("tokens", i64), t("q_pos", i32), t("off", i64), t("blk_dev", i64),
        [[] for _ in range(L)], t("c_seg", i32), t("q_pos", i32, Tc),
        t("c_kvlens", i32), t("c_tables", i32), t("c_tier", i32),
        t("d_tables", i32), t("d_kvlens", i32), t("sample_idx", i64),
        t("is_chunk", torch.bool), [None] * L, None, Tc, Rb)


def phase_graphs(params, tag="serve"):
    """The compiled steps of path `tag`'s model (llama2-7b, or
    deepseek-moe-16b for moe) at full width and depth against their
    eager steps (`check_step_graphs`), on that path's weights."""
    from repro_torch.configs import get_config
    t0 = time.perf_counter()
    out = check_step_graphs(get_config(PATHS[tag]["arch"]), params)
    _say(f"[graphs] {tag} phase {time.perf_counter() - t0:.1f}s")
    return out


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


def phase_moe(profile=False):
    """deepseek-moe-16b (arXiv:2401.06066) at full width and depth, bf16,
    random weights from a seeded generator on the card, served through
    the fused mixed step: MoE FFN (dropless, grouped by expert), paged
    prefill over one and two pools, paged decode; the decode and
    host-free fused steps through their CUDA graphs. Then its compiled
    steps against their eager twins on the same weights (`phase_graphs`,
    under "step_graphs" in the result) and, with `profile`, its traced decode
    step (`_profile_decode`)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import flatten_params
    cfg = get_config(PATHS["moe"]["arch"])
    m = cfg.moe
    _describe("moe", cfg)
    _say(f"[moe] {m.n_experts} routed experts top-{m.top_k} + "
         f"{m.n_shared} shared, d_expert={m.d_expert}, vocab "
         f"{cfg.vocab_size}")
    res, prompts, out_len = _run_path("moe", cfg, None, "cuda")
    n = sum(t.numel() for t in flatten_params(res["params"]).values())
    _say(f"[moe] {n / 1e9:.2f} B parameters")
    res["n_params"] = n
    gc.collect()                    # the path's engines and their pools
    torch.cuda.empty_cache()
    res["step_graphs"] = phase_graphs(res["params"], "moe")
    if profile:
        res["profile"] = _profile_decode(cfg, res["params"], prompts,
                                         out_len)
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
                    "graphs": _graph_stats(eng.ex),
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
    if torch.device(device).type == "cuda":
        for i, r in enumerate(per):
            _check_graphs(f"cluster r{i}", r["graphs"])
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
        ties = check_first_tokens(
            "cluster", engines[0].ex, prompts,
            {rid: streams[rid][0] for rid in sorted(before_kill)},
            {rid: ref_tokens[rid][0] for rid in before_kill})
        ties += check_first_tokens(
            "cluster, late request on the revived replica 0",
            engines[0].ex, prompts, {f"r{late}": late_tok[0]},
            {f"r{late}": ref_tokens[f"r{late}"][0]})
        res["near_ties"] = ties
        agree = sum(a == b for rid, t in streams.items()
                    for a, b in zip(t, ref_tokens[rid]))
        total = sum(len(t) for t in streams.values())
        res["agreement_fused"] = agree / total
        _say(f"[cluster] first tokens equal the fused run's for the "
             f"{len(before_kill)} requests that started before the kill "
             f"and for r{late} served again by the revived replica 0 "
             f"({len(ties)} near-ties accepted); "
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
    batches (`run_train`): finite losses and grad norms, a step-0 loss
    near ln(vocab), and RMSNorm and flash launches forward and
    backward."""
    import torch
    from repro_torch.configs import get_config
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
    out = run_train("train", cfg, B, S, steps, TRAIN_KERNELS)
    out["n_params"] = n_params
    if profile:
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
    dispatch, every block checkpointed (`run_train`: finite losses, grad
    norms and `lb_loss`, a step-0 `ce` near ln(vocab), 0 <= dropped_frac
    < 1, and the RMSNorm and flash kernels forward and backward). With
    `profile`, one more step under torch.profiler (`_profile_train`)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.moe import CAPACITY_FACTOR as cf
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
    out = run_train("train-moe", cfg, B, S, steps, TRAIN_KERNELS)
    out.update(n_params=n_params, n_layers=cfg.n_layers, capacity=C)
    if profile:
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
    from repro_torch.kernels import paged_attention as pa
    for _ in range(3):              # the prefill step, then two warm decodes
        session.step()              # (the second captures its graph)
    if len(eng.decoding) != len(prompts):
        raise AssertionError("profile window is not a full decode batch")
    before, g0 = pa.launches, _graph_stats(eng.ex)
    out = _trace(session.step, steps, kernels=("paged_decode_kernel",))
    out["batch"] = len(prompts)
    g1 = _graph_stats(eng.ex)
    out["graph_replays"] = g1["replays"] - g0["replays"]
    out["graph_captures"] = g1["captures"]
    out["graph_pool_bytes"] = g1["graph_pool_bytes"]
    traced = out["kernels"]["paged_decode_kernel"]["launches"]
    _say(f"[profile] {cfg.arch_id} vllm decode B={len(prompts)}: "
         f"{out['wall_ms_per_step']:.2f} ms wall/step, device busy "
         f"{out['device_busy_ms_per_step']:.2f} ms/step "
         f"({out['device_busy_share']:.3f}), "
         f"{out['device_ops_per_step']:.0f} device ops/step; "
         f"{out['graph_replays']} of {steps} steps replayed a graph "
         f"({g1['captures']} captured, pool {g1['graph_pool_bytes']} "
         f"bytes); paged_decode_kernel {traced} in the trace, "
         f"{pa.launches - before} counted")
    if traced != pa.launches - before:
        raise AssertionError(f"the trace shows {traced} paged decode "
                             f"launches, the counter "
                             f"{pa.launches - before}")
    for name, ms, n in out["top"]:
        _say(f"[profile]   {ms:8.3f} ms/step  x{n:<5d} {name[:90]}")
    return out


# the paged kernels of the serving paths, by the name the profiler shows
# (stage_host_blocks_kernel and paged_decode_combine: a tree from before
# the staging moved to the copy engine and the combine was folded in, as
# tools/paged_ab.py traces it)
PAGED_KERNELS = ("paged_prefill_mma", "paged_prefill_tf32",
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
    from repro_torch.models import build_model
    from repro_torch.training.data import DataConfig, SyntheticLM
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state
    from repro_torch.training.train_loop import make_train_step
    model = build_model(cfg, device="cuda", seed=0)
    model.requires_grad_(True)
    state = [init_opt_state(model.params)]
    step_fn = make_train_step(model, AdamWConfig(lr=1e-3))
    data = SyntheticLM(cfg, DataConfig(batch_size=B, seq_len=S),
                       device="cuda").batches()
    batches = [next(data), next(data)]

    def step():
        state[0], _ = step_fn(state[0], batches.pop())
    step()
    with _ssm_ranges() as ranges:
        out = _trace(step, 1, top=15, ranges=ranges)
    _say(f"[profile] train step {cfg.arch_id} {B} x {S}: "
         f"{out['wall_ms_per_step']:.1f} ms wall, device busy "
         f"{out['device_busy_ms_per_step']:.1f} ms "
         f"({out['device_busy_share']:.3f}), "
         f"{out['device_ops_per_step']:.0f} device ops")
    _say_ranges(f"train {cfg.arch_id}", "step", out)
    for name, ms, n in out["top"]:
        _say(f"[profile]   {ms:8.3f} ms  x{n:<5d} {name[:90]}")
    return out


# ------------------------------------------------------- Model API paths --

def _generate(model, batch, B, cache_len, steps, forced=None):
    """Prefill `batch` (B rows) into a fresh cache of `cache_len` slots, then
    `steps` decode steps, greedy or fed `forced` (B, steps) (another
    run's stream). Returns the tokens (B, steps + 1) as lists, each
    step's logits (f32), the prefill's wall seconds (TTFT of the batch)
    and each decode step's (TPOT), each ending in a synchronise."""
    import torch
    dev = model.device
    cache = model.init_cache(B, cache_len)
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = model.prefill(batch, cache)
    tok = logits.argmax(-1)
    _sync(dev)
    ttft = time.perf_counter() - t0
    toks, logs, step_s = [tok], [logits.float()], []
    for i in range(steps):
        ts = time.perf_counter()
        logits, cache = model.decode(tok if forced is None else forced[:, i],
                                     cache)
        tok = logits.argmax(-1)
        _sync(dev)
        step_s.append(time.perf_counter() - ts)
        toks.append(tok)
        logs.append(logits.float())
    nonfinite = sum(int(not torch.isfinite(x).all()) for x in logs)
    return {"tokens": torch.stack(toks, 1).tolist(), "logits": logs,
            "ttft_s": ttft, "tpot_s": step_s, "nonfinite_steps": nonfinite,
            "cache_bytes": sum(t.numel() * t.element_size()
                               for t in cache.values()
                               if isinstance(t, torch.Tensor))}


def _profile_generate(tag, model, batch, B, cache_len, steps=4):
    """torch.profiler over one prefill of `batch` and then `steps` greedy
    decode steps (after one untraced): wall, device-busy time and share,
    and the top device ops of each; for the hybrid and ssm families also
    the device span of each sequence core (`_ssm_ranges`)."""
    def prefill():
        state[:] = model.prefill(batch, model.init_cache(B, cache_len))

    def decode():
        state[:] = model.decode(state[0].argmax(-1), state[1])
    state = []
    with _ssm_ranges() as ranges:
        out = {"prefill": _trace(prefill, 1, top=8, ranges=ranges)}
        decode()
        out["decode"] = _trace(decode, steps, top=12,
                               kernels=("flash_fwd",), ranges=ranges)
    for name, t in out.items():
        _say(f"[profile] {tag} {name}: {t['wall_ms_per_step']:.2f} ms wall "
             f"per step, device busy {t['device_busy_ms_per_step']:.2f} ms "
             f"({t['device_busy_share']:.3f}), "
             f"{t['device_ops_per_step']:.0f} device ops per step")
        _say_ranges(tag, name, t)
        for op, ms, n in t["top"]:
            _say(f"[profile]   {ms:8.3f} ms  x{n:<5d} {op[:90]}")
    return out


# the sequence cores of models/ssm.py that `_ssm_ranges` marks in a trace
SSM_RANGES = ("ssd_chunked", "_mlstm_core_chunked", "slstm_forward")


@contextlib.contextmanager
def _ssm_ranges():
    """Inside the block, each sequence core of `repro_torch.models.ssm`
    (SSM_RANGES: the SSD, the chunked mLSTM, the sLSTM's per-token loop
    with its norm and out projection) runs inside a record_function range
    of its name, so a trace reads each core's device span (its forward
    only: autograd's backward runs outside it). Yields SSM_RANGES;
    restores the module's functions on exit."""
    from torch.profiler import record_function
    from repro_torch.models import ssm
    saved = {name: getattr(ssm, name) for name in SSM_RANGES}

    def marked(name, fn):
        def run(*a, **kw):
            with record_function(name):
                return fn(*a, **kw)
        return run
    try:
        for name, fn in saved.items():
            setattr(ssm, name, marked(name, fn))
        yield SSM_RANGES
    finally:
        for name, fn in saved.items():
            setattr(ssm, name, fn)


def _say_ranges(tag, name, t):
    """Print each marked core's device span per step and its share of the
    step's wall time."""
    for rng, v in t.get("ranges", {}).items():
        if v["calls"]:
            _say(f"[profile] {tag} {name}: {rng} x{v['calls']} "
                 f"{v['ms'] / t['steps']:.2f} ms per step "
                 f"({v['ms'] / t['steps'] / t['wall_ms_per_step']:.3f} of "
                 f"the wall)")


def _say_generate(tag, r):
    tp = sorted(r["tpot_s"])
    _say(f"[{tag}] TTFT (prefill of the batch) {r['ttft_s']:.4f} s; TPOT "
         f"median {tp[len(tp) // 2] * 1e3:.2f} ms (min {tp[0] * 1e3:.2f}, "
         f"max {tp[-1] * 1e3:.2f}); cache {r['cache_bytes'] / 1e9:.3f} GB; "
         f"launches {r['launches']}")


def _check_generate(tag, cfg, r, steps, device):
    """No logits went non-finite; on the card every flash launch is
    accounted for (one per self-attention layer in prefill; per decode
    step one decode_attention per self-attention layer, plus one flash
    call per cross-attention layer for encdec; the hybrid's layers with
    attention are its shared block's uses, xlstm has none) and the norms
    ran the RMSNorm kernel where the model has them."""
    import torch
    if r["nonfinite_steps"]:
        raise AssertionError(f"[{tag}] non-finite logits at "
                             f"{r['nonfinite_steps']} steps")
    if torch.device(device).type != "cuda":
        return
    L, n = cfg.n_attention_layers(), r["launches"]
    want_dec = L * steps
    want_flash = (L + want_dec if cfg.family != "encdec"
                  else cfg.n_encoder_layers + 2 * L + 2 * want_dec)
    if n["decode_attention"] != want_dec or n["flash_attention"] \
            != want_flash:
        raise AssertionError(f"[{tag}] launches {n}: expected "
                             f"decode_attention {want_dec}, flash_attention "
                             f"{want_flash}")
    if cfg.norm == "rmsnorm" and not n["rmsnorm"]:
        raise AssertionError(f"[{tag}] RMSNorm never launched")


def _decode_vs_teacher_forcing(tag, cfg, device, B, S, N, seed=0):
    """prefill(S) + N decodes against prefill(S + N): the last logits at
    rel < 5e-3 (tests/test_models.py's test_decode_matches_teacher_
    forcing), random weights and tokens from `seed`."""
    import numpy as np
    import torch
    from repro_torch.models import build_model
    m = build_model(cfg, device=device, seed=seed)
    toks = torch.from_numpy(np.random.RandomState(seed).randint(
        0, cfg.vocab_size, (B, S + N))).to(device)
    extra = {}
    if cfg.family == "encdec":
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        extra["enc_embeds"] = 0.02 * torch.randn(
            (B, cfg.encoder_len, cfg.d_model), generator=gen, device=device)
    ref, _ = m.prefill({"tokens": toks, **extra}, m.init_cache(B, S + N))
    lg, cache = m.prefill({"tokens": toks[:, :S], **extra},
                          m.init_cache(B, S + N))
    for i in range(S, S + N):
        lg, cache = m.decode(toks[:, i], cache)
    V = cfg.vocab_size        # pad-vocab columns are -1e30 on both sides
    lg, ref = lg[..., :V], ref[..., :V]
    rel = float((lg - ref).abs().max() / (ref.abs().max() + 1e-9))
    _say(f"[{tag}] decode vs teacher forcing ({cfg.arch_id} d={cfg.d_model} "
         f"L={cfg.n_layers} {cfg.dtype}, B={B} prefill {S} + {N} decodes "
         f"against prefill {S + N}): rel {rel:.3g} (limit 5e-3)")
    if not rel < 5e-3:
        raise AssertionError(f"[{tag}] decode disagrees with teacher "
                             f"forcing: rel {rel}")
    return rel


def run_generate(cfg, params, prompts, steps, device="cuda",
                 ref_tokens=None, profile=False):
    """The generate path: `prompts` batched with prompt_len into a cache
    of the longest + `steps` slots, `steps` greedy decodes with a bf16
    cache (launch counts zeroed just before, read just after), then the
    same with kv_quant (int8 codes, bf16 scales) fed the bf16 run's
    tokens: its logits must stay within rel 5e-2 of the bf16 run's at
    every step (tests/test_models.py's test_int8_kv_cache_decode).
    With `ref_tokens` ({rid: stream}, the serve phase's engine) prints
    how many first tokens and stream tokens agree (not gated). With
    `profile`, each cache's prefill and decode steps are traced
    (`_profile_generate`)."""
    import dataclasses
    import torch
    from repro_torch.models import DecoderModel
    B, lens = len(prompts), [len(p) for p in prompts]
    S = max(lens)
    toks = torch.zeros((B, S), dtype=torch.long)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = torch.tensor(p)
    batch = {"tokens": toks.to(device),
             "prompt_len": torch.tensor(lens, dtype=torch.int32,
                                        device=device)}
    out = {}
    for quant in (False, True):
        tag = "generate int8" if quant else "generate"
        model = DecoderModel(dataclasses.replace(cfg, kv_quant=quant),
                             params, device=device, seed=0)
        params = model.params
        forced = (None if not quant else torch.tensor(
            out["bf16"]["tokens"], device=device)[:, :steps])
        _zero_launches()
        r = _generate(model, batch, B, S + steps, steps, forced)
        r["launches"] = _launches()
        _say_generate(tag, r)
        _check_generate(tag, cfg, r, steps, device)
        if profile:
            r["profile"] = _profile_generate(tag, model, batch, B,
                                             S + steps)
        out["int8" if quant else "bf16"] = r
        del model
    rels = [float((a - b).abs().max() / b.abs().max())
            for a, b in zip(out["int8"]["logits"], out["bf16"]["logits"])]
    same = sum(a == b for ra, rb in zip(out["int8"]["tokens"],
                                        out["bf16"]["tokens"])
               for a, b in zip(ra, rb))
    n = B * (steps + 1)
    _say(f"[generate int8] logits against the bf16 cache's, rel per step: "
         f"max {max(rels):.3g} (limit 5e-2), last {rels[-1]:.3g}; argmax "
         f"equal to the bf16 stream at {same}/{n}")
    if not max(rels) < 5e-2:
        raise AssertionError(f"int8 cache disagrees with bf16: rel "
                             f"{max(rels)}")
    res = {"launches": out["bf16"]["launches"],
           "launches_int8": out["int8"]["launches"],
           "ttft_s": out["bf16"]["ttft_s"], "tpot_s": out["bf16"]["tpot_s"],
           "ttft_s_int8": out["int8"]["ttft_s"],
           "tpot_s_int8": out["int8"]["tpot_s"],
           "cache_bytes": out["bf16"]["cache_bytes"],
           "cache_bytes_int8": out["int8"]["cache_bytes"],
           "int8_rel": rels, "int8_argmax_agree": same / n,
           "tokens": out["bf16"]["tokens"]}
    if profile:
        res["profile"] = {k: out[k]["profile"] for k in ("bf16", "int8")}
    if ref_tokens is not None:
        streams = [ref_tokens[f"r{i}"] for i in range(B)]
        first = sum(s[0] == t[0] for s, t in zip(streams, res["tokens"]))
        agree = sum(a == b for s, t in zip(streams, res["tokens"])
                    for a, b in zip(s, t))
        total = sum(min(len(s), steps + 1) for s in streams)
        _say(f"[generate] against the serve phase's engine streams: first "
             f"tokens {first}/{B}, stream tokens {agree}/{total} (not "
             f"gated: another batch, bf16)")
        res.update(first_agree=first, stream_agree=agree / total)
    return res


def phase_generate(params, prompts, serve_tokens, profile=False):
    """llama2-7b through `DecoderModel.prefill` / `.decode` on the serve
    phase's weights and prompts (GENERATE), bf16 and int8 caches; then
    decode against teacher forcing at full width, 2 layers, f32."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(GENERATE["arch"])
    g = GENERATE
    lens = sorted(len(p) for p in prompts)
    _say(f"[generate] {cfg.arch_id} L={cfg.n_layers} d={cfg.d_model} "
         f"H={cfg.n_heads} KV={cfg.n_kv_heads} {cfg.dtype}: {len(prompts)} "
         f"prompts {lens} batched with prompt_len, {g['steps']} decode "
         f"steps, dense cache of {max(lens) + g['steps']} slots")
    res = run_generate(cfg, params, prompts, g["steps"], "cuda",
                       ref_tokens=serve_tokens, profile=profile)
    tf = dataclasses.replace(cfg, n_layers=g["tf_layers"], dtype="float32")
    res["teacher_forcing_rel"] = _decode_vs_teacher_forcing(
        "generate", tf, "cuda", g["tf_batch"], g["tf_prompt"], g["tf_steps"])
    return res


def run_generate_vlm(cfg, lens, steps, device="cuda", seed=0,
                     profile=False):
    """qwen2-vl: prompts of `lens` positions from stub embeds (N(0, 1) x
    0.02 from a seeded generator) with the text-stream mrope positions,
    batched with prompt_len, then `steps` greedy text decodes; launch
    counts zeroed just before, read just after."""
    import torch
    from repro_torch.models import DecoderModel
    from repro_torch import torch_dtype
    model = DecoderModel(cfg, device=device, seed=seed)
    n = sum(t.numel() for t in model.flat.values())
    B, S = len(lens), max(lens)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    batch = {"embeds": 0.02 * torch.randn((B, S, cfg.d_model), generator=gen,
                                          device=device).to(
                                              torch_dtype(cfg.dtype)),
             "mrope_pos": torch.arange(S, device=device)[None, None].expand(
                 3, B, S),
             "prompt_len": torch.tensor(lens, dtype=torch.int32,
                                        device=device)}
    _zero_launches()
    r = _generate(model, batch, B, S + steps, steps)
    r["launches"] = _launches()
    _say_generate("generate-vlm", r)
    _check_generate("generate-vlm", cfg, r, steps, device)
    if profile:
        r["profile"] = _profile_generate("generate-vlm", model, batch, B,
                                         S + steps)
    r.pop("logits")
    r["n_params"] = n
    return r


def phase_generate_vlm(profile=False):
    """qwen2-vl-7b at full width and depth, bf16, random weights made on
    the card (GENERATE_VLM)."""
    from repro_torch.configs import get_config
    g = GENERATE_VLM
    cfg = get_config(g["arch"])
    lens = [len(p) for p in _prompts(cfg.vocab_size, n=g["n"],
                                     seed=g["seed"])]
    _say(f"[generate-vlm] {cfg.arch_id} L={cfg.n_layers} d={cfg.d_model} "
         f"H={cfg.n_heads} KV={cfg.n_kv_heads} D={cfg.resolved_head_dim} "
         f"{cfg.dtype}: {len(lens)} prompts of {sorted(lens)} positions "
         f"from stub embeds, {g['steps']} decode steps")
    r = run_generate_vlm(cfg, lens, g["steps"], "cuda", profile=profile)
    _say(f"[generate-vlm] {r['n_params'] / 1e9:.3f} B parameters")
    return r


def run_train(tag, cfg, B, S, steps, kernels, device="cuda"):
    """`train_loop.train` for `steps` AdamW steps on SyntheticLM batches
    of B x S (the family's stub frontend included), launch counts zeroed
    just before and read just after. Asserts finite losses and grad
    norms, a step-0 loss within 1 of ln(vocab), and on the card each of
    `kernels` launched. For MoE, `lb_loss` finite, 0 <= dropped_frac <
    1, and the step-0 ce (the loss less 0.01 * lb_loss) near ln(vocab)."""
    import math
    import torch
    from repro_torch.training.data import DataConfig
    from repro_torch.training.train_loop import train
    on_cuda = torch.device(device).type == "cuda"
    if on_cuda:
        torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    res = train(cfg, steps=steps, dc=DataConfig(batch_size=B, seq_len=S),
                seed=0, device=device, log_every=1)
    launches = _launches()
    peak = torch.cuda.max_memory_allocated() if on_cuda else 0
    tail = res.step_s[1:] or res.step_s
    steady = sorted(tail)[len(tail) // 2]
    per_step = {k: v / steps for k, v in launches.items() if v}
    moe = (f"; lb_loss {res.lb_losses}; dropped_frac {res.dropped_fracs}"
           if res.lb_losses else "")
    _say(f"[{tag}] launches {launches}; per step {per_step}")
    _say(f"[{tag}] step wall s {[round(t, 4) for t in res.step_s]}; "
         f"steady (median of steps 1..) {steady:.4f} s = "
         f"{B * S / steady:.0f} tokens/s; peak device memory "
         f"{peak / 2**30:.2f} GiB{moe}")
    vals = res.losses + res.grad_norms + res.lb_losses
    if not all(math.isfinite(x) for x in vals):
        raise AssertionError(f"[{tag}] non-finite loss, grad norm or "
                             f"lb_loss: {vals}")
    # an MoE step's loss is ce + 0.01 * lb_loss
    ce0 = res.losses[0] - 0.01 * (res.lb_losses or [0.0])[0]
    ln_v = math.log(cfg.vocab_size)
    if abs(ce0 - ln_v) > 1.0:
        raise AssertionError(f"[{tag}] step-0 ce {ce0} is not near "
                             f"ln(vocab) = {ln_v:.3f}")
    if not all(0.0 <= f < 1.0 for f in res.dropped_fracs):
        raise AssertionError(f"[{tag}] dropped_frac out of [0, 1): "
                             f"{res.dropped_fracs}")
    missing = [k for k in kernels if not launches[k]]
    if on_cuda and missing:
        raise AssertionError(f"[{tag}] kernels never launched: {missing}")
    out = {"losses": res.losses, "grad_norms": res.grad_norms,
           "step_s": res.step_s, "steady_step_s": steady,
           "tokens_per_s": B * S / steady, "peak_bytes": peak,
           "launches": launches, "launches_per_step": per_step}
    if res.lb_losses:
        out.update(lb_losses=res.lb_losses, dropped_fracs=res.dropped_fracs)
    return out


def path_sizes():
    """Sizes of the Model-API paths at their full configs, from shapes
    alone (no tensor): the generate caches, qwen2-vl-7b's weights, and
    train-vlm's parameters with 12 bytes each (bf16 weights and
    gradients, f32 AdamW moments), before activations and the optimizer's
    f32 temporaries; the same for the hybrid's and the ssm's paths
    (`model_size`; their caches: the shared block's K/V per use, the
    Mamba2 states and conv tails; the xLSTM states, mC being
    (n_sb, n_m, B, H, hd, hd) f32)."""
    import dataclasses
    from repro_torch.configs import get_config
    llama = get_config(GENERATE["arch"])
    B = PATHS["serve"]["n"]
    slots = 1024 + GENERATE["steps"]
    kv = llama.n_layers * B * slots * llama.n_kv_heads \
        * llama.resolved_head_dim * 2
    vlm = get_config(GENERATE_VLM["arch"])
    tv = dataclasses.replace(vlm, n_layers=TRAIN_VLM["layers"])
    out = {"generate_cache_bytes": kv * 2,
           "generate_int8_cache_bytes": kv + kv // llama.resolved_head_dim
           * 2,
           "generate_vlm_weight_bytes": vlm.param_count() * 2,
           "train_vlm_params": tv.param_count(),
           "train_vlm_reckon_bytes": 12 * tv.param_count()}
    zam, xl = get_config(GENERATE_HYBRID["arch"]), get_config(
        GENERATE_SSM["arch"])
    g = GENERATE_HYBRID
    B, slots = g["batch"], g["prompt"] + g["steps"]
    d_in = zam.ssm.expand * zam.d_model
    H, N = d_in // 64, zam.ssm.state_dim
    out["generate_hybrid_weight_bytes"] = model_size(zam)[1]
    out["generate_hybrid_cache_bytes"] = (
        2 * zam.n_attention_layers() * B * slots * zam.n_kv_heads
        * zam.resolved_head_dim * 2
        + zam.n_layers * B * H * N * 64 * 4
        + zam.n_layers * B * (zam.ssm.conv_dim - 1)
        * (d_in + 2 * zam.ssm.n_groups * N) * 2)
    n_sb, n_m = xl.n_layers // xl.xlstm_slstm_every, \
        xl.xlstm_slstm_every - 1
    hd = xl.ssm.expand * xl.d_model // xl.n_heads
    B = GENERATE_SSM["batch"]
    out["generate_ssm_weight_bytes"] = model_size(xl)[1]
    out["generate_ssm_cache_bytes"] = (
        n_sb * n_m * B * xl.n_heads * (hd * hd + hd + 1) * 4
        + 4 * n_sb * B * xl.d_model * 4)
    for name, t, cfg in (("train_hybrid", TRAIN_HYBRID, zam),
                         ("train_ssm", TRAIN_SSM, xl)):
        n = model_size(dataclasses.replace(cfg, n_layers=t["layers"]))[0]
        out[f"{name}_params"] = n
        out[f"{name}_reckon_bytes"] = 12 * n
    return out


def phase_train_vlm(profile=False):
    """qwen2-vl-7b at full width (d 3584, 28 heads over 4 KV heads of
    128, d_ff 18944, vocab 152064) with its depth cut to
    TRAIN_VLM["layers"] of 28, bf16, trained for TRAIN_VLM["steps"]
    AdamW steps on SyntheticLM batches with the vlm stub (embeds and
    mrope positions), every block checkpointed: RMSNorm and flash (G = 7)
    forward and backward."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    t = TRAIN_VLM
    full = get_config(t["arch"])
    cfg = dataclasses.replace(full, n_layers=t["layers"])
    sz = path_sizes()
    _say(f"[train-vlm] {cfg.arch_id} L={cfg.n_layers} (cut from "
         f"{full.n_layers}) d={cfg.d_model} H={cfg.n_heads} "
         f"KV={cfg.n_kv_heads} D={cfg.resolved_head_dim} d_ff={cfg.d_ff} "
         f"vocab {cfg.vocab_size}, {cfg.dtype}, "
         f"{sz['train_vlm_params'] / 1e9:.3f} B parameters "
         f"({sz['train_vlm_reckon_bytes'] / 2**30:.1f} GiB of weights, "
         f"gradients and moments); {t['steps']} AdamW steps of "
         f"{t['batch']} x {t['seq']} stub-embed positions, remat on")
    _say(f"[train-vlm] device memory in use before: "
         f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    res = run_train("train-vlm", cfg, t["batch"], t["seq"], t["steps"],
                    TRAIN_KERNELS)
    res.update(n_params=sz["train_vlm_params"], n_layers=cfg.n_layers)
    if profile:
        gc.collect()
        torch.cuda.empty_cache()
        res["profile"] = _profile_train(cfg, t["batch"], t["seq"])
    return res


def run_encdec(cfg, B, prompt, steps, train_seq, train_steps,
               device="cuda", seed=0, profile=False):
    """whisper: B stub encoder inputs (N(0, 1) x 0.02, encoder_len frames)
    and a `prompt`-token prompt through `EncDecModel.prefill`, then
    `steps` greedy decodes over the cached cross K/V (launch counts
    zeroed just before, read just after); decode against teacher forcing
    in f32; then `train_steps` AdamW steps at B x train_seq."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.models import EncDecModel
    from repro_torch import torch_dtype
    model = EncDecModel(cfg, device=device, seed=seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    batch = {"enc_embeds": 0.02 * torch.randn(
        (B, cfg.encoder_len, cfg.d_model), generator=gen,
        device=device).to(torch_dtype(cfg.dtype)),
        "tokens": torch.from_numpy(np.random.RandomState(seed).randint(
            0, cfg.vocab_size, (B, prompt))).to(device)}
    _zero_launches()
    r = _generate(model, batch, B, prompt + steps, steps)
    r["launches"] = _launches()
    _say_generate("encdec", r)
    _check_generate("encdec", cfg, r, steps, device)
    if profile:
        r["profile"] = _profile_generate("encdec", model, batch, B,
                                         prompt + steps)
    r.pop("logits")
    del model
    r["teacher_forcing_rel"] = _decode_vs_teacher_forcing(
        "encdec", dataclasses.replace(cfg, dtype="float32"), device, 2,
        2 * prompt, prompt)
    r["train"] = run_train("encdec train", cfg, B, train_seq, train_steps,
                           ("flash_attention", "flash_attention_bwd"),
                           device)
    if profile:
        r["train"]["profile"] = _profile_train(cfg, B, train_seq)
    return r


def phase_encdec(profile=False):
    """whisper-base at full width and depth (ENCDEC), bf16, random
    weights made on the card: generate, teacher forcing, train."""
    from repro_torch.configs import get_config
    e = ENCDEC
    cfg = get_config(e["arch"])
    _say(f"[encdec] {cfg.arch_id} encoder {cfg.n_encoder_layers} + decoder "
         f"{cfg.n_layers} layers, d={cfg.d_model} H={cfg.n_heads} "
         f"KV={cfg.n_kv_heads} D={cfg.resolved_head_dim} {cfg.dtype}, "
         f"encoder_len {cfg.encoder_len}: {e['batch']} stub inputs, a "
         f"{e['prompt']}-token prompt, {e['steps']} decode steps; "
         f"{e['train_steps']} AdamW steps of {e['batch']} x "
         f"{e['train_seq']} tokens")
    r = run_encdec(cfg, e["batch"], e["prompt"], e["steps"], e["train_seq"],
                   e["train_steps"], "cuda", profile=profile)
    # the main path's counts are the generate run's; training's ride along
    r["launches_train"] = r["train"]["launches"]
    return r


def run_generate_recurrent(tag, cfg, B, S, steps, tf, device="cuda",
                           seed=0, profile=False):
    """The hybrid's or the ssm's generate path: B random prompts of S
    tokens (one S for the batch) through `prefill` into a cache of
    S + `steps` slots, `steps` greedy decodes (launch counts zeroed just
    before, read just after), then decode against teacher forcing in f32
    over one superblock (`tf`: tf_batch, tf_prompt, tf_steps)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.models import build_model
    model = build_model(cfg, device=device, seed=seed)
    n = sum(t.numel() for t in model.flat.values())
    batch = {"tokens": torch.from_numpy(np.random.RandomState(seed).randint(
        0, cfg.vocab_size, (B, S))).to(device)}
    _zero_launches()
    r = _generate(model, batch, B, S + steps, steps)
    r["launches"] = _launches()
    _say_generate(tag, r)
    _check_generate(tag, cfg, r, steps, device)
    if profile:
        r["profile"] = _profile_generate(tag, model, batch, B, S + steps)
    r.pop("logits")
    del model
    r["n_params"] = n
    per_sb = cfg.hybrid_attn_every or cfg.xlstm_slstm_every
    r["teacher_forcing_rel"] = _decode_vs_teacher_forcing(
        tag, dataclasses.replace(cfg, n_layers=per_sb, dtype="float32"),
        device, tf["tf_batch"], tf["tf_prompt"], tf["tf_steps"])
    return r


def phase_generate_recurrent(tag, g, profile=False):
    """generate-hybrid (zamba2-2.7b, GENERATE_HYBRID: flash at D 80 in
    prefill, decode_attention at D 80, RMSNorm at d 2560 and 5120) or
    generate-ssm (xlstm-1.3b, GENERATE_SSM: RMSNorm at d 2048 and 4096,
    no attention), at full width and depth, bf16, random weights made on
    the card."""
    from repro_torch.configs import get_config
    cfg = get_config(g["arch"])
    sz = model_size(cfg)
    _say(f"[{tag}] {cfg.arch_id} L={cfg.n_layers} d={cfg.d_model} "
         f"H={cfg.n_heads} KV={cfg.n_kv_heads} {cfg.dtype}, "
         f"{sz[0] / 1e9:.3f} B parameters ({sz[1] / 1e9:.2f} GB): "
         f"{g['batch']} prompts of {g['prompt']} tokens, {g['steps']} "
         f"decode steps, cache of {g['prompt'] + g['steps']} slots")
    return run_generate_recurrent(tag, cfg, g["batch"], g["prompt"],
                                  g["steps"], g, "cuda", profile=profile)


def phase_train_recurrent(tag, t, kernels, profile=False):
    """train-hybrid (zamba2-2.7b at full width and depth, TRAIN_HYBRID:
    flash at D 80 and RMSNorm both ways) or train-ssm (xlstm-1.3b at full
    width, depth cut to TRAIN_SSM["layers"]: RMSNorm both ways), bf16,
    every superblock checkpointed; `kernels` must launch."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    full = get_config(t["arch"])
    cfg = dataclasses.replace(full, n_layers=t["layers"])
    n = model_size(cfg)[0]
    _say(f"[{tag}] {cfg.arch_id} L={cfg.n_layers} (of {full.n_layers}) "
         f"d={cfg.d_model} H={cfg.n_heads} KV={cfg.n_kv_heads} "
         f"vocab {cfg.vocab_size}, {cfg.dtype}, {n / 1e9:.3f} B parameters "
         f"({12 * n / 2**30:.1f} GiB at 12 bytes each); {t['steps']} AdamW "
         f"steps of {t['batch']} x {t['seq']} tokens, every superblock "
         f"checkpointed")
    res = run_train(tag, cfg, t["batch"], t["seq"], t["steps"], kernels)
    res.update(n_params=n, n_layers=cfg.n_layers)
    if profile:
        gc.collect()
        torch.cuda.empty_cache()
        res["profile"] = _profile_train(cfg, t["batch"], t["seq"])
    return res


def model_size(cfg):
    """(parameters, bytes) of a hybrid or ssm model at `cfg`, from shapes
    alone (no tensor): the leaves of `HybridModel._init` /
    `XLSTMModel._init`, the f32 ones (A_log, D, dt_bias; the gate weights
    and biases, r_gates, b_gates) at 4 bytes, the rest in cfg.dtype."""
    w = 2 if cfg.dtype == "bfloat16" else 4
    d, V = cfg.d_model, cfg.padded_vocab
    main, f32 = 2 * V * d + d, 0          # embed, lm_head, final norm
    if cfg.family == "hybrid":
        d_in = cfg.ssm.expand * d
        H, N, G = d_in // 64, cfg.ssm.state_dim, cfg.ssm.n_groups
        conv = d_in + 2 * G * N
        main += cfg.n_layers * (d + d * (2 * d_in + 2 * G * N + H)
                                + (cfg.ssm.conv_dim + 1) * conv + d_in
                                + d_in * d)
        f32 += cfg.n_layers * 3 * H
        hq, hkv = cfg.n_q_heads * cfg.resolved_head_dim, \
            cfg.n_kv_heads * cfg.resolved_head_dim
        main += 2 * d * hq + 2 * d * hkv + 2 * d + 3 * d * cfg.d_ff
    elif cfg.family == "ssm":
        n_sb = cfg.n_layers // cfg.xlstm_slstm_every
        n_m = cfg.xlstm_slstm_every - 1
        d_in, H = cfg.ssm.expand * d, cfg.n_heads
        main += n_sb * n_m * (d + 2 * d * d_in + 3 * d_in * d_in + d_in
                              + d_in * d)
        f32 += n_sb * n_m * (2 * d_in * H + 2 * H)
        main += n_sb * (2 * d + 4 * d * d + d * d)
        f32 += n_sb * (4 * H * (d // H) ** 2 + 4 * d)
    else:
        raise ValueError(cfg.family)
    return main + f32, main * w + f32 * 4


# -------------------------------------------------------------- examples --

# the examples' own sizes (src/repro_torch/examples): quickstart's 60
# steps, train_tiny's `--steps 50` at its default batch and sequence
ENGINE_KERNELS = ("flash_attention", "paged_attention", "rmsnorm")


def _check_train_result(tag, res, vocab):
    import math
    vals = res.losses + res.grad_norms
    if not all(math.isfinite(x) for x in vals):
        raise AssertionError(f"[{tag}] non-finite loss or grad norm: {vals}")
    if abs(res.losses[0] - math.log(vocab)) > 1.0:
        raise AssertionError(f"[{tag}] step-0 loss {res.losses[0]} is not "
                             f"near ln(vocab) = {math.log(vocab):.3f}")


def _check_kernels(tag, launches, kernels, device):
    import torch
    missing = [k for k in kernels if not launches[k]]
    if torch.device(device).type == "cuda" and missing:
        raise AssertionError(f"[{tag}] kernels never launched: {missing}")


def _divergence_gap(model, prompt, got, want):
    """Where two greedy streams of one prompt first differ: (step, the
    gap between the two largest f32 logits there, teacher-forced at
    B 1 on the common prefix)."""
    import torch
    j = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
    toks = torch.tensor([list(prompt) + list(want[:j])],
                        device=model.device)
    with torch.no_grad():
        logits = model.train_logits({"tokens": toks}, remat=False)[0, -1]
    top = torch.topk(logits.float(), 2).values
    return j, float(top[0] - top[1])


def run_examples(device="cuda", quick_steps=60, tiny_steps=50, tiny_batch=4,
                 tiny_seq=256):
    """The examples phase (module docstring): returns one entry
    per part, each with its launch counts."""
    import shutil
    import statistics
    import tempfile
    from repro_torch.examples import quickstart, serve_comparison, train_tiny
    out = {}
    cfg = quickstart.config()

    _zero_launches()
    res = quickstart.train_part(cfg, device=device, steps=quick_steps,
                                verbose=False)
    _sync(device)
    out["quickstart-train"] = {"losses": res.losses, "step_s": res.step_s,
                               "tokens_per_s": res.tokens_per_s,
                               "launches": _launches()}
    _check_train_result("quickstart-train", res, cfg.vocab_size)
    _check_kernels("quickstart-train", out["quickstart-train"]["launches"],
                   TRAIN_KERNELS, device)
    _say(f"[examples] quickstart: loss {res.losses[0]:.4f} -> "
         f"{res.final_loss:.4f} over {quick_steps} steps, "
         f"{res.tokens_per_s:.0f} tokens/s")

    _zero_launches()
    t0 = time.perf_counter()
    eng, done, streamed = quickstart.serve_part(cfg, device=device,
                                                verbose=False)
    _sync(device)
    wall = time.perf_counter() - t0
    tokens = {r.rid: r.generated for r in done}
    if streamed != tokens["r0"] or any(len(t) != 8 for t in tokens.values()):
        raise AssertionError(f"[examples] quickstart: r0 streamed "
                             f"{streamed}, output {tokens['r0']}")
    off, rel = quickstart.transfers(eng)
    out["quickstart-serve"] = {"tokens": tokens, "wall_s": wall,
                               "ttft_s": {r.rid: r.ttft for r in done},
                               "offloads": off, "reloads": rel,
                               "launches": _launches()}
    _check_kernels("quickstart-serve", out["quickstart-serve"]["launches"],
                   ENGINE_KERNELS, device)
    _say(f"[examples] quickstart serving: 6 requests in {wall:.3f} s wall, "
         f"r0 {streamed}, {off} offloads / {rel} reloads")
    del eng

    _zero_launches()
    t0 = time.perf_counter()
    cmp = serve_comparison.compare(cfg, device=device)
    _sync(device)
    wall = time.perf_counter() - t0
    truth, out_v, out_l = cmp["truth"], cmp["vllm"], cmp["layerkv"]
    tv = statistics.mean(r.ttft for r in out_v.values())
    tl = statistics.mean(r.ttft for r in out_l.values())
    entry = {"mismatches": cmp["mismatches"], "offloads": cmp["offloads"],
             "reloads": cmp["reloads"], "wall_s": wall,
             "mean_ttft_vllm_s": tv, "mean_ttft_layerkv_s": tl,
             "tokens": {rid: r.generated for rid, r in out_l.items()},
             "launches": _launches()}
    _check_kernels("serve-comparison", entry["launches"], ENGINE_KERNELS,
                   device)
    if cmp["mismatches"]:
        # the first diverging request: its step and top-2 logit gap
        from repro_torch.models import DecoderModel
        wl = {r.rid: r for r in serve_comparison.make_workload(cfg)}
        model = DecoderModel(cfg, device=device, seed=7)
        rid = next(r for r in truth
                   if truth[r].generated != out_l[r].generated)
        step, gap = _divergence_gap(model, wl[rid].prompt,
                                    out_l[rid].generated,
                                    truth[rid].generated)
        entry["divergence"] = {"rid": rid, "step": step, "top2_gap": gap}
        _say(f"[examples] serve_comparison: {rid} first differs at step "
             f"{step}, top-2 logit gap there {gap:.3e} (f32, B 1)")
    out["serve-comparison"] = entry
    _say(f"[examples] serve_comparison: losslessness "
         f"{len(truth) - cmp['mismatches']}/{len(truth)} identical under "
         f"{cmp['offloads']} offloads / {cmp['reloads']} reloads; mean "
         f"TTFT (engine clock) request-wise {tv * 1e6:.1f} us, layer-wise "
         f"{tl * 1e6:.1f} us ({tv / max(tl, 1e-12):.2f}x); three runs "
         f"{wall:.3f} s wall")

    ckpt = tempfile.mkdtemp(prefix="tiny100m_ckpt_")
    try:
        _zero_launches()
        res = train_tiny.run(steps=tiny_steps, batch=tiny_batch,
                             seq=tiny_seq, ckpt=ckpt, device=device,
                             verbose=False)
        _sync(device)
        written = os.path.exists(os.path.join(ckpt, "manifest.json"))
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    tail = res.step_s[1:] or res.step_s
    steady = sorted(tail)[len(tail) // 2]
    out["train-tiny"] = {"losses": res.losses, "step_s": res.step_s,
                         "steady_step_s": steady,
                         "tokens_per_s": tiny_batch * tiny_seq / steady,
                         "checkpoint_written": written,
                         "launches": _launches()}
    _check_train_result("train-tiny", res, train_tiny.TINY_100M.vocab_size)
    _check_kernels("train-tiny", out["train-tiny"]["launches"],
                   TRAIN_KERNELS, device)
    if not written:
        raise AssertionError("[examples] train_tiny wrote no checkpoint")
    _say(f"[examples] train_tiny: loss {res.losses[0]:.4f} -> "
         f"{res.final_loss:.4f} over {tiny_steps} steps of {tiny_batch} x "
         f"{tiny_seq}; steady step {steady:.4f} s = "
         f"{tiny_batch * tiny_seq / steady:.0f} tokens/s")
    return out


def phase_examples(profile=False):
    t0 = time.perf_counter()
    out = run_examples(**EXAMPLES)
    if profile:
        from repro_torch.examples.train_tiny import TINY_100M
        out["train-tiny"]["profile"] = _profile_train(
            TINY_100M, EXAMPLES["tiny_batch"], EXAMPLES["tiny_seq"])
    _say(f"[examples] phase {time.perf_counter() - t0:.1f}s")
    return out


# ---------------------------------------------------------------- dryrun --

DRYRUN_PAIRS = (("chatglm3-6b", "decode_32k", "single"),
                ("granite-3-2b", "train_4k", "single"),
                ("chatglm3-6b", "decode_32k", "multi"),
                ("deepseek-moe-16b", "prefill_32k", "single"),
                ("zamba2-2.7b", "decode_32k", "single"))


def run_dryrun(out_dir, pairs=DRYRUN_PAIRS, offload=True):
    """The dryrun phase: each (arch, shape, mesh) in a fresh `python -m
    repro_torch.launch.dryrun` process (the process group is
    process-global) appending to one records file, the roofline over
    it, and the offload example in its own process. Returns the records
    and the roofline rows; raises unless every record is ok, carries an
    int `temp_size` (the peak of a rank's live bytes) and fits the
    HBM."""
    import dataclasses as dc
    import torch
    from repro_torch.launch.dryrun import missing_torch_internals
    _say(f"[dryrun] torch {torch.__version__}")
    missing = missing_torch_internals()
    if missing:
        raise RuntimeError(f"[dryrun] this torch lacks the private names the "
                           f"dry run patches or imports: {missing}")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(os.path.abspath(out_dir), "dryrun.json")
    if os.path.exists(path):
        os.remove(path)
    for arch, shape, mesh in pairs:
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", mesh, "--out", path,
             "--append"], cwd=ROOT, env=env, capture_output=True,
            text=True, timeout=900)
        if proc.returncode:
            raise RuntimeError(f"[dryrun] {arch} x {shape} x {mesh}: exit "
                               f"{proc.returncode}\n{proc.stderr[-3000:]}")
    with open(path) as f:
        recs = json.load(f)
    from repro_torch.roofline.analysis import analyze_file
    rows = [r for m in ("16x16", "2x16x16") for r in analyze_file(path, m)]
    fits = {(r.arch, r.shape, r.mesh): r.fits_hbm for r in rows}
    for rec in recs:
        name = f"{rec['arch']} x {rec['shape']} x {rec['mesh']}"
        if not rec["ok"]:
            raise AssertionError(f"[dryrun] {name}: {rec['error']}")
        mem = rec["memory"]
        if type(mem["temp_size"]) is not int:
            raise AssertionError(f"[dryrun] {name}: temp_size "
                                 f"{mem['temp_size']!r} is not an int")
        _say(f"[dryrun] {name}: {rec['bytes_per_device'] / 2**30:.3f} GiB "
             f"a rank (arguments {mem['argument_size']}, temp_size "
             f"{mem['temp_size']}), fits_hbm "
             f"{fits[rec['arch'], rec['shape'], rec['mesh']]}, "
             f"bytes_accessed {rec['bytes_accessed']:.4e}, flops a rank "
             f"{rec['flops']:.4e}, collectives {rec['collectives']['counts']}"
             f" ({rec['collectives']['total_bytes']} bytes), "
             f"{rec['wall_s']} s on the CPU; notes {rec['notes']}")
    for r in rows:
        _say(f"[dryrun] roofline {r.row()}")
    over = [r.row() for r in rows if not r.fits_hbm]
    if over:
        raise AssertionError(f"[dryrun] OVER-HBM: {over}")
    out = {"records": recs, "roofline": [dc.asdict(r) for r in rows]}
    if offload:
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.examples.offload_dryrun"],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=900)
        if proc.returncode:
            raise RuntimeError(f"[dryrun] offload_dryrun: exit "
                               f"{proc.returncode}\n{proc.stderr[-3000:]}")
        out["offload"] = proc.stdout.strip().splitlines()
        for line in out["offload"]:
            _say(f"[dryrun] {line}")
    return out


def phase_dryrun():
    import tempfile
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        out = run_dryrun(d)
    _say(f"[dryrun] phase {time.perf_counter() - t0:.1f}s")
    return out


# ------------------------------------------------------------------- main --

_NO_PALLAS_BWD = ("the JAX package has no Pallas backward: its training "
                  "differentiates the jnp ")
# per kernel: source, the TPU kernel it replaces, its pallas_call, a note
REPLACES = {
    "flash_attention": ("src/repro_torch/csrc/flash_prefill.cu",
                        "src/repro/kernels/flash_prefill.py:83", None, None),
    "decode_attention": (
        "src/repro_torch/csrc/flash_prefill.cu",
        "src/repro/kernels/ops.py:43", None,
        "not a kernel of its own: this row reports flash_attention's "
        "kernel (the same source) at one query row, non-causal, with the "
        "runtime kv_len (Model.decode's dense cache); the reference's "
        "ops.decode_attention has no Pallas kernel, only "
        "ref.decode_attention_reference. Its launches also count in "
        "flash_attention's"),
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
    "paged_prefill_tf32": (
        "src/repro_torch/csrc/paged_prefill.cu",
        "src/repro/kernels/paged_prefill.py:140",
        "src/repro/kernels/paged_prefill.py:186",
        "the body of both forms in 3xTF32 on the tensor cores "
        "(tf::paged_prefill_tf32, mma.sync .tf32): f32 at every D, and "
        "bf16 at D 32 (the smoke paths)"),
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
MAIN_PATH = {"flash_attention": "serve", "decode_attention": "generate",
             "paged_attention": "serve",
             "paged_prefill": "fused", "paged_prefill_tiered": "fused",
             "stage_host_blocks": "fused", "paged_prefill_mma": "fused",
             "paged_prefill_tf32": "fused-smoke",
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
    # f32 means f32: the plain versions' products (and SDPA's, timed
    # beside the kernels) run without TF32, torch's default for matmul
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    _say("[setup] TF32 off for f32 products outside the kernels: "
         f"matmul.allow_tf32 {torch.backends.cuda.matmul.allow_tf32}, "
         f"cudnn.allow_tf32 {torch.backends.cudnn.allow_tf32}, precision "
         f"{torch.get_float32_matmul_precision()}; torch {torch.__version__}")

    t0 = time.perf_counter()
    smi = phase_build()
    kern = phase_kernels()
    for name, err in phase_head_dim_32().items():   # rows hold the worst
        for key, e in err.items():
            kern[name][0][key] = max(kern[name][0].get(key, 0.0), e)
    paths = phase_smoke()
    paths["serve"] = phase_serve(profile=args.profile)
    params = paths["serve"].pop("params")
    gc.collect()                     # the serve engines' pools go first
    torch.cuda.empty_cache()
    graphs = phase_graphs(params)
    gc.collect()
    torch.cuda.empty_cache()
    paths["generate"] = phase_generate(
        params, _path_prompts("serve", path_config("serve")),
        paths["serve"]["tokens"], profile=args.profile)
    paths["fused"] = phase_fused(params, paths["serve"]["tokens"],
                                 profile=args.profile)
    paths["fused"].pop("params")
    paths["cluster"] = phase_cluster(params, paths["fused"]["tokens"])
    del params
    gc.collect()                     # the cluster's engines hold cycles
    torch.cuda.empty_cache()         # llama2-7b's weights go before MoE's
    torch.cuda.reset_peak_memory_stats()
    paths["moe"] = phase_moe(profile=args.profile)
    paths["moe"].pop("params")
    gc.collect()        # the engines hold reference cycles: free the MoE
    torch.cuda.empty_cache()     # weights and pools before training
    paths["train"] = phase_train(profile=args.profile)
    gc.collect()
    torch.cuda.empty_cache()
    paths["train-moe"] = phase_train_moe(profile=args.profile)
    gc.collect()
    torch.cuda.empty_cache()
    paths["generate-vlm"] = phase_generate_vlm(profile=args.profile)
    gc.collect()
    torch.cuda.empty_cache()
    paths["train-vlm"] = phase_train_vlm(profile=args.profile)
    gc.collect()
    torch.cuda.empty_cache()
    paths["encdec"] = phase_encdec(profile=args.profile)
    # the last two families: generate (kernels None) and train phases
    for tag, settings, kernels in (
            ("generate-hybrid", GENERATE_HYBRID, None),
            ("train-hybrid", TRAIN_HYBRID, TRAIN_KERNELS),
            ("generate-ssm", GENERATE_SSM, None),
            ("train-ssm", TRAIN_SSM, ("rmsnorm", "rmsnorm_bwd"))):
        gc.collect()
        torch.cuda.empty_cache()
        paths[tag] = (
            phase_generate_recurrent(tag, settings, args.profile)
            if kernels is None else
            phase_train_recurrent(tag, settings, kernels, args.profile))
    gc.collect()
    torch.cuda.empty_cache()
    paths.update(phase_examples(profile=args.profile))
    gc.collect()
    torch.cuda.empty_cache()
    dry = phase_dryrun()

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
        for extra in ("kernel", "routes", "at_train_shape",
                      "at_moe_train_shape",
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
                       "graphs": graphs, "dryrun": dry, "device": device,
                       "seconds": time.perf_counter() - t0}, f, indent=1,
                      default=str)
    _say(f"[done] {time.perf_counter() - t0:.1f}s")
    _say(smi)
    _say(json.dumps({"kernels": rows}))
    _say(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
