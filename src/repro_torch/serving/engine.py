"""The LayerKV serving engine on PyTorch: continuous batching over real
execution on the H100 — the port of `repro.serving.engine`, line by line
with the executor swapped.

Wires the paper's decision components (block manager, offload plans, SLO
scheduler, Eq.5 forecast) to the `PagedExecutor`. Two policies:

  'vllm'     request-wise: admit a prefill only when device blocks for the
             whole prompt x all layers are free (baseline).
  'layerkv'  layer-wise: admit with Eq.4's x retained layers (+1 send
             buffer); offloaded layers live in the HOST pool and are
             streamed/promoted back for decode.

Orthogonally, `ServeConfig.chunked` selects the engine-step semantics
(exclusive vLLM-0.5.5 prefill vs chunked prefill + mixed batching) and
`ServeConfig.fused` (chunked only) collapses the iteration's two executor
calls into ONE `PagedExecutor.mixed_step`, whose prefill chunks attend
straight over the paged pools (the host pool too, for layers offloaded
mid-prefill). Families: dense and MoE; the constructor raises for the
others.

Everything decision-shaped — admission (policy-ordered, Alg.1 budgeted),
the device-need gate, the Eq.4 layer-split allocation, chunk assembly,
cache-copy ledger routing, cancellation — lives in the shared
`SchedulerCore` (serving/scheduler.py, copied verbatim from the
reference); this module keeps only the real execution: moving bytes
through the paged pools and the forwards.

The engine is driven through a `ServingSession` (serving/session.py).
The engine clock is virtual (driven by the cost model, here priced with
the H100 spec sheet) so runs are exactly reproducible; generated TOKENS
are real model outputs, which is what the parity tests against the JAX
engine assert (tests/test_torch_engine.py).
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import DEVICE, HOST, LayerwiseBlockManager, \
    OffloadEngine, SLOScheduler
from repro_torch.core.predictor import HistogramPredictor, LengthPredictor
from repro_torch.serving.costmodel import H100, CostModel, HWProfile
from repro_torch.serving.executor import MixedChunk, MixedDecode, \
    PagedExecutor
from repro_torch.serving.request import Phase, Request
from repro_torch.serving.scheduler import CoreDelegateMixin, \
    SchedulerCore, ServeConfig
from repro_torch.serving.session import ServingSession


class LayerKVEngine(CoreDelegateMixin):
    """The real serving backend: drives the shared `SchedulerCore`
    against actual PyTorch forwards (`PagedExecutor`) and physical
    device<->host block movement. Accepts the same `ServeConfig` as the
    reference engine; wall-clock is measured, not modeled. Token streams
    are deterministic for a fixed (params, prompts, config, device).
    `params` is the port's nested param dict (e.g. from
    `repro_torch.weights`) or None for random weights from `seed`."""

    produces_token_ids = True    # Request.generated carries real tokens

    def __init__(self, cfg: ModelConfig, params=None,
                 ec: Optional[ServeConfig] = None,
                 hw: HWProfile = H100,
                 predictor: Optional[LengthPredictor] = None, *,
                 device="cuda", seed: int = 0):
        self.cfg = cfg
        self.ec = (ec or ServeConfig.for_engine()).validate()
        if cfg.family not in ("dense", "moe"):
            raise ValueError(f"family {cfg.family!r} is not yet ported "
                             "(dense and moe only)")
        ndb = self.ec.num_device_blocks or 128  # 0 = backend default
        self.ex = PagedExecutor(cfg, params, ndb,
                                self.ec.num_host_blocks, self.ec.block_size,
                                device=device, seed=seed)
        self.L = cfg.n_layers
        self.bm = LayerwiseBlockManager(ndb, self.ec.num_host_blocks,
                                        self.ec.block_size, self.L,
                                        prefix_cache=self.ec.prefix_cache)
        self.cost = CostModel(cfg, hw)
        self.off = OffloadEngine(self.cost, self.L)
        self.predictor = predictor or HistogramPredictor(
            [16, 32, 64, 128, 256])
        self.sched = SLOScheduler(self.cost, self.predictor)
        # cache-driven copies (COW, promote, demote) move REAL bytes
        # through the executor; the core charges the transfer ledger
        self.core = SchedulerCore(self.ec, self.cost, self.bm, self.off,
                                  self.sched, self.L,
                                  physical_copy=self._physical_copy)
        # one registry per engine: the executor's shape counters share
        # the core's namespace so a single snapshot() has both
        self.ex.registry = self.core.registry
        if self.core.tracer is not None:
            # real-execution traces carry wall time next to the virtual
            # clock (the virtual clock stays primary so streams merge)
            self.core.tracer.wall_clock = time.perf_counter
        self._chunk_bufs: Dict[str, tuple] = {}  # rid -> cached (k, v)

    # --------------------------------------------- shared-core delegation
    # queues/host_layers/clock()/advance_to() come from CoreDelegateMixin
    @property
    def now(self) -> float:
        return self.core.now

    @now.setter
    def now(self, t: float) -> None:
        self.core.now = t

    def finish(self) -> None:
        self.bm.check()
        assert not self._chunk_bufs, \
            "leaked chunk prefix buffers: " + ", ".join(self._chunk_bufs)

    def _physical_copy(self, src_pool: str, src: int, dst_pool: str,
                       dst: int) -> None:
        src_tier = "device" if src_pool == DEVICE else "host"
        dst_tier = "device" if dst_pool == DEVICE else "host"
        self.ex.copy_blocks(src_tier, dst_tier, [src], [dst])

    def cancel(self, r: Request) -> bool:
        """Unwind a live request (see SchedulerCore.cancel); the engine
        additionally drops its cached chunk prefix buffers."""
        if not self.core.cancel(r, self.now):
            return False
        self._chunk_bufs.pop(r.rid, None)
        return True

    # -------------------------------------------------------------- prefill
    def _do_prefill(self, r: Request) -> bool:
        alloc = self.core.alloc_prefill(r)
        if alloc is None:
            return False
        retain, off = alloc

        if r.prefill_done > 0:
            # prefix-cache hit: run the uncached suffix as ONE chunk
            # against the shared prefix blocks (q_offset causal masking);
            # compute for the cached tokens is skipped entirely
            c, p = r.prefill_remaining, r.prefill_done
            self._run_chunk(r, c)
            self.now += self.cost.chunk_prefill_time(c, p)
        else:
            pad = self.bm.blocks_for_tokens(r.prompt_len) \
                * self.ec.block_size
            next_tok, k, v = self.ex.prefill(r.prompt, pad)
            for l in retain:
                a = self.bm.allocation(r.rid, l)
                self.ex.write_layer("device", a.blocks, k[l], v[l])
            for l in off:
                a = self.bm.allocation(r.rid, l)
                self.ex.write_layer("host", a.blocks, k[l], v[l])
            if off:
                from repro_torch.core import OffloadPlan
                self.off.prefill_offload_done(
                    self.now, r.prompt_len,
                    OffloadPlan(retain, off, len(retain)))
            self.now += self.cost.prefill_time(r.prompt_len)
            r.prefill_done = r.prompt_len
            r.n_chunks += 1
            r.generated.append(next_tok)
            if self.ec.prefix_cache and r.prompt:
                self.bm.register_prefix(r.rid, r.prompt)
        r.prefill_start = r.prefill_start if r.prefill_start >= 0 else self.now
        if r.first_token_time < 0:  # survives replica-kill restart
            r.first_token_time = self.now
        r.tokens_out = 1
        r.note_token(self.now)
        r.phase = Phase.DECODE
        self.decoding.append(r)
        return True

    # ------------------------------------------------------- chunked prefill
    def _gather_buffers(self, r: Request):
        """Dense (L, S_buf, KV, hd) K/V prefix buffers for r, on the
        device — the two-call chunk path. Gathered from the pools on the
        request's FIRST chunk, then cached and kept fresh by the chunk
        forward itself, which writes each chunk's K/V into them in place:
        a prefilling request's block contents only change through its own
        chunks (evictions touch decoding requests), so re-gathering every
        chunk would be pure waste. Only the blocks holding the
        `prefill_done` live tokens are physically gathered (zero for a
        fresh prompt, the cached prefix for a hit). Entries are dropped on
        the final chunk AND on cancel (`cancel()`), so the dict is empty
        whenever no request is mid-prefill."""
        if r.rid in self._chunk_bufs:
            return self._chunk_bufs[r.rid]
        ks, vs = [], []
        for l in range(self.L):
            a = self.bm.allocation(r.rid, l)
            tier = "device" if a.pool == DEVICE else "host"
            k, v = self.ex.gather_layer(tier, a.blocks,
                                        kv_valid=r.prefill_done)
            ks.append(k)
            vs.append(v)
        bufs = (torch.stack(ks), torch.stack(vs))
        self._chunk_bufs[r.rid] = bufs
        return bufs

    def _run_chunk(self, r: Request, c: int) -> None:
        """Prefill tokens [prefill_done, prefill_done + c) of r: run the
        chunk against the cached prefix, append its KV into the paged pools
        at the token offset, and account the chunk's d2h traffic."""
        p = r.prefill_done
        kbuf, vbuf = self._gather_buffers(r)
        logits, kc, vc = self.ex.prefill_chunk(r.prompt[p:p + c], p,
                                               kbuf, vbuf)
        for l in range(self.L):
            a = self.bm.allocation(r.rid, l)
            tier = "device" if a.pool == DEVICE else "host"
            self.ex.write_layer_slice(tier, a.blocks, p, kc[l], vc[l])
        n_off = len(self.bm.layers_on(r.rid, HOST))
        if n_off:
            self.off.ledger.submit(
                self.now, self.cost.kv_bytes(c, n_off), "offload")
        r.prefill_done += c
        r.n_chunks += 1
        if self.ec.prefix_cache and r.prompt:
            # incremental publication: full blocks whose KV is now written
            # become hittable while the rest of this prompt still prefills
            self.bm.register_prefix(r.rid, r.prompt, upto=r.prefill_done)
        if r.prefill_complete:
            self._chunk_bufs.pop(r.rid, None)
            r.generated.append(int(torch.argmax(logits)))
        # otherwise the cached buffers already hold this chunk's K/V (the
        # chunk forward wrote them in place)

    # ---------------------------------------------------------- fused step
    def _run_mixed(self, chunk_work: List[tuple],
                   sel: List[Request]) -> None:
        """One fused iteration: every prefill chunk AND the decode batch in
        a single `PagedExecutor.mixed_step` forward — one weight stream per
        layer per iteration. Chunk tokens attend straight against the paged
        pools (block tables sliced to the live prefix + chunk), so the
        dense prefix gather of the two-call path is gone; new KV is
        written into the pools inside the step. Bookkeeping (ledger d2h,
        prefill progress, prefix registration, token appends) mirrors
        `_run_chunk` + `_run_decode` exactly."""
        for r in sel:
            for l in list(self.bm.tables[r.rid]):
                self.bm.extend_layer(r.rid, l, 1)
        chunks: List[MixedChunk] = []
        for r, c in chunk_work:
            p = r.prefill_done
            nb_live = -(-(p + c) // self.ec.block_size)
            tabs, tiers = [], []
            for l in range(self.L):
                a = self.bm.allocation(r.rid, l)
                tabs.append(a.blocks[:nb_live])
                tiers.append(a.pool == HOST)
            chunks.append(MixedChunk(tokens=r.prompt[p:p + c], offset=p,
                                     tables=tabs, tiers=tiers))
        decodes: List[MixedDecode] = []
        for r in sel:
            ctx = r.prompt_len + r.tokens_out - 1
            tabs = []
            for l in range(self.L):
                a = self.bm.allocation(r.rid, l)
                assert a.pool == DEVICE
                tabs.append(a.blocks)
            decodes.append(MixedDecode(token=r.generated[-1], ctx=ctx,
                                       tables=tabs))
        out = self.ex.mixed_step(chunks, decodes)
        for i, (r, c) in enumerate(chunk_work):
            n_off = len(self.bm.layers_on(r.rid, HOST))
            if n_off:
                self.off.ledger.submit(
                    self.now, self.cost.kv_bytes(c, n_off), "offload")
            r.prefill_done += c
            r.n_chunks += 1
            if self.ec.prefix_cache and r.prompt:
                self.bm.register_prefix(r.rid, r.prompt,
                                        upto=r.prefill_done)
            if r.prefill_complete:
                r.generated.append(int(out[i]))
        for j, r in enumerate(sel):
            r.generated.append(int(out[len(chunk_work) + j]))
            r.tokens_out += 1

    # ------------------------------------------------------ residency mgmt
    def _ensure_device(self, r: Request) -> bool:
        """Promote every host-resident layer of r to device (h2d). Returns
        False when blocks run out (request pauses this iteration)."""
        for l in self.bm.layers_on(r.rid, HOST):
            a = self.bm.allocation(r.rid, l)
            need = len(a.blocks)
            if self.bm.num_free(DEVICE) < need:
                return False
            src, dst = self.bm.move_layer(r.rid, l, DEVICE)
            self.ex.copy_blocks("host", "device", src, dst)
            self.off.ledger.submit(
                self.now, self.cost.kv_bytes(a.num_tokens, 1), "reload")
        self.host_layers[r.rid] = 0
        return True

    def _evict_newest(self, exclude=()) -> bool:
        """Push the newest request's device layers to host to make room.
        Shared prefix blocks are copied out (detach), never pulled from
        under the requests still mapping them."""
        excl = set(exclude)
        for r in sorted(self.decoding, key=lambda q: -q.prefill_start):
            if r.rid in excl:
                continue
            dev = self.bm.layers_on(r.rid, DEVICE)
            if not dev:
                continue
            for l in dev:
                a = self.bm.allocation(r.rid, l)
                if self.core.host_free() < len(a.blocks):
                    return False
                src, dst = self.bm.move_layer(r.rid, l, HOST, detach=True)
                self.ex.copy_blocks("device", "host", src, dst)
                self.off.proactive_offload(self.now, a.num_tokens, 1)
            self.host_layers[r.rid] = len(self.bm.layers_on(r.rid, HOST))
            return True
        return False

    # ------------------------------------------------------ decode iteration
    def _select_runnable(self, allow_empty: bool = False) -> List[Request]:
        """Pick this iteration's decode batch: device-resident or promotable
        requests with room to grow, most-behind-on-TPOT first."""
        sel: List[Request] = []
        reserved = 0  # growth blocks earmarked for already-selected requests
        for r in sorted(self.decoding,
                        key=lambda q: q.tpot_slo - q.current_tpot(self.now)):
            sel_ids = [q.rid for q in sel] + [r.rid]

            def _need(r: Request = r) -> int:
                """Promotion blocks + growth blocks for r this iteration."""
                need = 0
                for l in self.bm.layers_on(r.rid, HOST):
                    a = self.bm.allocation(r.rid, l)
                    need += len(a.blocks)
                    if a.num_tokens % self.ec.block_size == 0:
                        need += 1
                for l in self.bm.layers_on(r.rid, DEVICE):
                    a = self.bm.allocation(r.rid, l)
                    if a.num_tokens % self.ec.block_size == 0:
                        need += 1
                return need
            while self.bm.num_free(DEVICE) - reserved < _need():
                if not self._evict_newest(exclude=sel_ids):
                    break
            if self.bm.num_free(DEVICE) - reserved < _need():
                continue  # pause this iteration
            growth = _need()
            if self.host_layers.get(r.rid, 0):
                if not self._ensure_device(r):
                    continue
                # promotion blocks were consumed; growth remains earmarked
                growth = sum(
                    1 for l in self.bm.layers_on(r.rid, DEVICE)
                    if self.bm.allocation(r.rid, l).num_tokens
                    % self.ec.block_size == 0)
            reserved += growth
            sel.append(r)
        if not sel and not allow_empty:
            raise RuntimeError("engine wedged: no runnable request")
        return sel

    def _run_decode(self, sel: List[Request]) -> float:
        """Grow allocations, run one real decode step over `sel`, append the
        new tokens. Returns the modeled step time; the caller advances the
        clock and retires finished requests."""
        for r in sel:
            for l in list(self.bm.tables[r.rid]):
                self.bm.extend_layer(r.rid, l, 1)
        maxb = max(len(self.bm.allocation(r.rid, 0).blocks) for r in sel)
        R = len(sel)
        tables = np.zeros((self.L, R, maxb), np.int32)
        for i, r in enumerate(sel):
            for l in range(self.L):
                a = self.bm.allocation(r.rid, l)
                assert a.pool == DEVICE
                tables[l, i, :len(a.blocks)] = a.blocks
        kv_lens = [r.prompt_len + r.tokens_out - 1 for r in sel]
        toks = [r.generated[-1] for r in sel]
        new_toks = self.ex.decode(toks, tables, kv_lens)
        for r, tok in zip(sel, new_toks, strict=True):
            r.generated.append(tok)
            r.tokens_out += 1
        avg_ctx = int(sum(kv_lens) / R) + 1
        return self.cost.decode_step_time(R, avg_ctx, 0.0)

    def _retire_finished(self) -> None:
        # the generation cap backstops runaway requests whose target EOS
        # position exceeds the engine's per-request budget
        cap = self.ec.max_tokens_per_request
        for r in list(self.decoding):
            if r.tokens_out >= min(r.output_len, cap):
                r.finish_time = self.now
                r.phase = Phase.FINISHED
                self.bm.free_request(r.rid)
                self.core.release(r)
                self.predictor.observe(r.output_len)
                self.decoding.remove(r)
                self.done.append(r)
                if self.core.tracer is not None:
                    self.core.tracer.finish(r, self.now)

    # ---------------------------------------------------------------- step
    def step(self) -> bool:
        """One scheduler iteration. Returns False when fully idle."""
        out = self._step_chunked() if self.ec.chunked \
            else self._step_exclusive()
        if self.core.sanitizer is not None:
            self.core.sanitizer.check(self.core)
        return out

    def _step_exclusive(self) -> bool:
        """Exclusive-prefill iteration (vLLM 0.5.5 semantics)."""
        if self.core.admit_waiting(self.now, immediate=self._do_prefill):
            return True
        if not self.decoding:
            return False
        sel = self._select_runnable()
        self.now += self._run_decode(sel)
        for r in sel:
            r.note_token(self.now)
        self._retire_finished()
        return True

    def _step_chunked(self) -> bool:
        """One chunked-mode iteration: admit into the chunk queue, run up
        to `max_prefill_tokens` prompt-chunk tokens (policy-ordered
        admission, FCFS chunk assembly, Eq.1-tightened when slo_aware)
        plus one decode step, and advance the clock by
        max(chunk compute, decode compute) — mixed batching."""
        self.core.admit_waiting(self.now)
        if not (self.prefilling or self.decoding):
            return False
        t0 = self.now

        # decode batch first: its tokens count against the iteration's
        # token budget (same semantics as the simulator)
        sel: List[Request] = []
        if self.decoding:
            sel = self._select_runnable(allow_empty=bool(self.prefilling))
        chunk_work = self.core.assemble_chunks(self.now, len(sel))

        chunk_time = 0.0
        for r, c in chunk_work:
            chunk_time += self.cost.chunk_prefill_time(c, r.prefill_done)

        if self.ec.fused:
            # ONE forward: chunks + decode batch share the weight stream
            R = len(sel)
            avg_ctx = (int(sum(r.prompt_len + r.tokens_out - 1
                               for r in sel) / R) + 1) if sel else 0
            self._run_mixed(chunk_work, sel)
            self.now += self.cost.mixed_step_time(chunk_time, R, avg_ctx,
                                                  fused=True)
        else:
            for r, c in chunk_work:
                self._run_chunk(r, c)
            dec_time = self._run_decode(sel) if sel else 0.0
            self.now += max(chunk_time, dec_time)

        for r in sel:
            r.note_token(self.now)
        if self.core.tracer is not None:
            # chunks already ran: prefill_done holds the post-chunk count
            self.core.tracer.chunk_iteration(
                self.core, t0, self.now, chunk_work,
                done={r.rid: r.prefill_done for r, _ in chunk_work})
        # requests whose final chunk just ran get their first token now
        for r, _ in chunk_work:
            if r.prefill_complete and r.phase is Phase.PREFILL:
                if r.first_token_time < 0:  # survives replica-kill restart
                    r.first_token_time = self.now
                    if self.core.tracer is not None:
                        self.core.tracer.first_token(r, self.now)
                r.tokens_out = 1
                r.note_token(self.now)
                r.phase = Phase.DECODE
                self.prefilling.remove(r)
                self.decoding.append(r)
        self._retire_finished()
        return True

    # ----------------------------------------------------------------- run
    def run(self, requests: List[Request]) -> List[Request]:
        """Batch convenience wrapper: one session, every request submitted
        up front at its own arrival, drained to completion."""
        session = ServingSession(self)
        for r in sorted(requests, key=lambda q: q.arrival):
            session.submit(r, arrival=r.arrival)
        return session.drain()
