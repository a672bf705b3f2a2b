"""Event tracer: per-request lifecycle spans, scheduler decision
records, and exact TTFT attribution.

Imported ONLY when `ServeConfig.trace` is on (the guarded
`SchedulerCore.__init__` install mirrors the sanitizer); with tracing
off this module never enters `sys.modules` and the hot paths carry a
single ``tracer is None`` test — the overhead guard in
tests/test_obs.py pins both.

Event vocabulary (`EVENT_TYPES` below — docs/ARCHITECTURE.md must list
every member, enforced by tools/check_docs.py):

  spans     queued, prefill, prefill_chunk, decode, paused
  request   first_token, preempt, resume, finish, cancel, shed
  scheduler sched_pass  (one per admission pass: who got in, who was
            blocked on which gate, pool occupancy per layer/tier,
            transfer-ledger activity)
  cluster   fault, kill, revive, drain, retry, redispatch

TTFT attribution (the paper's Figure-2 decomposition, made exact): each
request carries a running partition of [arrival, first_token_time] into
cause-labelled intervals. The protocol is *forward-pending*: every
interval is attributed to the cause diagnosed at its START (the gate
observed at an admission pass explains the wait until the next pass;
"arrival_sync" covers the stretch before the scheduler first examined
the request). Every advance telescopes `last_t`, so

    sum(ttft_breakdown(rid).values()) == first_token_time - arrival

holds EXACTLY by construction — tests/test_obs.py asserts it on both
backends across the scheduling axes. A vLLM recompute-preemption resets
`first_token_time`; the tracer reopens the partition with the thrown-away
decode time attributed to "recompute_lost" so the invariant holds for
the NEW first token too. Causes (docs/ARCHITECTURE.md "Observability"):

  arrival_sync         waiting before/between scheduler examinations
  gate:max_batch_size  admission pass stopped on the batch-slot cap
  gate:alg1_budget     stopped on the Alg.1 SLO admission budget
  gate:token_budget    stopped on the Eq.1 per-pass token budget
  gate:device_blocks   stopped on the device KV-block gate
  gate:host_reserve    stopped on host-pool reservation / allocation
  preempted            paused by the lossless preemption controller
  prefill              prefill compute (incl. the offload overlap)
  prefill_stall        in the chunk queue but given no chunk this
                       iteration (budget went to decode / other chunks)
  recompute_lost       decode progress discarded by a recompute
                       preemption (vllm policy)
  recompute_requeue    re-queued after a recompute preemption, not yet
                       re-examined

Timestamps are the backend's virtual clock (seconds); the engine
additionally stamps wall-clock seconds on every event (`wall_clock`
hook) so real-execution traces carry both timelines.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

from repro_torch.core import DEVICE, HOST

EVENT_TYPES = (
    # spans (t0/t1)
    "queued", "prefill", "prefill_chunk", "decode", "paused",
    # request instants
    "first_token", "preempt", "resume", "finish", "cancel", "shed",
    # scheduler decision record
    "sched_pass",
    # cluster instants
    "fault", "kill", "revive", "drain", "retry", "redispatch",
)

ATTRIBUTION_CAUSES = (
    "arrival_sync", "gate:max_batch_size", "gate:alg1_budget",
    "gate:token_budget", "gate:device_blocks", "gate:host_reserve",
    "preempted", "prefill", "prefill_stall", "recompute_lost",
    "recompute_requeue",
)


class _Attr:
    """Per-request attribution state: a telescoping partition of
    [queue start, now] into cause-labelled intervals."""

    __slots__ = ("last_t", "pending", "queue_t0", "intervals", "final")

    def __init__(self, t0: float) -> None:
        self.last_t = t0
        self.pending = "arrival_sync"
        self.queue_t0 = t0            # start of the current queued span
        self.intervals: Dict[str, float] = {}
        self.final = False


class Tracer:
    """One tracer per `SchedulerCore` (the cluster adds its own for
    fleet-level instants). Every emission site in src/repro is guarded
    by a ``tracer is not None`` test (repro-lint rule OBS001)."""

    def __init__(self) -> None:
        self.events: List[dict] = []
        self._attr: Dict[str, _Attr] = {}
        self._pause_t: Dict[str, float] = {}
        # engine hook: () -> wall seconds, stamped as ev["wall"]
        self.wall_clock: Optional[Callable[[], float]] = None

    # ------------------------------------------------------ raw emission
    def _emit(self, ev: dict) -> None:
        assert ev["type"] in EVENT_TYPES, ev["type"]
        if self.wall_clock is not None:
            ev["wall"] = self.wall_clock()
        self.events.append(ev)

    def span(self, etype: str, rid: Optional[str], t0: float, t1: float,
             **args: object) -> None:
        self._emit({"type": etype, "rid": rid, "t0": t0, "t1": t1,
                    "args": args})

    def instant(self, etype: str, t: float, rid: Optional[str] = None,
                **args: object) -> None:
        self._emit({"type": etype, "rid": rid, "t": t, "args": args})

    # ------------------------------------------------------- attribution
    def _ensure(self, r) -> _Attr:
        a = self._attr.get(r.rid)
        if a is None:
            a = self._attr[r.rid] = _Attr(r.arrival)
        return a

    @staticmethod
    def _advance(a: _Attr, t: float, cause: str) -> None:
        dt = t - a.last_t
        if dt > 0.0:
            a.intervals[cause] = a.intervals.get(cause, 0.0) + dt
            a.last_t = t

    def ttft_breakdown(self, rid: str) -> Dict[str, float]:
        """cause -> seconds partition of this request's TTFT (complete
        once its first token is out; empty for an unknown rid)."""
        a = self._attr.get(rid)
        return dict(a.intervals) if a is not None else {}

    def breakdowns(self) -> Dict[str, Dict[str, float]]:
        """Finalized TTFT partitions for every first-tokened request."""
        return {rid: dict(a.intervals) for rid, a in self._attr.items()
                if a.final}

    # -------------------------------------------------- lifecycle hooks
    def sched_pass(self, core, now: float, admitted: List,
                   stop_gate: Optional[str],
                   immediate_mode: bool = False) -> None:
        """One admission pass: close the queue-wait intervals of admitted
        requests, stamp the blocking gate onto every request still
        waiting, and emit the decision record (who/why + pool occupancy
        per layer/tier + ledger activity)."""
        for r in admitted:
            a = self._ensure(r)
            if r.first_token_time < 0.0 or (immediate_mode
                                            and not a.final):
                t0 = r.prefill_start if r.prefill_start >= 0.0 else now
                self._advance(a, t0, a.pending)
                a.pending = "prefill"
                self.span("queued", r.rid, a.queue_t0, t0)
                if immediate_mode and r.first_token_time >= t0:
                    # exclusive engine: the whole prefill already ran
                    # inside this pass — close the prefill span + first
                    # token too. (A redispatched request keeps its dead
                    # incarnation's EARLIER stamp and stays open: no new
                    # first token is coming, so no finalization.)
                    self.first_token(r, r.first_token_time)
        gate = stop_gate or "arrival_sync"
        blocked: Dict[str, str] = {}
        for r in core.waiting:
            a = self._ensure(r)
            if r.first_token_time < 0.0 and not a.final:
                self._advance(a, now, a.pending)
                a.pending = gate
            blocked[r.rid] = gate
        ldev = [0] * core.L
        lhost = [0] * core.L
        for layers in core.bm.tables.values():
            for layer, alloc in layers.items():
                tgt = ldev if alloc.pool == DEVICE else lhost
                tgt[layer] += len(alloc.blocks)
        self.instant(
            "sched_pass", now,
            admitted=[r.rid for r in admitted], blocked=blocked,
            stop_gate=stop_gate, in_flight=core.in_flight(),
            paused=len(core.paused),
            pool={
                DEVICE: {"total": core.bm.pools[DEVICE].num_blocks,
                         "free": core.bm.num_free(DEVICE)},
                HOST: {"total": core.bm.pools[HOST].num_blocks,
                       "free": core.bm.num_free(HOST)},
            },
            layer_device_blocks=ldev, layer_host_blocks=lhost,
            ledger={"busy_until": core.off.ledger.busy_until,
                    "n_transfers": len(core.off.ledger.log)})

    def chunk_iteration(self, core, t0: float, t1: float,
                        chunk_work: List,
                        done: Optional[Dict[str, int]] = None) -> None:
        """One chunked iteration [t0, t1]: a prefill_chunk span per
        chunk, `prefill` attribution for requests that ran a chunk,
        `prefill_stall` for prefilling requests that got none. `done`
        maps rid -> prompt tokens completed AFTER this chunk — pass it
        when the caller already folded the chunk into `prefill_done`
        (the engine); the simulator calls pre-bookkeeping and omits it."""
        ran = set()
        for r, c in chunk_work:
            ran.add(r.rid)
            d = done[r.rid] if done is not None else r.prefill_done + c
            self.span("prefill_chunk", r.rid, t0, t1, tokens=c, done=d)
            a = self._attr.get(r.rid)
            if a is not None and r.first_token_time < 0.0:
                self._advance(a, t1, "prefill")
        for r in core.prefilling:
            if r.rid in ran:
                continue
            a = self._attr.get(r.rid)
            if a is not None and r.first_token_time < 0.0:
                self._advance(a, t1, "prefill_stall")

    def first_token(self, r, t: float) -> None:
        """First token at `t`: close the partition (exactness: `last_t`
        telescoped from arrival, so the intervals sum to t - arrival)."""
        a = self._ensure(r)
        self._advance(a, t, "prefill")
        if r.prefill_start >= 0.0:
            self.span("prefill", r.rid, r.prefill_start, t,
                      chunks=r.n_chunks, cached=r.cached_prompt_len)
        self.instant("first_token", t, rid=r.rid,
                     ttft=t - r.arrival)
        a.final = True
        # if a recompute preemption later discards this request's decode
        # progress, the reopened partition charges that stretch here
        a.pending = "recompute_lost"

    def preempt(self, r, t: float, mode: str) -> None:
        """`mode` is "pause" (lossless, KV parked on HOST) or
        "recompute" (vllm: KV dropped, request re-queued)."""
        self.instant("preempt", t, rid=r.rid, mode=mode,
                     n=r.n_preempted)
        a = self._attr.get(r.rid)
        if a is None:
            return
        if mode == "pause":
            self._pause_t[r.rid] = t
            if r.first_token_time < 0.0 and not a.final:
                self._advance(a, t, a.pending)
                a.pending = "preempted"
        else:
            # first_token_time was just reset: reopen the partition so
            # it stays exact for the NEW first token
            self._advance(a, t, a.pending)
            a.pending = "recompute_requeue"
            a.queue_t0 = t
            a.final = False

    def resume(self, r, t: float) -> None:
        self.instant("resume", t, rid=r.rid)
        t0 = self._pause_t.pop(r.rid, None)
        if t0 is not None:
            self.span("paused", r.rid, t0, t)
        a = self._attr.get(r.rid)
        if a is not None and r.first_token_time < 0.0 and not a.final:
            self._advance(a, t, a.pending)
            a.pending = "prefill"

    def finish(self, r, t: float) -> None:
        if r.first_token_time >= 0.0:
            self.span("decode", r.rid, r.first_token_time, t,
                      tokens=r.tokens_out)
        self.instant("finish", t, rid=r.rid, tokens=r.tokens_out)

    def cancel(self, r, t: float) -> None:
        self.instant("cancel", t, rid=r.rid)

    def shed(self, r, t: float, reason: str) -> None:
        self.instant("shed", t, rid=r.rid, reason=reason)
