"""Cluster serving: one router, N replica backends, one session API.

A `ClusterSession` owns N replicas — each a `ServingSession` over any
`ServingBackend` (the real `LayerKVEngine` or the discrete-event
`ServingSimulator`; heterogeneous pool geometry is allowed) — and
exposes the exact submit/stream/cancel/drain/reap surface of a single
session. The one new decision is DISPATCH: which replica's queue a
request joins, made by a pluggable `RoutingPolicy` (serving/router.py)
at the request's arrival time on the shared virtual clock.

Time. Each replica backend keeps its own virtual clock (cost-model
driven on both backends), so the cluster is a discrete-event system of
N servers plus one arrival stream. `step()` always advances the replica
whose next event is EARLIEST on the shared virtual clock, and a parked
arrival is dispatched exactly when it becomes the earliest event — so
routing observes each replica's state as of the arrival, never the
future. Replica clocks advance in lockstep order of events, exactly
like a multi-server event queue.

Identity. A cluster of 1 is bit-identical to a bare `ServingSession`
over the same backend: every arrival dispatches to replica 0 before the
same step it would have fed in a bare session, and the routing policies
only *read* scheduler state — `tests/test_cluster.py` pins tokens on
the engine and exact metrics on the simulator across all five
scheduling axes and all four policies. The fault-tolerance machinery
below preserves a second identity: with no `FaultPlan` and no manual
`kill`/`drain_replica` call, every new code path is unreachable and the
cluster behaves bit-identically to the pre-fault implementation.

Fault tolerance. Replicas can fail and recover on the shared virtual
clock — injected deterministically by a `FaultPlan` (serving/faults.py)
or forced manually:

  * `kill(i)` hard-fails replica i NOW: its parked arrivals return to
    the cluster heap, every live request it owns is unwound through the
    PR 4 cancel machinery (all KV freed — the replica's memory is gone),
    the already-streamed tokens are salvaged onto the `ClusterHandle`
    (a consumer never sees a gap or a duplicate), and the remainder of
    each request is re-dispatched through the routing policy. Restart
    folds the delivered tokens into the prompt, so only the UNSTREAMED
    remainder is recomputed and context math stays exact.
  * `drain_replica(i)` is the graceful variant: queued-but-unstarted
    work re-routes immediately (it holds no KV), in-flight work
    finishes normally, and the replica retires once empty.
  * `revive(i)` brings a killed replica back COLD (its prefix cache is
    dropped — the memory did not survive) at a given virtual time.
  * Liveness: with `liveness_timeout` set, a replica whose next due
    event lags the shared clock by more than the timeout while it is
    frozen (fault-wedged or backpressure-stalled) is declared dead and
    killed — detection by missing heartbeat, not by oracle knowledge of
    the injected fault.
  * Dispatch-level faults retry with exponential backoff
    (`retry_backoff * 2**k`), bounded by `max_dispatch_retries`; a
    request that exhausts its retries is SHED with the typed reason
    `DispatchFailed` instead of wedging the cluster.
  * Prefix affinity survives a kill: the first re-dispatched request of
    a template records its recovery target in `_template_home`, and
    subsequent re-dispatched requests of the same template follow it
    (the template re-registers its prefix on the recovery replica).

Cancellation routes to the owning replica and reuses the PR 4 unwind;
a request cancelled before its arrival dispatches is unwound entirely
inside the cluster (nothing is in flight anywhere). `metrics()` merges
the replicas' `SimMetrics` by POOLING raw latency series
(`SimMetrics.merge`) — per-replica percentiles are never averaged —
and adds the cluster-level fault counters (kills, recoveries, retries,
re-dispatches, cluster-level sheds).
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Iterator, List, Optional, Sequence, Union

from repro_torch.core import DEVICE
from repro_torch.core.block_manager import block_hashes
from repro_torch.obs.registry import MetricsRegistry
from repro_torch.serving.faults import FaultEngine, FaultPlan
from repro_torch.serving.request import Phase, Request
from repro_torch.serving.router import RoutingPolicy, make_routing_policy
from repro_torch.serving.scheduler import AdmissionImpossible, DispatchFailed
from repro_torch.serving.session import RequestHandle, ServingBackend, \
    ServingSession, cancel_parked
from repro_torch.serving.sim import SimMetrics


@dataclasses.dataclass
class ReplicaStats:
    """Per-replica dispatch accounting for the drain report."""
    dispatched: int = 0
    steps: int = 0
    peak_occupancy: float = 0.0   # max device-pool occupancy observed


@dataclasses.dataclass
class ClusterHandle:
    """A submitted request, as seen by the cluster caller. Before its
    arrival dispatches, the request lives only in the cluster's pending
    heap (no replica knows it); afterwards the handle delegates to the
    owning replica's `RequestHandle`.

    The handle survives replica failure: when the owning replica is
    killed, the tokens its dead incarnation already produced are
    salvaged into `_salvaged` (minus the prefix the consumer already
    took, tracked by `_salvage_cursor`) and the request is re-dispatched
    with a fresh inner handle — `take_new()` keeps delivering each token
    exactly once across any number of kills."""

    request: Request
    cluster: "ClusterSession"
    replica: Optional[int] = None           # set at dispatch
    _inner: Optional[RequestHandle] = None  # set at dispatch
    #: tokens produced by DEAD incarnations, in stream order
    _salvaged: List[int] = dataclasses.field(default_factory=list)
    #: how much of `_salvaged` the consumer has already taken
    _salvage_cursor: int = 0

    @property
    def rid(self) -> str:
        return self.request.rid

    @property
    def phase(self) -> Phase:
        return self.request.phase

    @property
    def finished(self) -> bool:
        return self.request.phase is Phase.FINISHED

    @property
    def cancelled(self) -> bool:
        return self.request.phase is Phase.CANCELLED

    @property
    def shed(self) -> bool:
        """True when the request was rejected under overload or fault
        pressure (graceful degradation); the typed reason is on
        `request.shed_reason`. Terminal, like cancelled."""
        return self.request.phase is Phase.SHED

    @property
    def done(self) -> bool:
        return self.finished or self.cancelled or self.shed

    def take_new(self) -> List[int]:
        """Tokens produced since the last call (non-blocking); [] until
        the request has dispatched to a replica. After a replica kill
        the salvaged backlog drains first, then the live incarnation's
        stream; simulator ordinals are rebased by `tokens_salvaged` so
        the combined stream counts 0,1,2,... without repeats."""
        out = list(self._salvaged[self._salvage_cursor:])
        self._salvage_cursor = len(self._salvaged)
        if self._inner is not None:
            new = self._inner.take_new()
            base = self.request.tokens_salvaged
            if base and not self._inner.session.backend.produces_token_ids:
                new = [base + v for v in new]
            out.extend(new)
        return out

    def _salvage(self) -> None:
        """Preserve the dead incarnation's stream on the handle: every
        token it produced joins `_salvaged`, and the cursor skips the
        prefix the inner handle already delivered. Detaches the inner
        handle — the replica that owned it is gone."""
        r = self.request
        inner = self._inner
        if inner is None:
            return
        if inner.session.backend.produces_token_ids:
            vals = [int(t) for t in r.generated[:r.tokens_out]]
        else:
            base = r.tokens_salvaged
            vals = list(range(base, base + r.tokens_out))
        delivered = inner._cursor
        self._salvaged.extend(vals)
        self._salvage_cursor += delivered
        self._inner = None
        self.replica = None

    def cancel(self) -> bool:
        return self.cluster.cancel(self)


class ClusterSession:
    """Multi-replica serving frontend: same API as `ServingSession`,
    plus a routing policy, per-replica introspection, and replica
    failure injection/detection/recovery (module docstring)."""

    def __init__(self, backends: Sequence[ServingBackend],
                 router: Union[str, RoutingPolicy] = "round_robin",
                 fault_plan: Optional[FaultPlan] = None,
                 liveness_timeout: Optional[float] = None,
                 max_dispatch_retries: int = 8,
                 retry_backoff: float = 0.05):
        if not backends:
            raise ValueError("a cluster needs at least one backend")
        self.sessions = [ServingSession(b) for b in backends]
        self.router = make_routing_policy(router)
        self._pending: list = []           # (arrival, seq, Request) heap
        self._seq = itertools.count()
        self.handles: dict = {}            # rid -> ClusterHandle
        self.cancelled: List[Request] = []  # cancelled before dispatch
        self.stats = [ReplicaStats() for _ in backends]
        # --- fault tolerance (all inert without a plan / manual kill) ---
        self.faults = FaultEngine(fault_plan) \
            if fault_plan is not None else None
        self.liveness_timeout = liveness_timeout
        self.max_dispatch_retries = max_dispatch_retries
        self.retry_backoff = retry_backoff
        self.alive = [True] * len(self.sessions)
        self.draining = [False] * len(self.sessions)
        self.shed: List[Request] = []      # shed at cluster level
        #                                    (dispatch retries exhausted)
        self.recovery_log: List[str] = []  # deterministic replay trace
        self._template_home: dict = {}     # prefix anchor -> recovery
        #                                    replica (kill re-homing)
        # cluster-level counters (kills/recoveries/retries/redispatch/
        # shed) live in the obs registry; back-compat properties below
        self.registry = MetricsRegistry()
        self.retry_priorities: List[int] = []
        self.redispatch_priorities: List[int] = []
        # fleet-level event stream (kill/revive/drain/retry/redispatch/
        # fault instants), present iff the replicas themselves trace —
        # one more track merged onto the shared virtual clock
        self.tracer = None
        if any(s.core.tracer is not None for s in self.sessions):
            from repro_torch.obs.trace import Tracer
            self.tracer = Tracer()

    # ---------------------------------------------- counter back-compat
    @property
    def n_kills(self) -> int:
        return int(self.registry.get("replica_kills"))

    @property
    def n_recoveries(self) -> int:
        return int(self.registry.get("replica_recoveries"))

    @property
    def n_retries(self) -> int:
        return int(self.registry.get("dispatch_retries"))

    @property
    def n_replicas(self) -> int:
        return len(self.sessions)

    @property
    def cores(self):
        return [s.core for s in self.sessions]

    def clock(self) -> float:
        """The shared virtual clock: the furthest any replica has
        simulated. Arrivals stamped "now" are dispatched once every
        earlier replica event has run (virtual-time event order)."""
        return max(s.backend.clock() for s in self.sessions)

    # ------------------------------------------------------------ submit
    def submit(self, request: Request,
               arrival: Optional[float] = None) -> ClusterHandle:
        """Enqueue a request. An arrival at or before the shared clock
        routes NOW (it has already arrived — exactly the bare session's
        direct-to-waiting path, in submit order); a future arrival parks
        in the cluster heap and routes when the shared clock reaches it,
        so load-aware policies observe arrival-time load, never
        submission-time load. `arrival=None` stamps the current shared
        clock. rids are unique cluster-wide."""
        if request.rid in self.handles:
            raise ValueError(f"duplicate rid {request.rid!r}")
        now = self.clock()
        request.arrival = now if arrival is None else arrival
        h = ClusterHandle(request, self)
        self.handles[request.rid] = h
        if request.arrival <= now:
            self._route(request)
        else:
            heapq.heappush(self._pending,
                           (request.arrival, next(self._seq), request))
        return h

    def _anchor(self, r: Request):
        """The prompt's content-addressing anchor — the same key
        `prefix_affinity` rendezvouses on — used to re-home a template
        after its replica is killed. None when there is no prompt."""
        toks = r.prompt
        if not toks:
            return None
        bs = self.cores[0].bm.block_size
        return block_hashes(toks, bs)[0] if len(toks) >= bs \
            else hash(tuple(toks))

    def _route(self, r: Request,
               when: Optional[float] = None) -> Optional[int]:
        """Pick r's replica and hand it to that replica's session (which
        parks still-future arrivals in its own heap — a replica clock can
        lag the shared clock). Returns the chosen replica index, or None
        when dispatch failed (no live replica, or an injected transient
        failure) and the request was parked for retry / shed.

        Routing only ever considers live, non-draining replicas; with
        every replica healthy the candidate list is the full replica
        list and the path is bit-identical to the pre-fault router call.
        A re-dispatched request (`n_redispatched > 0`) prefers its
        template's recorded recovery home so prefix affinity survives
        the kill that displaced it.

        Feasibility backstop (heterogeneous geometry): a policy may pick
        a replica whose pool can NEVER fit the request — the same
        `device_need` test `wedged_error` reports on. When another live
        replica could serve it, the request is re-routed to the feasible
        replica with the least KV-block demand instead of wedging a
        queue forever; when NO replica fits (including a cluster of 1),
        the choice stands and drain raises AdmissionImpossible exactly
        like a bare session."""
        t = r.arrival if when is None else when
        live = [j for j in range(self.n_replicas)
                if self.alive[j] and not self.draining[j]]
        if not live:
            return self._dispatch_failed(r, t)
        cores = self.cores
        i: Optional[int] = None
        if r.n_redispatched:
            home = self._template_home.get(self._anchor(r))
            if home is not None and home in live:
                i = home
        if i is None:
            c = self.router.choose(r, [cores[j] for j in live], t)
            if not 0 <= c < len(live):
                raise ValueError(
                    f"router {self.router.name!r} chose replica {c} "
                    f"of {len(live)}")
            i = live[c]

        def _fits(j: int) -> bool:
            # memoize=False: replicas that don't win the request must
            # not retain a plan memo nothing will ever release
            return cores[j].device_need(r, memoize=False) <= \
                cores[j].bm.pools[DEVICE].num_blocks

        if not _fits(i):
            feasible = [j for j in live if _fits(j)]
            if feasible:
                i = min(feasible,
                        key=lambda j: (cores[j].load_stats().kv_demand, j))
        if self.faults is not None and self.faults.dispatch_fails(i, t):
            return self._dispatch_failed(r, t)
        h = self.handles[r.rid]
        h.replica = i
        # a re-dispatch must not be served before `when` on the target's
        # (possibly lagging) clock, but the request keeps its TRUE
        # arrival for metrics — queueing delay honestly includes the
        # outage. ServingSession.submit stamps r.arrival; restore it.
        orig = r.arrival
        h._inner = self.sessions[i].submit(r, arrival=max(orig, t))
        r.arrival = orig
        if r.n_redispatched:
            a = self._anchor(r)
            if a is not None:
                self._template_home.setdefault(a, i)
        self.stats[i].dispatched += 1
        return i

    def _dispatch_failed(self, r: Request, t: float) -> Optional[int]:
        """Transient dispatch failure (injected, or no live replica):
        bounded retry with exponential backoff; a request that exhausts
        `max_dispatch_retries` is SHED with the typed `DispatchFailed`
        reason instead of spinning forever."""
        r.n_dispatch_retries += 1
        self.registry.inc("dispatch_retries")
        self.retry_priorities.append(r.priority)
        if self.tracer is not None:
            self.tracer.instant("retry", t, rid=r.rid,
                                attempt=r.n_dispatch_retries)
        if r.n_dispatch_retries > self.max_dispatch_retries:
            r.phase = Phase.SHED
            r.shed_reason = DispatchFailed.__name__
            r.finish_time = t
            self.shed.append(r)
            self.registry.inc("shed_total",
                              reason=DispatchFailed.__name__)
            h = self.handles[r.rid]
            h._inner = None
            h.replica = None
            self.recovery_log.append(
                f"t={t:.6f} shed {r.rid} (dispatch retries exhausted)")
            if self.tracer is not None:
                self.tracer.shed(r, t, DispatchFailed.__name__)
            return None
        delay = self.retry_backoff * (2 ** (r.n_dispatch_retries - 1))
        heapq.heappush(self._pending, (t + delay, next(self._seq), r))
        return None

    def _dispatch(self) -> Optional[int]:
        when, _, r = heapq.heappop(self._pending)
        return self._route(r, when=max(when, r.arrival))

    # --------------------------------------------------- failure / recovery
    def _restart(self, r: Request, now: float) -> None:
        """Reset an unwound request so the scheduler re-serves exactly
        the UNSTREAMED remainder. Tokens the dead incarnation already
        produced are folded into the prompt — real ids on the engine,
        per-request sentinel ids on the simulator (negative, so they can
        only ever prefix-match this request's own later restarts) — so
        context-length math (`prompt_len + tokens_out`) stays exact and
        the finish check yields precisely the remaining tokens.
        `tokens_out` is incarnation-local; `tokens_salvaged` carries the
        delivered count across incarnations. First/last token stamps
        survive: TTFT measures the FIRST incarnation's first token, and
        `max_tbt` honestly spans the outage gap."""
        produced = r.tokens_out
        if produced:
            if r.generated:
                r.prompt = list(r.prompt or []) \
                    + [int(t) for t in r.generated[:produced]]
                r.generated = []
            elif r.prompt is not None:
                base = r.tokens_salvaged
                r.prompt = list(r.prompt) \
                    + [-(base + k + 1) for k in range(produced)]
            r.prompt_len += produced
            r.output_len -= produced
            r.tokens_salvaged += produced
        r.tokens_out = 0
        r.phase = Phase.QUEUED
        r.prefill_start = -1.0
        r.prefill_done = 0
        r.n_chunks = 0
        r.cached_prompt_len = 0
        r.n_redispatched += 1
        self.redispatch_priorities.append(r.priority)
        self.registry.inc("redispatches")
        if self.tracer is not None:
            self.tracer.instant("redispatch", now, rid=r.rid,
                                n=r.n_redispatched,
                                salvaged=r.tokens_salvaged)

    def kill(self, i: int, reason: str = "manual",
             at: Optional[float] = None) -> None:
        """Hard-fail replica i NOW. Its parked arrivals return to the
        cluster heap untouched (nothing was in flight); every live
        request it owns is salvaged (streamed tokens preserved on the
        cluster handle), unwound through the cancel machinery (all its
        KV freed — the replica's memory is gone), restarted in place and
        re-dispatched through the routing policy. No request is lost or
        duplicated. The dead core is sanitizer-checked back to baseline;
        template homes pointing at the corpse are dropped. Idempotent on
        an already-dead replica. `at` is the virtual time the failure
        occurred (a fault event's stamp — the poll that delivers it may
        run a step later; the unwind is stamped at the failure)."""
        if not self.alive[i]:
            return
        now = self.clock() if at is None else at
        s = self.sessions[i]
        core = s.core
        self.alive[i] = False
        self.draining[i] = False
        self.registry.inc("replica_kills")
        self.recovery_log.append(f"t={now:.6f} kill r{i} ({reason})")
        if self.tracer is not None:
            self.tracer.instant("kill", now, replica=i, reason=reason)
        self._template_home = {a: j for a, j in self._template_home.items()
                               if j != i}
        parked = [e[2] for e in s._pending]
        s._pending.clear()
        live = list(core.waiting) + list(core.prefilling) \
            + list(core.decoding) + list(core.paused)
        for r in live:
            h = self.handles[r.rid]
            h._salvage()
            s.backend.cancel(r)
            # a kill is not a user cancel: pull it back out of the
            # replica's cancelled list before re-dispatching
            core.cancelled.remove(r)
            s.handles.pop(r.rid, None)
            self._restart(r, now)
        for r in parked:
            h = self.handles[r.rid]
            h._inner = None
            h.replica = None
            s.handles.pop(r.rid, None)
            heapq.heappush(self._pending,
                           (max(r.arrival, now), next(self._seq), r))
        # post-unwind: the dead core must be back at pool baseline
        # before anything is re-dispatched (S1-S9)
        if core.sanitizer is not None:
            core.sanitizer.check(core, full=True)
            core.sanitizer.check_recovery_baseline(core)
        for r in live:
            self._route(r, when=now)
        if live or parked:
            self.recovery_log.append(
                f"t={now:.6f} unwound r{i}: {len(live)} live "
                f"re-dispatched, {len(parked)} parked re-parked")

    def revive(self, i: int, at: Optional[float] = None) -> None:
        """Bring a killed replica back COLD at virtual time `at` (the
        shared clock when omitted): its clock advances to the recovery
        time and its prefix cache is dropped — replica memory did not
        survive the failure. New arrivals route to it immediately.
        Idempotent on a live replica."""
        if self.alive[i]:
            return
        t = self.clock() if at is None else at
        s = self.sessions[i]
        s.backend.advance_to(max(t, s.backend.clock()))
        s.core.bm.drop_cache()
        self.alive[i] = True
        self.draining[i] = False
        self.registry.inc("replica_recoveries")
        self.recovery_log.append(f"t={t:.6f} revive r{i}")
        if self.tracer is not None:
            self.tracer.instant("revive", t, replica=i)

    def drain_replica(self, i: int) -> None:
        """Gracefully retire replica i: new work routes elsewhere,
        queued-but-unstarted work re-routes immediately (it holds no
        KV), in-flight work finishes normally, and the replica is
        marked dead once empty (`_retire_drained`). No-op on a dead or
        already-draining replica."""
        if not self.alive[i] or self.draining[i]:
            return
        now = self.clock()
        self.draining[i] = True
        self.recovery_log.append(f"t={now:.6f} drain r{i}")
        if self.tracer is not None:
            self.tracer.instant("drain", now, replica=i)
        s = self.sessions[i]
        core = s.core
        parked = [e[2] for e in s._pending]
        s._pending.clear()
        queued = list(core.waiting)
        for r in queued:
            core.waiting.remove(r)
            core.release(r)   # drop any memoized plan on the old core
            h = self.handles[r.rid]
            h._inner = None
            h.replica = None
            s.handles.pop(r.rid, None)
        for r in parked:
            h = self.handles[r.rid]
            h._inner = None
            h.replica = None
            s.handles.pop(r.rid, None)
            heapq.heappush(self._pending,
                           (max(r.arrival, now), next(self._seq), r))
        for r in queued:
            self._route(r, when=now)
        self._retire_drained()

    def _retire_drained(self) -> None:
        for i, s in enumerate(self.sessions):
            if self.draining[i] and self.alive[i] \
                    and s.next_event_time() is None:
                self.alive[i] = False
                self.draining[i] = False
                self.recovery_log.append(
                    f"t={self.clock():.6f} retired r{i} (drained)")

    def _liveness_kill(self, nxt, frozen, now: float) -> bool:
        """Missing-heartbeat detection: a replica with due work whose
        clock lags the shared clock by more than `liveness_timeout`
        while frozen (fault-wedged or backpressure-stalled — the
        detector cannot tell, which is the point) is declared dead."""
        for t, i in nxt:
            if t is None or not self.alive[i] or i not in frozen:
                continue
            if now - t > self.liveness_timeout:
                self.kill(i, reason=f"liveness ({now - t:.3f}s silent)")
                return True
        return False

    # -------------------------------------------------------------- step
    def step(self) -> bool:
        """One cluster event: dispatch the next arrival if it precedes
        every live replica's next event, else step the replica whose
        next event is earliest. A replica that cannot progress (wedged
        on backpressure) is dropped from the event comparison — its
        frozen clock must stall neither the other replicas NOR the
        dispatch of parked arrivals they could serve; a dispatch that
        lands on a stalled replica revives it. Returns False only when
        nothing can progress anywhere.

        With a `FaultPlan` attached, due fault events fire first (on
        the shared clock, and again up to a parked arrival's stamp
        before it dispatches, so an arrival never outruns a fault);
        fault-wedged replicas are excluded from stepping until virtual
        time passes their window; a slowdown window stretches the
        stepped replica's elapsed time by the injected factor; and with
        `liveness_timeout` set, frozen replicas that lag too far are
        killed (detection + recovery, not oracle cleanup)."""
        if self.faults is not None:
            self.faults.poll(self, self.clock())
        self._retire_drained()
        stalled: set = set()
        while True:
            now = self.clock()
            nxt = [(s.next_event_time(), i)
                   for i, s in enumerate(self.sessions)]
            wedged: set = set()
            if self.faults is not None:
                wedged = {i for t, i in nxt
                          if t is not None and self.alive[i]
                          and self.faults.is_wedged(i, now)}
            if self.liveness_timeout is not None \
                    and self._liveness_kill(nxt, stalled | wedged, now):
                stalled.clear()
                continue
            busy = sorted((t, i) for t, i in nxt
                          if t is not None and self.alive[i]
                          and i not in stalled and i not in wedged)
            if self._pending and \
                    (not busy or self._pending[0][0] <= busy[0][0]):
                if self.faults is not None:
                    # fire any fault due before this arrival dispatches
                    self.faults.poll(self, max(now, self._pending[0][0]))
                i = self._dispatch()
                if i is None:
                    # dispatch failed: the request was parked for a
                    # backed-off retry or shed — observable progress,
                    # so hand control back (drain/stream re-evaluate
                    # instead of spinning the retries inside one step)
                    return True
                stalled.discard(i)
                continue
            if not busy:
                if self.faults is not None:
                    if wedged:
                        # only frozen replicas hold events: advance
                        # virtual time to the earliest wedge end so the
                        # outage window passes
                        j = min(wedged,
                                key=lambda k: self.faults.wedge_end(k))
                        self.sessions[j].backend.advance_to(
                            self.faults.wedge_end(j))
                        continue
                    if self.faults.has_pending():
                        # idle but faults still scheduled (e.g. a revive
                        # that unblocks parked retries): jump to them
                        self.faults.poll(
                            self, self.faults.next_event_time())
                        self._retire_drained()
                        continue
                return False
            t_i, i = busy[0]
            before = self.sessions[i].backend.clock()
            if self.sessions[i].step():
                st = self.stats[i]
                st.steps += 1
                st.peak_occupancy = max(st.peak_occupancy,
                                        self.sessions[i].core.occupancy())
                if self.faults is not None:
                    f = self.faults.slow_factor(i, before)
                    if f > 1.0:
                        after = self.sessions[i].backend.clock()
                        self.sessions[i].backend.advance_to(
                            after + (f - 1.0) * max(after - before, 0.0))
                return True
            stalled.add(i)

    @property
    def backlog(self) -> int:
        """Requests accepted but not yet prefilling, cluster-wide."""
        return len(self._pending) + sum(s.backlog for s in self.sessions)

    # ------------------------------------------------------------ stream
    def stream(self, handle: ClusterHandle) -> Iterator[int]:
        """Per-token iterator for one request; every replica advances
        normally while streaming."""
        while True:
            yield from handle.take_new()
            if handle.done:
                return
            if not self.step():
                if self._shed_blocked():
                    continue
                raise self._wedged()

    # ------------------------------------------------------------ cancel
    def cancel(self, handle: ClusterHandle) -> bool:
        """Cancel a live request. Dispatched requests route to the
        owning replica session (live unwind or replica-heap removal —
        the PR 4 path); an undispatched request is unwound entirely here
        (no replica ever saw it). Idempotent; False once done."""
        if handle._inner is not None:
            return handle._inner.cancel()
        return cancel_parked(self._pending, handle.request, self.clock(),
                             self.cancelled)

    # -------------------------------------------------------------- reap
    def reap(self, handle: ClusterHandle) -> Optional[Request]:
        """Release a done request's retained state, cluster-wide: the
        cluster handle plus the owning replica session's handle and
        done/cancelled/shed entry (or the cluster's own, for requests
        that never dispatched or were shed at dispatch)."""
        if not handle.done:
            return None
        r = handle.request
        self.handles.pop(r.rid, None)
        if handle._inner is not None:
            return self.sessions[handle.replica].reap(handle._inner)
        if r in self.cancelled:
            self.cancelled.remove(r)
        if r in self.shed:
            self.shed.remove(r)
        return r

    # ------------------------------------------------------------- drain
    def _wedged(self) -> AdmissionImpossible:
        for s in self.sessions:
            if s.core.waiting:
                return s.core.wedged_error()
        return AdmissionImpossible(
            "cluster wedged with no waiting request (bug)")

    def _shed_blocked(self) -> bool:
        """Graceful degradation at the cluster level: when nothing can
        progress anywhere, ask each replica to shed its blocking head
        (typed reason) rather than wedging — only with `shed_overload`
        on (`SchedulerCore.shed_blocked` is a no-op otherwise)."""
        now = self.clock()
        for s in self.sessions:
            if s.core.shed_blocked(now):
                return True
        return False

    def drain(self) -> List[Request]:
        """Run every replica empty; returns the finished requests in
        finish-time order (a cluster of 1 returns exactly the bare
        session's list — replica done-lists are already time-ordered
        and the sort is stable)."""
        while self._pending or \
                any(s.next_event_time() is not None for s in self.sessions):
            if not self.step():
                if self._shed_blocked():
                    continue
                raise self._wedged()
        for s in self.sessions:
            s.backend.finish()
        out = [r for s in self.sessions for r in s.core.done]
        out.sort(key=lambda r: r.finish_time)
        return out

    # ----------------------------------------------------------- metrics
    def metrics(self) -> SimMetrics:
        """Pooled metrics across replicas (simulator backends): raw
        latency series are concatenated BEFORE means/percentiles —
        averaging per-replica p99s would understate the tail whenever
        replicas are imbalanced, which is exactly what routing policies
        differ on. Requests cancelled or shed before dispatch are
        counted here (no replica ever saw them), as are the cluster's
        fault-tolerance counters."""
        m = SimMetrics.merge([s.backend.metrics() for s in self.sessions])
        m.n_cancelled += len(self.cancelled)
        m.n_shed += len(self.shed)
        m.shed_priorities += [r.priority for r in self.shed]
        m.shed_reasons += [r.shed_reason or "" for r in self.shed]
        m.n_retries += self.n_retries
        m.retry_priorities += list(self.retry_priorities)
        m.n_redispatched += len(self.redispatch_priorities)
        m.redispatch_priorities += list(self.redispatch_priorities)
        m.n_replica_kills += self.n_kills
        m.n_replica_recoveries += self.n_recoveries
        m.shed_rids += [r.rid for r in self.shed]
        return m

    def snapshot(self) -> dict:
        """One flat Prometheus-shaped counter/gauge snapshot for the
        whole fleet: each replica core's registry stamped
        ``replica="i"``, plus the cluster's own counters."""
        return MetricsRegistry.merge_snapshots(
            *[s.core.registry.snapshot(replica=str(i))
              for i, s in enumerate(self.sessions)],
            self.registry.snapshot())

    def perfetto(self) -> dict:
        """Chrome-trace JSON over every replica's event stream plus the
        fleet track, merged on the shared virtual clock. Requires the
        backends to have been built with `ServeConfig.trace`."""
        if self.tracer is None:
            raise ValueError(
                "tracing is off: construct the backends with "
                "ServeConfig(trace=True) to record events")
        from repro_torch.obs.export import perfetto_trace
        tracers = [s.core.tracer for s in self.sessions] + [self.tracer]
        labels = [f"replica {i}" for i in range(self.n_replicas)] \
            + ["cluster"]
        return perfetto_trace(tracers, labels)

    def write_trace(self, path: str) -> None:
        import json
        with open(path, "w") as f:
            json.dump(self.perfetto(), f)

    # --------------------------------------------------------------- run
    def run(self, requests: List[Request]) -> List[Request]:
        """Batch convenience wrapper, mirroring the backends' run()."""
        for r in sorted(requests, key=lambda q: q.arrival):
            self.submit(r, arrival=r.arrival)
        return self.drain()
