"""Deterministic fault injection for the cluster (serving/faults.py).

A `FaultPlan` is a list of `FaultEvent`s stamped on the shared virtual
clock; a `FaultEngine` replays them against a `ClusterSession` as its
clock passes each stamp. Everything is seeded and time-stamped, so a
failure scenario is REPLAYABLE: the same plan over the same workload
produces a bit-identical recovery trace and bit-identical metrics
(pinned by tests/test_faults.py).

Fault taxonomy (docs/ARCHITECTURE.md "Failure model & recovery"):

  crash          replica dies at t: its in-flight and queued work is
                 unwound via the cancel machinery and re-dispatched
                 through the routing policy; `recover_after` revives it
                 cold (KV and prefix cache gone) that much later
  wedge          replica freezes for `duration`: it serves nothing and
                 its clock does not advance (liveness detection, when
                 armed, may declare it dead first)
  slowdown       every step of the replica is stretched by `factor`
                 for `duration` (a straggler, not a corpse)
  dispatch_fail  dispatches to the replica fail transiently for
                 `duration`; the cluster retries with exponential
                 backoff, bounded by `max_dispatch_retries`
  host_exhaust   `blocks` host-pool blocks become unusable for
                 `duration` (models host memory pressure); admission
                 backpressures or sheds instead of wedging
  link_stall     the replica's d2h/h2d offload link is reserved (busy)
                 for `duration` — transfers queue behind it (§3.1.3
                 reservation machinery)

Default-off discipline (lint rule FAULT001): nothing in the serving
stack constructs or consults a `FaultEngine` unless a plan was
explicitly installed (`ClusterSession(fault_plan=...)`), mirroring the
sanitizer's opt-in contract, and every fault-free code path is
bit-identical to the pre-fault scheduler.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import random
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core import HOST

FAULT_KINDS = ("crash", "wedge", "slowdown", "dispatch_fail",
               "host_exhaust", "link_stall")
# synthesized follow-up events (never appear in a user plan)
_INTERNAL_KINDS = ("_revive", "_host_clear")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault on the shared virtual clock."""
    t: float                      # clock stamp the fault fires at
    kind: str                     # one of FAULT_KINDS
    replica: int
    duration: float = 0.0         # window length (wedge/slowdown/...)
    factor: float = 2.0           # slowdown stretch multiplier
    blocks: int = 0               # host_exhaust reserve; 0 = whole pool
    recover_after: float = -1.0   # crash: revive delay; < 0 = permanent

    def describe(self) -> str:
        extra = ""
        if self.kind == "crash":
            extra = (f" recover_after={self.recover_after:g}"
                     if self.recover_after >= 0 else " permanent")
        elif self.kind == "slowdown":
            extra = f" dur={self.duration:g} factor={self.factor:g}"
        elif self.kind == "host_exhaust":
            extra = f" dur={self.duration:g} blocks={self.blocks}"
        elif self.duration:
            extra = f" dur={self.duration:g}"
        return f"t={self.t:g} {self.kind} r{self.replica}{extra}"


class FaultPlan:
    """An immutable, time-ordered fault schedule.

    Build one explicitly, from a seed (`FaultPlan.random`), or from the
    CLI grammar (`FaultPlan.parse`):

        crash@0.5:r0:recover=1.0;wedge@0.2:r1:dur=0.3
        random:7            (seeded; replica count filled in by caller)
    """

    def __init__(self, events: Sequence[FaultEvent]):
        for e in events:
            if e.kind not in FAULT_KINDS:
                raise ValueError(f"unknown fault kind {e.kind!r} "
                                 f"(expected one of {FAULT_KINDS})")
            if e.t < 0:
                raise ValueError(f"fault stamped before t=0: {e}")
        self.events: Tuple[FaultEvent, ...] = tuple(
            sorted(events, key=lambda e: (e.t, e.replica, e.kind)))

    def __len__(self) -> int:
        return len(self.events)

    def describe(self) -> List[str]:
        return [e.describe() for e in self.events]

    @classmethod
    def random(cls, seed: int, n_replicas: int, horizon: float = 10.0,
               n_events: int = 3,
               kinds: Optional[Sequence[str]] = None) -> "FaultPlan":
        """Seeded plan: same (seed, n_replicas, horizon, n_events,
        kinds) -> identical plan, forever. Random crashes always carry
        a recovery so a random plan cannot permanently sink the whole
        cluster."""
        rng = random.Random(seed)
        pool = tuple(kinds) if kinds else FAULT_KINDS
        events: List[FaultEvent] = []
        for _ in range(n_events):
            kind = rng.choice(pool)
            t = round(rng.uniform(0.05, horizon), 4)
            i = rng.randrange(n_replicas)
            dur = round(rng.uniform(0.1, max(horizon / 2, 0.2)), 4)
            if kind == "crash":
                events.append(FaultEvent(
                    t, kind, i,
                    recover_after=round(rng.uniform(0.2, horizon / 2), 4)))
            elif kind == "slowdown":
                events.append(FaultEvent(
                    t, kind, i, duration=dur,
                    factor=round(rng.uniform(1.5, 4.0), 2)))
            elif kind == "host_exhaust":
                events.append(FaultEvent(
                    t, kind, i, duration=dur,
                    blocks=rng.randrange(64, 1024)))
            else:
                events.append(FaultEvent(t, kind, i, duration=dur))
        return cls(events)

    @classmethod
    def parse(cls, spec: str, n_replicas: int = 1,
              horizon: float = 10.0) -> "FaultPlan":
        """Parse the `--fault-plan` CLI grammar (see class docstring)."""
        spec = spec.strip()
        if spec.startswith("random:"):
            parts = spec.split(":")
            seed = int(parts[1])
            n_events = 3
            for p in parts[2:]:
                key, _, val = p.partition("=")
                if key == "n":
                    n_events = int(val)
                else:
                    raise ValueError(f"unknown random-plan option {p!r}")
            return cls.random(seed, n_replicas, horizon=horizon,
                              n_events=n_events)
        events = []
        for item in filter(None, (s.strip() for s in spec.split(";"))):
            head, *opts = item.split(":")
            kind, _, stamp = head.partition("@")
            if not stamp:
                raise ValueError(f"fault {item!r} missing '@time'")
            fields: Dict[str, object] = {"t": float(stamp), "kind": kind}
            for opt in opts:
                if opt.startswith("r") and opt[1:].isdigit():
                    fields["replica"] = int(opt[1:])
                    continue
                key, _, val = opt.partition("=")
                if key == "dur":
                    fields["duration"] = float(val)
                elif key == "recover":
                    fields["recover_after"] = float(val)
                elif key in ("factor", "blocks"):
                    fields[key] = type(FaultEvent.__dataclass_fields__
                                       [key].default)(float(val))
                else:
                    raise ValueError(f"unknown fault option {opt!r} "
                                     f"in {item!r}")
            if "replica" not in fields:
                raise ValueError(f"fault {item!r} missing ':rN' replica")
            events.append(FaultEvent(**fields))  # type: ignore[arg-type]
        return cls(events)


class FaultEngine:
    """Replays a `FaultPlan` against a cluster as virtual time passes.

    The cluster polls (`poll(cluster, upto)`) at each step; events
    stamped at or before `upto` fire in stamp order. Crash recoveries
    and host-pool releases are synthesized as internal follow-up events
    so the whole schedule stays a single deterministic queue. Window
    predicates (`is_wedged` / `slow_factor` / `dispatch_fails`) are pure
    reads keyed on the query time."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._seq = itertools.count()
        self._queue: List[Tuple[float, int, FaultEvent]] = [
            (e.t, next(self._seq), e) for e in plan.events]
        heapq.heapify(self._queue)
        self.trace: List[str] = []       # applied events, in fire order
        self._wedge: Dict[int, Tuple[float, float]] = {}
        self._slow: Dict[int, Tuple[float, float, float]] = {}
        self._dfail: Dict[int, List[Tuple[float, float]]] = {}

    # ------------------------------------------------------------- apply
    def poll(self, cluster, upto: float) -> None:
        """Fire every event stamped at or before `upto`, in order."""
        while self._queue and self._queue[0][0] <= upto:
            _, _, ev = heapq.heappop(self._queue)
            self._apply(cluster, ev)

    def _push(self, ev: FaultEvent) -> None:
        heapq.heappush(self._queue, (ev.t, next(self._seq), ev))

    def _apply(self, cluster, ev: FaultEvent) -> None:
        i = ev.replica
        if i >= cluster.n_replicas:
            return  # plan written for a bigger cluster; ignore
        self.trace.append(ev.describe())
        if cluster.tracer is not None:
            cluster.tracer.instant("fault", ev.t, kind=ev.kind,
                                   replica=i)
        if ev.kind == "crash":
            if cluster.alive[i]:
                cluster.kill(i, reason="fault", at=ev.t)
                if ev.recover_after >= 0:
                    self._push(FaultEvent(ev.t + ev.recover_after,
                                          "_revive", i))
        elif ev.kind == "_revive":
            cluster.revive(i, at=ev.t)
        elif ev.kind == "wedge":
            start, end = self._wedge.get(i, (ev.t, ev.t))
            self._wedge[i] = (min(start, ev.t),
                              max(end, ev.t + ev.duration))
        elif ev.kind == "slowdown":
            self._slow[i] = (ev.t, ev.t + ev.duration, ev.factor)
        elif ev.kind == "dispatch_fail":
            self._dfail.setdefault(i, []).append(
                (ev.t, ev.t + ev.duration))
        elif ev.kind == "host_exhaust":
            core = cluster.cores[i]
            amount = ev.blocks if ev.blocks > 0 \
                else core.bm.pools[HOST].num_blocks
            core.fault_host_reserve += amount
            self._push(FaultEvent(ev.t + ev.duration, "_host_clear", i,
                                  blocks=amount))
        elif ev.kind == "_host_clear":
            core = cluster.cores[i]
            core.fault_host_reserve = max(
                0, core.fault_host_reserve - ev.blocks)
        elif ev.kind == "link_stall":
            cluster.cores[i].off.ledger.reserve(ev.t, ev.duration)

    # ------------------------------------------------------- pure reads
    def next_event_time(self) -> Optional[float]:
        return self._queue[0][0] if self._queue else None

    def has_pending(self) -> bool:
        return bool(self._queue)

    def is_wedged(self, i: int, now: float) -> bool:
        w = self._wedge.get(i)
        return w is not None and w[0] <= now < w[1]

    def wedge_end(self, i: int) -> float:
        return self._wedge[i][1]

    def slow_factor(self, i: int, now: float) -> float:
        s = self._slow.get(i)
        return s[2] if s is not None and s[0] <= now < s[1] else 1.0

    def dispatch_fails(self, i: int, when: float) -> bool:
        return any(s <= when < e for s, e in self._dfail.get(i, ()))
