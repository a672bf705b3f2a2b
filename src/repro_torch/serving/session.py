"""Online serving sessions: submit / stream / cancel / drain over any
backend that drives the shared `SchedulerCore` (the real `LayerKVEngine`
or the discrete-event `ServingSimulator`).

The old entry point was a closed-loop batch call — `run(requests)`
consumed a pre-sorted list once and raised when it wedged. A
`ServingSession` is the open-loop replacement: requests are submitted
while the system runs, every `step()` interleaves newly-arrived requests
with in-flight iterations, tokens stream out per iteration, and any live
request can be cancelled with its KV (shared prefix blocks, mid-prefill
chunk state, host-resident offloaded layers) unwound. `run()` on both
backends is now a thin wrapper over a session, so every losslessness
test in the repo doubles as an online-vs-offline equivalence test.

Backpressure: a request that cannot be admitted yet simply waits in the
queue — admission retries every step as in-flight work frees blocks.
Only a request that can NEVER fit (pools smaller than its minimum need,
nothing in flight) raises `AdmissionImpossible`, and only from the
blocking entry points (`drain`, `stream`); `step()` just reports idle.

The session clock is the backend's virtual clock. `submit()` without an
explicit arrival stamps the request at the current clock (true online
arrival); an explicit future arrival parks it in a pending heap and the
idle path jumps the clock forward exactly like the old batch loops did.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Iterator, List, Optional, Protocol

from repro_torch.serving.request import Phase, Request
from repro_torch.serving.scheduler import SchedulerCore


class ServingBackend(Protocol):
    """What a session needs from an engine or simulator."""

    core: SchedulerCore
    #: True when steps produce real token ids in Request.generated (the
    #: engine); the simulator only advances `tokens_out` counters.
    produces_token_ids: bool

    def clock(self) -> float: ...
    def advance_to(self, t: float) -> None: ...
    def step(self) -> bool: ...          # one iteration; False when idle
    def cancel(self, r: Request) -> bool: ...
    def finish(self) -> None: ...        # end-of-drain invariant checks


@dataclasses.dataclass
class RequestHandle:
    """A submitted request, as seen by the caller. Carries a stream
    cursor so `take_new()` / `stream()` deliver each token exactly once."""

    request: Request
    session: "ServingSession"
    _cursor: int = 0

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
    def paused(self) -> bool:
        """True while the request is preempted (KV parked on HOST). A
        paused request is still live: it resumes losslessly and keeps
        streaming, so `done` stays False."""
        return self.request.phase is Phase.PAUSED

    @property
    def cancelled(self) -> bool:
        return self.request.phase is Phase.CANCELLED

    @property
    def shed(self) -> bool:
        """True when the scheduler rejected the request under overload
        (graceful degradation, `shed_overload`); the typed reason is on
        `request.shed_reason`. Terminal, like cancelled."""
        return self.request.phase is Phase.SHED

    @property
    def done(self) -> bool:
        return self.finished or self.cancelled or self.shed

    def take_new(self) -> List[int]:
        """Tokens produced since the last call (non-blocking). Real token
        ids on the engine; on the simulator (no real model) the stream
        carries token ordinals instead."""
        r = self.request
        n = r.tokens_out
        if self.session.backend.produces_token_ids:
            n = min(n, len(r.generated))
            new = [int(t) for t in r.generated[self._cursor:n]]
        else:
            new = list(range(self._cursor, n))
        self._cursor = max(self._cursor, n)
        return new

    def cancel(self) -> bool:
        return self.session.cancel(self)


def cancel_parked(pending: list, r: Request, now: float,
                  cancelled: List[Request]) -> bool:
    """Cancel a not-yet-arrived request parked in an (arrival, seq,
    Request) heap: nothing is in flight to unwind, only the lifecycle
    stamps the core's cancel path would set. Shared by `ServingSession`
    (replica-level heap) and `ClusterSession` (pre-dispatch heap) so the
    two parked-cancel semantics cannot drift. Returns False when `r` is
    not in the heap."""
    for i, (_, _, q) in enumerate(pending):
        if q is r:
            pending.pop(i)
            heapq.heapify(pending)
            r.phase = Phase.CANCELLED
            r.finish_time = now
            cancelled.append(r)
            return True
    return False


class ServingSession:
    """Open-loop serving frontend over one backend."""

    def __init__(self, backend: ServingBackend):
        self.backend = backend
        self.core = backend.core
        self._pending: list = []          # (arrival, seq, Request) heap
        self._seq = itertools.count()
        self.handles: dict = {}           # rid -> RequestHandle

    # ------------------------------------------------------------ submit
    def submit(self, request: Request,
               arrival: Optional[float] = None) -> RequestHandle:
        """Enqueue a request. `arrival=None` stamps it at the current
        clock (online submission); an explicit future arrival is parked
        and fed to the scheduler when the clock reaches it; an explicit
        past arrival enters the queue now but keeps its stamp (its
        queuing delay is measured from the stamped arrival, exactly as
        the old batch loops did)."""
        if request.rid in self.handles:
            raise ValueError(f"duplicate rid {request.rid!r}")
        now = self.backend.clock()
        t = now if arrival is None else arrival
        request.arrival = t
        h = RequestHandle(request, self)
        self.handles[request.rid] = h
        if t <= now:
            self.core.waiting.append(request)
        else:
            heapq.heappush(self._pending, (t, next(self._seq), request))
        return h

    def _feed_arrivals(self) -> None:
        now = self.backend.clock()
        while self._pending and self._pending[0][0] <= now:
            self.core.waiting.append(heapq.heappop(self._pending)[2])

    # -------------------------------------------------------------- step
    def step(self) -> bool:
        """One scheduler iteration, feeding any arrivals the clock has
        reached first. When the backend is idle but future arrivals are
        parked, jumps the clock to the next arrival (the old batch-loop
        semantics). Returns False only when nothing can progress — the
        system is empty, or every waiting request is blocked and nothing
        is in flight (backpressure: a later submit() can unblock it)."""
        self._feed_arrivals()
        if self.backend.step():
            return True
        if self._pending:
            self.backend.advance_to(self._pending[0][0])
            self._feed_arrivals()
            return self.backend.step()
        return False

    @property
    def backlog(self) -> int:
        """Requests accepted but not yet prefilling (queue pressure)."""
        return len(self.core.waiting) + len(self._pending)

    def next_event_time(self) -> Optional[float]:
        """Virtual time of this session's next event, or None when fully
        idle: the backend clock while any work is queued or in flight,
        else the earliest parked arrival. A cluster uses this to advance
        its replicas in lockstep — always stepping the session whose next
        event is earliest on the shared virtual clock."""
        if self.core.waiting or not self.core.idle():
            return self.backend.clock()
        if self._pending:
            return self._pending[0][0]
        return None

    # ------------------------------------------------------------ stream
    def stream(self, handle: RequestHandle) -> Iterator[int]:
        """Per-token iterator for one request: pumps the scheduler until
        the request finishes (or is cancelled), yielding its tokens as
        each iteration produces them. Other in-flight requests advance
        normally while streaming."""
        while True:
            yield from handle.take_new()
            if handle.done:
                return
            if not self.step():
                # graceful degradation first: with shed_overload on, the
                # blocking head is rejected (typed reason) and the pump
                # continues; only a hard-wedged scheduler still raises
                if self.core.shed_blocked(self.backend.clock()):
                    continue
                # names the request that actually blocks admission
                # (under prefix_aware ordering it may not be `handle`)
                raise self.core.wedged_error()

    # ------------------------------------------------------------ cancel
    def cancel(self, handle: RequestHandle) -> bool:
        """Cancel a live request, unwinding everything it has in flight
        (see SchedulerCore.cancel). Pending (not-yet-arrived) requests
        are cancelled from the heap. Idempotent; False when the request
        already finished."""
        r = handle.request
        if cancel_parked(self._pending, r, self.backend.clock(),
                         self.core.cancelled):
            return True
        return self.backend.cancel(r)

    # -------------------------------------------------------------- reap
    def reap(self, handle: RequestHandle) -> Optional[Request]:
        """Release a done (finished or cancelled) request's retained
        state — its handle, and its entry in the backend's done/cancelled
        lists — and return the request, or None if it is not done yet.

        Retention is the session default so `drain()` can return results
        and the simulator can compute metrics over everything it served;
        a LONG-LIVED session must reap handles as it consumes their
        results or per-request state (prompt + generated tokens)
        accumulates for the life of the session."""
        r = handle.request
        if not handle.done:
            return None
        self.handles.pop(r.rid, None)
        if handle.finished:
            if r in self.core.done:
                self.core.done.remove(r)
        elif handle.shed:
            if r in self.core.shed:
                self.core.shed.remove(r)
        elif r in self.core.cancelled:
            self.core.cancelled.remove(r)
        return r

    # ------------------------------------------------------------- drain
    def drain(self) -> List[Request]:
        """Run the system empty and return the finished requests. Raises
        AdmissionImpossible when a waiting request can never be served."""
        while self._pending or self.core.waiting \
                or not self.core.idle():
            if not self.step():
                if self.core.shed_blocked(self.backend.clock()):
                    continue
                raise self.core.wedged_error()
        self.backend.finish()
        return list(self.core.done)

    # ------------------------------------------------------------- export
    def write_trace(self, path: str) -> None:
        """Export this session's event stream as Chrome-trace JSON
        (load at ui.perfetto.dev). Requires `ServeConfig.trace`."""
        if self.core.tracer is None:
            raise ValueError(
                "tracing is off: construct the backend with "
                "ServeConfig(trace=True) to record events")
        from repro_torch.obs.export import write_trace
        write_trace([self.core.tracer], path)
