"""Trace/metric exporters: Chrome-trace (Perfetto-loadable) JSON and a
Prometheus-style text snapshot.

Chrome trace mapping (load the file at https://ui.perfetto.dev or
chrome://tracing):

  * one PROCESS (pid) per tracer — replica 0..N-1, plus the cluster
    stream when a `ClusterSession` traces fleet events. Streams from
    different replicas merge naturally because every timestamp is the
    SHARED virtual clock (microseconds in the file);
  * within a process, tid 0 is the scheduler track (sched_pass decision
    records and fleet instants) and each request gets its own tid in
    first-seen order — its queued/prefill/decode/paused spans nest on
    one line;
  * spans export as complete events (ph "X", ts+dur), everything else
    as instants (ph "i"); process/thread names ride metadata (ph "M").

Events are sorted by (ts, -dur) so enclosing spans precede their
children and per-track timestamps are monotone (tests/test_obs.py
validates both on the exported file).
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

_US = 1e6  # seconds (virtual clock) -> Chrome trace microseconds


def _track_events(tracer, pid: int, label: str) -> List[dict]:
    out: List[dict] = [
        {"ph": "M", "pid": pid, "tid": 0, "name": "process_name",
         "args": {"name": label}},
        {"ph": "M", "pid": pid, "tid": 0, "name": "thread_name",
         "args": {"name": "scheduler"}},
    ]
    tids: Dict[str, int] = {}

    def tid_of(rid: Optional[str]) -> int:
        if rid is None:
            return 0
        if rid not in tids:
            tids[rid] = len(tids) + 1
            out.append({"ph": "M", "pid": pid, "tid": tids[rid],
                        "name": "thread_name", "args": {"name": rid}})
        return tids[rid]

    for ev in tracer.events:
        args = dict(ev.get("args") or {})
        if "wall" in ev:
            args["wall_s"] = ev["wall"]
        row: dict = {"name": ev["type"], "cat": "serving",
                     "pid": pid, "tid": tid_of(ev.get("rid")),
                     "args": args}
        if "t0" in ev:
            row["ph"] = "X"
            row["ts"] = ev["t0"] * _US
            row["dur"] = max(ev["t1"] - ev["t0"], 0.0) * _US
        else:
            row["ph"] = "i"
            row["ts"] = ev["t"] * _US
            row["s"] = "t" if ev.get("rid") is not None else "p"
        out.append(row)
    return out


def perfetto_trace(tracers: Sequence, labels: Optional[Sequence[str]]
                   = None) -> dict:
    """Merge one or more tracers into a Chrome-trace JSON object.
    `labels` names each process (default ``replica i``)."""
    events: List[dict] = []
    for i, tracer in enumerate(tracers):
        if tracer is None:
            continue
        label = labels[i] if labels is not None else f"replica {i}"
        events.extend(_track_events(tracer, pid=i, label=label))
    meta = [e for e in events if e["ph"] == "M"]
    rest = sorted((e for e in events if e["ph"] != "M"),
                  key=lambda e: (e["ts"], -e.get("dur", 0.0)))
    return {"traceEvents": meta + rest, "displayTimeUnit": "ms"}


def write_trace(tracers: Sequence, path: str,
                labels: Optional[Sequence[str]] = None) -> None:
    with open(path, "w") as f:
        json.dump(perfetto_trace(tracers, labels), f)


def prometheus_text(snapshot: Dict[str, float]) -> str:
    """Prometheus exposition format over a rendered registry snapshot
    (`MetricsRegistry.snapshot()` keys are already
    ``name{label="v"}``-shaped)."""
    lines = [f"{key} {value:g}" for key, value in sorted(snapshot.items())]
    return "\n".join(lines) + ("\n" if lines else "")
