"""Unified counter/gauge registry — the always-on half of the
observability layer.

This module is deliberately tiny and dependency-free (pure dict
operations, no tracing imports): `SchedulerCore`, `PagedExecutor` and
`ClusterSession` create one eagerly and route their previously-scattered
counters (`jit_retraces`, preemption/resume counts, shed/retry/
re-dispatch/kill tallies) through it, so one `snapshot()` returns
everything and the Prometheus exporter has a single source of truth.
The event-tracing half (`repro.obs.trace`) is imported ONLY when
`ServeConfig.trace` is on — keeping it out of this module is what makes
trace-off runs zero-overhead (tests/test_obs.py asserts the module is
never even imported).

Label values render Prometheus-style: ``name{label="value"}``.
"""
from __future__ import annotations

import collections
from typing import Dict, Tuple

LabelKey = Tuple[Tuple[str, str], ...]


def _labels_key(labels: Dict[str, str]) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def render_key(name: str, labels: LabelKey) -> str:
    """``name{a="x",b="y"}`` (bare ``name`` when unlabelled)."""
    if not labels:
        return name
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return f"{name}{{{inner}}}"


class MetricsRegistry:
    """Labelled counters and gauges behind one namespace.

    Counters (`inc`) are monotone; gauges (`set_gauge`) are
    last-write-wins. Both share the storage — the distinction only
    matters to the writer. Reads never create entries, so probing a
    counter that never fired costs nothing and returns 0.
    """

    def __init__(self) -> None:
        self._data: Dict[str, Dict[LabelKey, float]] = {}

    # ------------------------------------------------------------ writes
    def inc(self, name: str, amount: float = 1.0, **labels: str) -> None:
        series = self._data.setdefault(name, {})
        key = _labels_key(labels)
        series[key] = series.get(key, 0.0) + amount

    def set_gauge(self, name: str, value: float, **labels: str) -> None:
        self._data.setdefault(name, {})[_labels_key(labels)] = value

    # ------------------------------------------------------------- reads
    def get(self, name: str, **labels: str) -> float:
        """Value of one (name, labels) series; 0.0 when it never fired."""
        return self._data.get(name, {}).get(_labels_key(labels), 0.0)

    def total(self, name: str) -> float:
        """Sum over every label combination of `name`."""
        return sum(self._data.get(name, {}).values())

    def counter_view(self, name: str, label: str) -> collections.Counter:
        """The series of `name` sliced by one label, as a Counter —
        back-compat shape for code that used a bare
        ``collections.Counter`` (e.g. ``PagedExecutor.jit_retraces``)."""
        out: collections.Counter = collections.Counter()
        for key, v in self._data.get(name, {}).items():
            for k, val in key:
                if k == label:
                    out[val] += int(v)
        return out

    def snapshot(self, **extra_labels: str) -> Dict[str, float]:
        """Flat ``rendered_key -> value`` dict of every series.
        `extra_labels` are folded into every key (a cluster stamps
        ``replica="i"`` when merging per-replica registries)."""
        out: Dict[str, float] = {}
        for name, series in sorted(self._data.items()):
            for key, v in sorted(series.items()):
                merged = dict(key)
                merged.update({k: str(v2) for k, v2
                               in extra_labels.items()})
                out[render_key(name, _labels_key(merged))] = v
        return out

    @staticmethod
    def merge_snapshots(*snaps: Dict[str, float]) -> Dict[str, float]:
        """Combine rendered snapshots; identical keys sum (counters from
        different replicas pool, which is the cluster semantics)."""
        out: Dict[str, float] = {}
        for snap in snaps:
            for k, v in snap.items():
                out[k] = out.get(k, 0.0) + v
        return out
