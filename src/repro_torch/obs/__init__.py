"""Observability layer: counter/gauge registry (always on, pure dict
ops), event tracer with exact TTFT attribution, and Perfetto/Prometheus
exporters.

The registry is imported eagerly (schedulers route their counters
through it); the tracer and exporters are PEP 562 lazy re-exports so a
`trace=False` run never imports them — the zero-overhead-when-off
contract tests/test_obs.py pins by asserting ``repro.obs.trace`` stays
out of ``sys.modules``.
"""
from __future__ import annotations

import importlib

from repro_torch.obs.registry import MetricsRegistry

__all__ = ["MetricsRegistry", "Tracer", "EVENT_TYPES",
           "ATTRIBUTION_CAUSES", "perfetto_trace", "prometheus_text",
           "write_trace"]

_LAZY = {
    "Tracer": "repro_torch.obs.trace",
    "EVENT_TYPES": "repro_torch.obs.trace",
    "ATTRIBUTION_CAUSES": "repro_torch.obs.trace",
    "perfetto_trace": "repro_torch.obs.export",
    "prometheus_text": "repro_torch.obs.export",
    "write_trace": "repro_torch.obs.export",
}


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module 'repro_torch.obs' has no attribute {name!r}")
    return getattr(importlib.import_module(mod), name)
