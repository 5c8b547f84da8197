"""``repro_torch.obs`` — tracing + metrics for the port's FL stack.

A copy of the reference's tracer, metrics registry and trace report:
enable by handing a run an :class:`ObsConfig` (or a bare output-path
string) through ``FLConfig.obs``, then ``python -m repro_torch.obs
report trace.jsonl`` for round tables, latency breakdown, resilience,
serving and anomalies (``perfetto`` converts the trace for
https://ui.perfetto.dev).  The trace schema is the reference's, so
either package's report reads either package's traces.  Disabled (the
default) costs one branch per instrumentation site, and the tracer never
perturbs RNG streams or results either way.
"""
from .metrics import (Counter, Gauge, Histogram, Metrics,  # noqa: F401
                      NULL_METRICS)
from .report import (HANDLED_KINDS, ServingReport, TraceReport,  # noqa: F401
                     analyze, render)
from .tracer import (FEDERATION_TRACK, NULL_TRACER, ObsConfig,  # noqa: F401
                     PERFETTO_KINDS, SPAN_KINDS, Span, TRACE_SCHEMA, Tracer,
                     load_jsonl, perfetto_path, resolve_obs, to_perfetto,
                     write_jsonl, write_perfetto)

__all__ = [
    "Counter", "Gauge", "Histogram", "Metrics", "NULL_METRICS",
    "HANDLED_KINDS", "ServingReport", "TraceReport", "analyze", "render",
    "FEDERATION_TRACK", "NULL_TRACER", "ObsConfig", "PERFETTO_KINDS",
    "SPAN_KINDS", "Span", "TRACE_SCHEMA", "Tracer", "load_jsonl",
    "perfetto_path", "resolve_obs", "to_perfetto", "write_jsonl",
    "write_perfetto",
]
