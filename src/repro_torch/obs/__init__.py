"""``repro_torch.obs`` — tracing + metrics for the port's FL stack.

A copy of the reference's tracer and metrics registry: enable by handing
a run an :class:`ObsConfig` (or a bare output-path string) through
``FLConfig.obs``.  The trace schema is the reference's, so the
reference's report CLI reads the port's traces.  Disabled (the default)
costs one branch per instrumentation site, and the tracer never perturbs
RNG streams or results either way.
"""
from .metrics import (Counter, Gauge, Histogram, Metrics,  # noqa: F401
                      NULL_METRICS)
from .tracer import (FEDERATION_TRACK, NULL_TRACER, ObsConfig,  # noqa: F401
                     PERFETTO_KINDS, SPAN_KINDS, Span, TRACE_SCHEMA, Tracer,
                     load_jsonl, perfetto_path, resolve_obs, to_perfetto,
                     write_jsonl, write_perfetto)

__all__ = [
    "Counter", "Gauge", "Histogram", "Metrics", "NULL_METRICS",
    "FEDERATION_TRACK", "NULL_TRACER", "ObsConfig", "PERFETTO_KINDS",
    "SPAN_KINDS", "Span", "TRACE_SCHEMA", "Tracer", "load_jsonl",
    "perfetto_path", "resolve_obs", "to_perfetto", "write_jsonl",
    "write_perfetto",
]
