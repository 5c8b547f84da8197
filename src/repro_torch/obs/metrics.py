"""Counters / gauges / histograms for the observability layer.

A :class:`Metrics` registry rides on every enabled
:class:`~repro_torch.obs.tracer.Tracer` (``tracer.metrics``); instruments are
get-or-create by name, so instrumentation sites never need to
pre-declare them:

    tracer.metrics.counter("quarantine.updates").inc(n_dropped)
    tracer.metrics.gauge(f"federation.isl_scale.{region}").set(scale)
    tracer.metrics.histogram("serve.batch_real").observe(n_real)

Determinism contract (same as the tracer's): instruments are pure
accumulators — no RNG, no sampling.  The histogram keeps exact
count/sum/min/max plus a bounded window of the most recent
observations for percentile estimates, so memory stays O(1) per
instrument without reservoir sampling (which would need an RNG).

The disabled path is the shared :data:`NULL_METRICS` registry: every
lookup returns one shared no-op instrument.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional


class Counter:
    """Monotonic accumulator (quarantined updates, resumes, requests)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        self.value += v


class Gauge:
    """Last-write-wins sample (realized ISL scale, queue depth)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Exact summary stats + bounded recent window for percentiles.

    ``window`` bounds memory; p50/p95 are computed over the most recent
    observations only (deterministic, unlike reservoir sampling), while
    count/sum/min/max/mean are exact over the full stream.
    """

    __slots__ = ("count", "total", "vmin", "vmax", "_recent")

    def __init__(self, window: int = 256):
        self.count = 0
        self.total = 0.0
        self.vmin = float("inf")
        self.vmax = float("-inf")
        self._recent: deque = deque(maxlen=window)

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v
        self._recent.append(v)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        """q in [0, 100], over the recent window (0.0 when empty)."""
        if not self._recent:
            return 0.0
        vals = sorted(self._recent)
        idx = min(len(vals) - 1, int(round(q / 100.0 * (len(vals) - 1))))
        return vals[idx]

    def summary(self) -> dict:
        if not self.count:
            return {"count": 0}
        return {"count": self.count, "sum": self.total, "mean": self.mean,
                "min": self.vmin, "max": self.vmax,
                "p50": self.percentile(50), "p95": self.percentile(95)}


class Metrics:
    """Name → instrument registry (get-or-create on access)."""

    def __init__(self):
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter()
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge()
        return g

    def histogram(self, name: str, window: int = 256) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            h = self._histograms[name] = Histogram(window=window)
        return h

    def names(self) -> List[str]:
        return sorted(set(self._counters) | set(self._gauges)
                      | set(self._histograms))

    def snapshot(self, prefix: Optional[str] = None) -> dict:
        """Flat JSON-serializable view: counters/gauges as scalars,
        histograms as summary dicts.  ``prefix`` filters by name prefix
        (e.g. ``"cohort."`` for the bench-row attachment)."""
        out: dict = {}
        for name, c in self._counters.items():
            out[name] = c.value
        for name, g in self._gauges.items():
            out[name] = g.value
        for name, h in self._histograms.items():
            out[name] = h.summary()
        if prefix is not None:
            out = {k: v for k, v in out.items() if k.startswith(prefix)}
        return out


class _NullInstrument:
    """Shared no-op stand-in for every instrument type."""

    __slots__ = ()
    value = 0.0

    def inc(self, v: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass


_NULL_INSTRUMENT = _NullInstrument()


class _NullMetrics(Metrics):
    """Registry handed out by the disabled tracer: never accumulates."""

    def __init__(self):
        super().__init__()

    def counter(self, name: str):  # type: ignore[override]
        return _NULL_INSTRUMENT

    def gauge(self, name: str):  # type: ignore[override]
        return _NULL_INSTRUMENT

    def histogram(self, name: str, window: int = 256):  # type: ignore[override]
        return _NULL_INSTRUMENT

    def snapshot(self, prefix: Optional[str] = None) -> dict:
        return {}


NULL_METRICS = _NullMetrics()
