"""Process-local structured tracer for the SAGIN FL stack.

One :class:`Tracer` instance is shared by every layer of a run
(``SAGINEngine`` → ``RegionTrainer`` → ``CohortEngine`` →
``sim.dynamics``): instrumentation sites emit typed :class:`Span`
records carrying BOTH clocks — the simulated wall clock the engine
advances (``t_sim``/``dur_sim``, seconds) and the host's monotonic
clock (``t_wall``/``dur_wall``, ``time.perf_counter`` seconds relative
to tracer construction).  Spans buffer in memory and export as

* JSONL — one ``Span.to_dict()`` object per line (the on-disk trace
  schema, version ``repro-trace/1``), reloadable with
  :func:`load_jsonl`; and
* Chrome-trace / Perfetto JSON — ``{"traceEvents": [...]}`` with one
  thread track per region on the simulated-clock axis, so a
  multi-region run renders as a per-region timeline in
  https://ui.perfetto.dev (load the ``*.perfetto.json`` sibling that
  :meth:`Tracer.flush` writes next to the JSONL).

Span kinds are CLOSED (:data:`SPAN_KINDS`): ``round`` (one FL round),
``offload`` (the round's data-placement transfer), ``handover``
(one satellite-to-satellite switch inside a round), ``merge`` (one
cross-region federation merge, on the synthetic ``federation`` track),
``bucket_dispatch`` (one compiled cohort-bucket dispatch; wall-clock
duration only — fence with ``ObsConfig.device_timing`` for true device
time), ``outage`` (a realized dynamics event: ISL fade, uplink
dead-air, device churn), ``fault`` / ``recovery`` (one injected fault
and its graceful-degradation response, from the fault injector),
``resume`` (an engine checkpoint restore), ``request`` (one served
inference request, end-to-end, from the serving gateway), and ``serve_batch`` (one batched
inference dispatch at a serving node, geometric-padded).

Determinism contract: the tracer only OBSERVES.  It never draws from
any RNG, never touches model parameters, and (``device_timing`` aside,
which merely forces synchronization) never changes what the
instrumented code computes — trajectories are bit-identical with
tracing on or off at equal seeds (test-locked).

The disabled path is a null object: ``resolve_obs(None)`` returns the
shared :data:`NULL_TRACER` whose ``enabled`` flag is ``False``; hot
instrumentation sites guard on ``tracer.enabled`` so a disabled run
pays one attribute load + branch per site.

The span vocabulary and trace schema are the JAX package's own, so one
report tool reads the traces of both packages.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Dict, Iterable, List, Optional

from .metrics import NULL_METRICS, Metrics

TRACE_SCHEMA = "repro-trace/1"

SPAN_KINDS = ("round", "offload", "handover", "merge", "bucket_dispatch",
              "outage", "fault", "recovery", "resume", "request",
              "serve_batch")

#: Perfetto display category per span kind.  EVERY kind must have an
#: entry — :func:`to_perfetto` indexes this mapping directly, so a kind
#: added to :data:`SPAN_KINDS` without one fails loudly on export (the
#: vocabulary-sync test in ``tests/test_obs.py`` locks the two, plus
#: the report renderer's kinds, together).
PERFETTO_KINDS = {
    "round": "training",
    "offload": "training",
    "handover": "network",
    "merge": "federation",
    "bucket_dispatch": "compute",
    "outage": "network",
    "fault": "resilience",
    "recovery": "resilience",
    "resume": "resilience",
    "request": "serving",
    "serve_batch": "serving",
}

#: Synthetic region name for cross-region events (merges) that belong to
#: no single region's timeline.
FEDERATION_TRACK = "federation"


@dataclasses.dataclass(frozen=True)
class ObsConfig:
    """Observability wiring for one run (``FLConfig.obs``/``Scenario.obs``).

    ``path`` is the JSONL trace destination (``None`` keeps spans
    in memory only — still inspectable via ``tracer.spans`` and
    exportable by hand).  ``device_timing`` fences every cohort bucket
    dispatch with ``torch.cuda.synchronize`` so ``bucket_dispatch``
    spans carry true device time instead of async-dispatch time; it
    changes performance, never results.  ``perfetto`` also writes a
    Chrome-trace sibling (``trace.jsonl`` → ``trace.perfetto.json``)
    on flush.
    """
    path: Optional[str] = None
    enabled: bool = True
    device_timing: bool = False
    perfetto: bool = True


@dataclasses.dataclass
class Span:
    """One typed trace record (an instant event when both durations are 0).

    ``t_sim``/``dur_sim`` are simulated seconds (the engine's wall
    clock); ``t_wall``/``dur_wall`` are host monotonic seconds relative
    to the tracer's construction.  ``round`` is the FL round index the
    span belongs to (-1 when not round-scoped) and ``attrs`` carries
    kind-specific payload (JSON-serializable scalars/lists only).
    """
    kind: str
    name: str
    region: str = ""
    round: int = -1
    t_sim: float = 0.0
    dur_sim: float = 0.0
    t_wall: float = 0.0
    dur_wall: float = 0.0
    attrs: Dict[str, object] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["schema"] = TRACE_SCHEMA
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Span":
        return cls(kind=d["kind"], name=d["name"],
                   region=d.get("region", ""), round=int(d.get("round", -1)),
                   t_sim=float(d.get("t_sim", 0.0)),
                   dur_sim=float(d.get("dur_sim", 0.0)),
                   t_wall=float(d.get("t_wall", 0.0)),
                   dur_wall=float(d.get("dur_wall", 0.0)),
                   attrs=dict(d.get("attrs", {})))


class Tracer:
    """Buffered span emitter + metrics registry for one run.

    The tracer carries a mutable *context* (current region / round /
    simulated time) that the outermost instrumentation site
    (``RegionTrainer.step``) sets once per round, so inner layers
    (``sim.dynamics``, ``CohortEngine``) can emit spans without
    plumbing region identity through every call signature.  The stack
    is single-threaded per run; no locking.
    """

    def __init__(self, config: Optional[ObsConfig] = None):
        cfg = config if config is not None else ObsConfig()
        self.config = cfg
        self.enabled = bool(cfg.enabled)
        self.device_timing = self.enabled and bool(cfg.device_timing)
        self.spans: List[Span] = []
        self.metrics: Metrics = Metrics() if self.enabled else NULL_METRICS
        self._epoch = time.perf_counter()
        # emission context (set by the round driver, read by inner layers)
        self.ctx_region = ""
        self.ctx_round = -1
        self.ctx_t_sim = 0.0

    # -- clocks / context ---------------------------------------------------
    def wall_now(self) -> float:
        """Host monotonic seconds since tracer construction."""
        return time.perf_counter() - self._epoch

    def set_context(self, region: Optional[str] = None,
                    round: Optional[int] = None,
                    t_sim: Optional[float] = None) -> None:
        if not self.enabled:
            return
        if region is not None:
            self.ctx_region = region
        if round is not None:
            self.ctx_round = round
        if t_sim is not None:
            self.ctx_t_sim = t_sim

    # -- emission -----------------------------------------------------------
    def span(self, kind: str, name: str, *,
             region: Optional[str] = None, round: Optional[int] = None,
             t_sim: Optional[float] = None, dur_sim: float = 0.0,
             t_wall: Optional[float] = None, dur_wall: float = 0.0,
             **attrs) -> Optional[Span]:
        """Record one span; unset fields fall back to the context.

        Returns the span (or ``None`` when disabled).  ``kind`` must be
        one of :data:`SPAN_KINDS` — the closed vocabulary is what makes
        the report CLI's aggregation semantics possible.
        """
        if not self.enabled:
            return None
        if kind not in SPAN_KINDS:
            raise ValueError(f"unknown span kind {kind!r}; "
                             f"expected one of {SPAN_KINDS}")
        s = Span(kind=kind, name=name,
                 region=self.ctx_region if region is None else region,
                 round=self.ctx_round if round is None else round,
                 t_sim=self.ctx_t_sim if t_sim is None else t_sim,
                 dur_sim=dur_sim,
                 t_wall=self.wall_now() if t_wall is None else t_wall,
                 dur_wall=dur_wall, attrs=attrs)
        self.spans.append(s)
        return s

    def event(self, kind: str, name: str, **kw) -> Optional[Span]:
        """Zero-duration span (an instant on the timeline)."""
        return self.span(kind, name, **kw)

    # -- export -------------------------------------------------------------
    def flush(self, path: Optional[str] = None) -> Optional[str]:
        """Write the buffered spans to ``path`` (default: the config's).

        Idempotent full rewrite — calling again after more spans simply
        rewrites the complete trace.  Writes the Perfetto sibling when
        ``config.perfetto``.  Returns the JSONL path written, or
        ``None`` when disabled / no destination configured.
        """
        if not self.enabled:
            return None
        dest = path if path is not None else self.config.path
        if not dest:
            return None
        write_jsonl(dest, self.spans)
        if self.config.perfetto:
            write_perfetto(perfetto_path(dest), self.spans)
        return dest


#: Shared disabled tracer: every recording method early-returns, metrics
#: are the shared null registry.  ``resolve_obs(None)`` hands this out.
NULL_TRACER = Tracer(ObsConfig(enabled=False))


def resolve_obs(obs) -> Tracer:
    """Coerce an ``FLConfig.obs``/``Scenario.obs`` value to a tracer.

    ``None`` → the shared disabled :data:`NULL_TRACER`; a bare string →
    an enabled tracer writing JSONL (+ Perfetto sibling) to that path;
    an :class:`ObsConfig` → a tracer so configured; an existing
    :class:`Tracer` passes through (the engine shares one across its
    region trainers this way).
    """
    if obs is None:
        return NULL_TRACER
    if isinstance(obs, Tracer):
        return obs
    if isinstance(obs, str):
        obs = ObsConfig(path=obs)
    if isinstance(obs, ObsConfig):
        return Tracer(obs) if obs.enabled else NULL_TRACER
    raise TypeError(f"obs must be None, a path string, ObsConfig, or "
                    f"Tracer, got {type(obs).__name__}")


# -- serialization -----------------------------------------------------------
def write_jsonl(path: str, spans: Iterable[Span]) -> None:
    with open(path, "w", encoding="utf-8") as fh:
        for s in spans:
            fh.write(json.dumps(s.to_dict(), sort_keys=True) + "\n")


def load_jsonl(path: str) -> List[Span]:
    """Reload a JSONL trace written by :func:`write_jsonl`/``flush``."""
    out = []
    with open(path, "r", encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if line:
                out.append(Span.from_dict(json.loads(line)))
    return out


def perfetto_path(jsonl_path: str) -> str:
    """``trace.jsonl`` → ``trace.perfetto.json`` (suffix-aware)."""
    if jsonl_path.endswith(".jsonl"):
        return jsonl_path[:-len(".jsonl")] + ".perfetto.json"
    return jsonl_path + ".perfetto.json"


def to_perfetto(spans: Iterable[Span]) -> dict:
    """Chrome-trace / Perfetto JSON: one thread track per region.

    The timeline axis is the SIMULATED clock (µs since run start);
    wall-clock measurements ride along in each event's ``args``.
    Zero-duration spans become instant events (``ph: "i"``) on their
    region's track.
    """
    spans = list(spans)
    regions = sorted({s.region or "global" for s in spans})
    tid = {r: i + 1 for i, r in enumerate(regions)}
    events: List[dict] = [
        {"ph": "M", "pid": 1, "name": "process_name",
         "args": {"name": "repro-sagin"}},
    ]
    for r, t in tid.items():
        events.append({"ph": "M", "pid": 1, "tid": t, "name": "thread_name",
                       "args": {"name": r}})
    for s in spans:
        args = dict(s.attrs)
        args["round"] = s.round
        args["t_wall_s"] = round(s.t_wall, 6)
        if s.dur_wall:
            args["dur_wall_s"] = round(s.dur_wall, 6)
        # cat is a comma-separated category list (Chrome-trace format):
        # the span kind plus its display group — the mapping lookup is
        # deliberately unguarded so an unmapped kind fails loudly here
        base = {"name": s.name,
                "cat": f"{s.kind},{PERFETTO_KINDS[s.kind]}", "pid": 1,
                "tid": tid[s.region or "global"],
                "ts": s.t_sim * 1e6, "args": args}
        if s.dur_sim > 0.0:
            events.append({**base, "ph": "X", "dur": s.dur_sim * 1e6})
        else:
            events.append({**base, "ph": "i", "s": "t"})
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"schema": TRACE_SCHEMA}}


def write_perfetto(path: str, spans: Iterable[Span]) -> None:
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(to_perfetto(spans), fh)
