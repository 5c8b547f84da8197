"""Trace analysis: per-region tables, latency breakdown, anomalies.

Consumes a JSONL trace written by :meth:`repro_torch.obs.Tracer.flush`
(or the JAX package's tracer: the schema is shared) and
renders what the paper's latency story needs to be debuggable:

* a per-region round table (rounds, simulated end time, round-latency
  stats, handover/outage counts, final accuracy);
* a latency breakdown — where each region's simulated time went:
  **compute** (round latency minus in-round stalls), **uplink**
  (dead-air outage delays), **ISL** (handover switches + merge tolls),
  and **idle** (barrier parking / event-loop gaps to the run's end);
* top-k anomalies: straggler rounds (≥ :data:`STRAGGLER_FACTOR` × the
  region's median), repeated-handover rounds (≥2 switches), and
  quorum-miss or skipped merges;
* a sharded-dispatch breakdown when the trace holds
  ``bucket_dispatch`` spans from a mesh-sharded cohort engine
  (the JAX package's; ``mesh_shape`` and
  per-shard ``shard_real`` attrs): each span's host ``dur_wall`` is
  apportioned across shards by their share of the bucket's real
  (unmasked) batch elements, giving per-shard dispatch time, work
  share, and the aggregate imbalance (max over mean share);
* a serving section when the trace holds ``request``/``serve_batch``
  spans from a :class:`~repro_torch.serve.gateway.ServeGateway`: sustained
  QPS over the served window, end-to-end latency p50/p99, queueing
  share, served accuracy, batch fill, and the per-target-kind split
  (own satellite / ISL neighbour / ground fallback).

:data:`HANDLED_KINDS` is this module's copy of the closed span
vocabulary — every kind ``analyze``/``render`` knows how to aggregate.
The vocabulary-sync test locks it against ``tracer.SPAN_KINDS`` and
``tracer.PERFETTO_KINDS`` so a kind added in only one place fails CI.

Everything here is pure span arithmetic — no tensors, no simulator
imports — so the CLI (``python -m repro_torch.obs report``) stays fast
and usable on traces copied off another machine.  The module is the
JAX package's report, copied: both print the same text for a trace.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

from .tracer import FEDERATION_TRACK, Span

STRAGGLER_FACTOR = 1.5

#: Every span kind this report knows how to aggregate/render — must
#: stay in lockstep with ``tracer.SPAN_KINDS`` (test-locked).
HANDLED_KINDS = frozenset({
    "round", "offload", "handover", "merge", "bucket_dispatch", "outage",
    "fault", "recovery", "resume", "request", "serve_batch", "phase",
})

#: Serving-plane kinds: reported in their own section, excluded from the
#: per-region TRAINING tables (round stats, latency breakdown, idle).
SERVING_KINDS = frozenset({"request", "serve_batch"})


@dataclasses.dataclass
class Anomaly:
    kind: str        # "straggler" | "repeated_handover" | "quorum_miss"
    severity: float  # sort key, larger = worse
    message: str


@dataclasses.dataclass
class RegionReport:
    region: str
    rounds: int = 0
    end_sim: float = 0.0           # last activity on this region's track
    mean_round: float = 0.0
    max_round: float = 0.0
    handovers: int = 0
    outages: int = 0
    final_acc: Optional[float] = None
    # latency breakdown (simulated seconds)
    compute: float = 0.0
    uplink: float = 0.0
    isl: float = 0.0
    idle: float = 0.0


@dataclasses.dataclass
class ShardRow:
    shard: int
    real_elements: int = 0       # unmasked batch elements this shard ran
    wall_s: float = 0.0          # dispatch dur_wall apportioned by share


@dataclasses.dataclass
class ShardDispatchReport:
    mesh_shape: List[int]
    dispatches: int              # sharded bucket_dispatch spans seen
    wall_s: float                # total sharded dispatch wall time
    shards: List[ShardRow]
    imbalance: float = 1.0       # max shard share / mean shard share


@dataclasses.dataclass
class ServingReport:
    """Aggregated serving-plane spans (``request``/``serve_batch``)."""
    requests: int = 0
    batches: int = 0
    qps: float = 0.0               # requests / served simulated window
    latency_p50: float = 0.0       # end-to-end simulated seconds
    latency_p99: float = 0.0
    latency_mean: float = 0.0
    wait_mean: float = 0.0         # queueing share
    served_accuracy: Optional[float] = None
    mean_batch: float = 0.0        # real elements per dispatch
    fill: float = 1.0              # real / padded elements
    by_region: Dict[str, int] = dataclasses.field(default_factory=dict)
    by_target: Dict[str, int] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class TraceReport:
    regions: List[RegionReport]
    merges: int
    anomalies: List[Anomaly]
    n_spans: int
    kinds: Dict[str, int]
    shard_dispatch: Optional[ShardDispatchReport] = None
    # resilience (repro_torch.resilience): injected/recovered fault counts by
    # kind, quarantined client updates, and engine checkpoint resumes
    faults: Dict[str, int] = dataclasses.field(default_factory=dict)
    recoveries: Dict[str, int] = dataclasses.field(default_factory=dict)
    quarantined: int = 0
    resumes: int = 0
    # serving (repro_torch.serve): present when the trace holds serving spans
    serving: Optional[ServingReport] = None


def _median(vals: Sequence[float]) -> float:
    if not vals:
        return 0.0
    s = sorted(vals)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])


def _shard_dispatch(spans: Sequence[Span]) -> Optional[ShardDispatchReport]:
    """Fold sharded ``bucket_dispatch`` spans into per-shard totals.

    A span is sharded when it carries a ``shard_real`` list (emitted
    only by engines with >1 shard).  Each span's ``dur_wall`` is split
    across shards proportionally to the shard's real-element share of
    that bucket — shard_map runs all shards in lockstep, so this is
    the *useful* time attribution, not a measured per-shard clock.
    """
    sharded = [s for s in spans
               if s.kind == "bucket_dispatch" and s.attrs.get("shard_real")]
    if not sharded:
        return None
    n = max(len(s.attrs["shard_real"]) for s in sharded)
    rows = [ShardRow(shard=i) for i in range(n)]
    wall = 0.0
    mesh_shape = [n]
    for s in sharded:
        per = [float(v) for v in s.attrs["shard_real"]]
        tot = sum(per) or 1.0
        ms = s.attrs.get("mesh_shape")
        if isinstance(ms, list) and ms:
            mesh_shape = [int(v) for v in ms]
        wall += s.dur_wall
        for i, v in enumerate(per):
            rows[i].real_elements += int(v)
            rows[i].wall_s += s.dur_wall * v / tot
    total_real = sum(r.real_elements for r in rows)
    imb = (max(r.real_elements for r in rows) * n / total_real
           if total_real else 1.0)
    return ShardDispatchReport(mesh_shape=mesh_shape,
                               dispatches=len(sharded), wall_s=wall,
                               shards=rows, imbalance=imb)


def _percentile(vals: Sequence[float], q: float) -> float:
    if not vals:
        return 0.0
    s = sorted(vals)
    idx = min(len(s) - 1, int(round(q / 100.0 * (len(s) - 1))))
    return s[idx]


def _serving(spans: Sequence[Span]) -> Optional[ServingReport]:
    """Fold ``request``/``serve_batch`` spans into the serving section."""
    reqs = [s for s in spans if s.kind == "request"]
    batches = [s for s in spans if s.kind == "serve_batch"]
    if not reqs and not batches:
        return None
    sr = ServingReport(requests=len(reqs), batches=len(batches))
    if reqs:
        lats = [s.dur_sim for s in reqs]
        sr.latency_p50 = _percentile(lats, 50)
        sr.latency_p99 = _percentile(lats, 99)
        sr.latency_mean = sum(lats) / len(lats)
        sr.wait_mean = sum(float(s.attrs.get("wait_s", 0.0))
                           for s in reqs) / len(reqs)
        t_lo = min(s.t_sim for s in reqs)
        t_hi = max(s.t_sim + s.dur_sim for s in reqs)
        if t_hi > t_lo:
            sr.qps = len(reqs) / (t_hi - t_lo)
        flags = [s.attrs["correct"] for s in reqs
                 if s.attrs.get("correct") is not None]
        if flags:
            sr.served_accuracy = sum(bool(f) for f in flags) / len(flags)
        for s in reqs:
            sr.by_region[s.region] = sr.by_region.get(s.region, 0) + 1
            route = str(s.attrs.get("route", "?"))
            sr.by_target[route] = sr.by_target.get(route, 0) + 1
    if batches:
        real = sum(int(s.attrs.get("n_real", 0)) for s in batches)
        padded = sum(int(s.attrs.get("n_pad", 0)) for s in batches)
        sr.mean_batch = real / len(batches)
        sr.fill = real / padded if padded else 1.0
    return sr


def analyze(spans: Sequence[Span], top: int = 5) -> TraceReport:
    """Aggregate a span list into the report structure (pure function)."""
    kinds: Dict[str, int] = {}
    for s in spans:
        kinds[s.kind] = kinds.get(s.kind, 0) + 1

    by_region: Dict[str, List[Span]] = {}
    merges = [s for s in spans if s.kind == "merge"]
    for s in spans:
        # serving spans get their own section; the per-region tables
        # (rounds, latency breakdown, idle) describe TRAINING time
        if (s.region and s.region != FEDERATION_TRACK
                and s.kind not in SERVING_KINDS):
            by_region.setdefault(s.region, []).append(s)

    anomalies: List[Anomaly] = []
    regions: List[RegionReport] = []
    run_end = max((s.t_sim + s.dur_sim for s in spans
                   if s.kind not in SERVING_KINDS), default=0.0)

    for name in sorted(by_region):
        rs = by_region[name]
        rounds = sorted((s for s in rs if s.kind == "round"),
                        key=lambda s: s.round)
        hand = [s for s in rs if s.kind == "handover"]
        outs = [s for s in rs if s.kind == "outage"]
        durs = [s.dur_sim for s in rounds]
        rep = RegionReport(region=name, rounds=len(rounds),
                           handovers=len(hand), outages=len(outs))
        rep.end_sim = max((s.t_sim + s.dur_sim for s in rs), default=0.0)
        if durs:
            rep.mean_round = sum(durs) / len(durs)
            rep.max_round = max(durs)
        accs = [s.attrs.get("acc") for s in rounds
                if s.attrs.get("acc") is not None]
        rep.final_acc = accs[-1] if accs else None

        # breakdown: in-round stalls are priced by their own spans;
        # whatever round time they don't explain is compute.  Merge
        # tolls addressed to this region (per-recipient isl_costs in the
        # merge span attrs) are ISL time spent outside any round.
        uplink = sum(float(s.attrs.get("delay", 0.0)) for s in outs
                     if s.attrs.get("event") == "uplink")
        isl_in_round = sum(s.dur_sim for s in hand)
        merge_toll = 0.0
        for m in merges:
            names = m.attrs.get("recipient_names") or []
            costs = m.attrs.get("isl_costs") or []
            merge_toll += sum(c for rn, c in zip(names, costs)
                              if rn == name)
        busy = sum(durs)
        rep.uplink = uplink
        rep.isl = isl_in_round + merge_toll
        rep.compute = max(0.0, busy - uplink - isl_in_round)
        rep.idle = max(0.0, run_end - busy - merge_toll)
        regions.append(rep)

        med = _median(durs)
        if med > 0:
            for s in rounds:
                ratio = s.dur_sim / med
                if ratio >= STRAGGLER_FACTOR:
                    anomalies.append(Anomaly(
                        "straggler", ratio,
                        f"{name} round {s.round}: {s.dur_sim:.1f}s "
                        f"({ratio:.1f}x region median {med:.1f}s)"))
        for s in rounds:
            nh = int(s.attrs.get("n_handovers", 0))
            if nh >= 2:
                anomalies.append(Anomaly(
                    "repeated_handover", nh,
                    f"{name} round {s.round}: {nh} satellite handovers "
                    f"in one round"))

    for m in merges:
        if m.attrs.get("skipped"):
            anomalies.append(Anomaly(
                "quorum_miss", float("inf"),
                f"merge at boundary r{m.round} SKIPPED "
                f"({m.attrs.get('policy', '?')}: no plan)"))
        elif m.attrs.get("quorum_miss"):
            parts = m.attrs.get("participants") or []
            anomalies.append(Anomaly(
                "quorum_miss", float(len(parts)),
                f"merge at boundary r{m.round} with partial quorum: "
                f"{len(parts)} participant(s) {list(parts)}"))

    anomalies.sort(key=lambda a: -a.severity)

    faults: Dict[str, int] = {}
    recoveries: Dict[str, int] = {}
    quarantined = 0
    resumes = 0
    for s in spans:
        if s.kind == "fault":
            k = str(s.attrs.get("fault", s.name))
            faults[k] = faults.get(k, 0) + 1
        elif s.kind == "recovery":
            k = str(s.attrs.get("fault", s.name))
            recoveries[k] = recoveries.get(k, 0) + 1
            quarantined += int(s.attrs.get("quarantined", 0))
        elif s.kind == "resume":
            resumes += 1

    return TraceReport(regions=regions, merges=len(merges),
                       anomalies=anomalies[:top], n_spans=len(spans),
                       kinds=kinds, shard_dispatch=_shard_dispatch(spans),
                       faults=faults, recoveries=recoveries,
                       quarantined=quarantined, resumes=resumes,
                       serving=_serving(spans))


def _table(headers: List[str], rows: List[List[str]]) -> str:
    widths = [max(len(h), *(len(r[i]) for r in rows)) if rows else len(h)
              for i, h in enumerate(headers)]
    def fmt(cells):
        return "  ".join(c.ljust(w) for c, w in zip(cells, widths)).rstrip()
    lines = [fmt(headers), fmt(["-" * w for w in widths])]
    lines += [fmt(r) for r in rows]
    return "\n".join(lines)


def render(report: TraceReport) -> str:
    """Human-readable report text (what the CLI prints)."""
    out: List[str] = []
    kinds = " ".join(f"{k}={n}" for k, n in sorted(report.kinds.items()))
    out.append(f"trace: {report.n_spans} spans "
               f"({kinds or 'empty'}), {report.merges} merge(s)")
    out.append("")
    out.append("per-region rounds")
    rows = []
    for r in report.regions:
        rows.append([r.region, str(r.rounds), f"{r.end_sim:.1f}",
                     f"{r.mean_round:.1f}", f"{r.max_round:.1f}",
                     str(r.handovers), str(r.outages),
                     "-" if r.final_acc is None else f"{r.final_acc:.3f}"])
    out.append(_table(["region", "rounds", "end_sim_s", "mean_round_s",
                       "max_round_s", "handovers", "outages", "final_acc"],
                      rows))
    out.append("")
    out.append("latency breakdown (simulated seconds)")
    rows = []
    for r in report.regions:
        tot = r.compute + r.uplink + r.isl + r.idle
        def pct(v):
            return f"{100 * v / tot:.0f}%" if tot > 0 else "-"
        rows.append([r.region, f"{r.compute:.1f} ({pct(r.compute)})",
                     f"{r.uplink:.1f} ({pct(r.uplink)})",
                     f"{r.isl:.1f} ({pct(r.isl)})",
                     f"{r.idle:.1f} ({pct(r.idle)})"])
    out.append(_table(["region", "compute", "uplink", "isl", "idle"], rows))
    out.append("")
    sd = report.shard_dispatch
    if sd is not None:
        out.append(f"sharded dispatch (mesh {'x'.join(map(str, sd.mesh_shape))}, "
                   f"{sd.dispatches} dispatch(es), "
                   f"{1e3 * sd.wall_s:.1f} ms total, "
                   f"imbalance {sd.imbalance:.2f}x)")
        total_real = sum(r.real_elements for r in sd.shards) or 1
        rows = [[str(r.shard), str(r.real_elements),
                 f"{100 * r.real_elements / total_real:.0f}%",
                 f"{1e3 * r.wall_s:.1f}"]
                for r in sd.shards]
        out.append(_table(["shard", "real_elems", "share", "wall_ms"], rows))
        out.append("")
    if report.faults or report.recoveries or report.resumes:
        total_inj = sum(report.faults.values())
        total_rec = sum(report.recoveries.values())
        out.append(f"resilience ({total_inj} fault(s) injected, "
                   f"{total_rec} recovered, "
                   f"{report.quarantined} update(s) quarantined, "
                   f"{report.resumes} resume(s))")
        kinds_seen = sorted(set(report.faults) | set(report.recoveries))
        rows = [[k, str(report.faults.get(k, 0)),
                 str(report.recoveries.get(k, 0))] for k in kinds_seen]
        if rows:
            out.append(_table(["fault", "injected", "recovered"], rows))
        out.append("")
    sv = report.serving
    if sv is not None:
        acc = ("-" if sv.served_accuracy is None
               else f"{sv.served_accuracy:.3f}")
        out.append(f"serving ({sv.requests} request(s), {sv.batches} "
                   f"dispatch(es), {sv.qps:.2f} req/s sustained, "
                   f"served_acc {acc})")
        out.append(_table(
            ["p50_s", "p99_s", "mean_s", "wait_s", "batch", "fill"],
            [[f"{sv.latency_p50:.3f}", f"{sv.latency_p99:.3f}",
              f"{sv.latency_mean:.3f}", f"{sv.wait_mean:.3f}",
              f"{sv.mean_batch:.1f}", f"{100 * sv.fill:.0f}%"]]))
        if sv.by_region:
            total = sum(sv.by_region.values()) or 1
            rows = [[name, str(n), f"{100 * n / total:.0f}%"]
                    for name, n in sorted(sv.by_region.items())]
            out.append(_table(["region", "requests", "share"], rows))
        if sv.by_target:
            out.append("routes: " + " ".join(
                f"{k}={n}" for k, n in sorted(sv.by_target.items())))
        out.append("")
    if report.anomalies:
        out.append(f"top anomalies ({len(report.anomalies)})")
        for a in report.anomalies:
            out.append(f"  [{a.kind}] {a.message}")
    else:
        out.append("no anomalies detected")
    return "\n".join(out)
