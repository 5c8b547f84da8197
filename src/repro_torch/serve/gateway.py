"""Event-stepped serving gateway over a running :class:`SAGINEngine`.

:class:`ServeGateway` closes the loop the ROADMAP's north star asks
for — "serving heavy traffic" — on top of the training stack that
already exists:

* **admission** — each simulated ``dt`` slot, every region's
  :class:`~repro_torch.serve.workload.RegionWorkload` emits arrivals; each
  request is routed AT ADMISSION by the configured router
  (:mod:`repro_torch.serve.router`) using the live queue depths and the
  serving-plane link state (re-sampled from the scenario's
  :class:`~repro_torch.sim.dynamics.DynamicsConfig` every ``link_refresh``
  simulated seconds);
* **batched dispatch** — at each slot boundary, every target node
  drains its queue in chunks of ``max_batch``, padded up to the
  geometric grid ``batch_align * 2**k``
  (:func:`repro_torch.data.pipeline.next_geometric` — the reference's
  compile-once idiom, kept so that batch widths, padding and the
  ``serve_batch`` spans match the JAX package's), and one batched
  inference runs against whatever model the target's region CURRENTLY
  holds;
* **accounting** — per-request end-to-end simulated latency (wait +
  batched service + network), served accuracy against the origin
  region's labels, wall-clock inference throughput, and ``request`` /
  ``serve_batch`` spans + ``serve.*`` metrics into the run's shared
  :class:`repro_torch.obs.Tracer`.

The gateway is strictly READ-ONLY on training state: it never writes a
trainer's params, never consumes a training/dynamics RNG draw (all
serve-plane streams are rooted at
:func:`repro_torch.serve.workload.serve_rng`; no torch generator is
drawn from), and never moves a region's wall clock — attaching one to
an engine leaves training trajectories bit-identical
(``tests/test_torch_serve_gateway.py``).

The regions' eval sets live on the trainers' device; the gateway takes
one host copy of each at construction, so the per-request gather runs
on the host exactly as in the reference, and each dispatch copies one
padded batch to the device.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.network import F_GROUND
from ..data.pipeline import next_geometric
from ..obs import resolve_obs
from .router import (LinkState, NodeKey, RouteDecision, ServeTopology,
                     get_router)
from .workload import Request, RegionWorkload, ServeConfig, serve_rng


def resolve_serve(value) -> ServeConfig:
    """Coerce an ``FLConfig.serve``/``Scenario.serve`` value: ``None``
    means the default :class:`ServeConfig`."""
    if value is None:
        return ServeConfig()
    if isinstance(value, ServeConfig):
        return value
    raise TypeError(f"serve must be None or a ServeConfig, got "
                    f"{type(value).__name__}")


@dataclasses.dataclass
class ServeReport:
    """Headline numbers of one gateway session."""
    router: str
    duration: float                 # simulated seconds served
    requests: int                   # admitted
    served: int                     # completed (== admitted: queues drain)
    batches: int                    # batched dispatches issued
    qps_sim: float                  # served / simulated duration
    qps_wall: float                 # served / wall seconds spent in inference
    latency_p50: float              # end-to-end simulated seconds
    latency_p99: float
    latency_mean: float
    wait_mean: float                # queueing share of the latency
    served_accuracy: Optional[float]        # None: backend has no labels
    acc_by_region: Dict[str, float] = dataclasses.field(default_factory=dict)
    count_by_target: Dict[str, int] = dataclasses.field(default_factory=dict)

    def summary(self) -> str:
        acc = ("-" if self.served_accuracy is None
               else f"{self.served_accuracy:.3f}")
        targets = " ".join(f"{k}={n}"
                           for k, n in sorted(self.count_by_target.items()))
        return (f"router={self.router} served={self.served}/{self.requests} "
                f"batches={self.batches} qps_sim={self.qps_sim:.2f} "
                f"qps_wall={self.qps_wall:.0f} "
                f"p50={self.latency_p50:.3f}s p99={self.latency_p99:.3f}s "
                f"acc={acc} [{targets}]")


class ServeGateway:
    """Request-driven serving over an FL-mode :class:`SAGINEngine`.

    ``serve`` overrides the resolved config (argument >
    ``FLConfig.serve`` > ``Scenario.serve`` > defaults); ``tracer``
    overrides the engine's shared tracer; ``backend`` swaps the model
    executor (default: :class:`~repro_torch.serve.backends.CNNBackend` over
    the engine's live region models).
    """

    def __init__(self, engine, serve: Optional[ServeConfig] = None,
                 tracer=None, backend=None):
        if not getattr(engine, "trainers", None):
            raise ValueError("ServeGateway needs an FL-mode SAGINEngine "
                             "(construct it with fl=FLConfig(...))")
        self.engine = engine
        self.scenario = engine.scenario
        if serve is not None:
            cfg = serve
        elif engine.fl_config is not None and engine.fl_config.serve is not None:
            cfg = resolve_serve(engine.fl_config.serve)
        else:
            cfg = resolve_serve(getattr(self.scenario, "serve", None))
        self.cfg = cfg
        self.tracer = resolve_obs(tracer) if tracer is not None \
            else engine.tracer

        trainers = engine.trainers
        seed = engine.fl_config.seed
        fed = engine.federation
        topology = fed.topology if fed is not None else "ring"
        self.topo = ServeTopology(
            sat_f=[t.sagin.satellites[0].f for t in trainers],
            ground_f=F_GROUND,
            req_bits=trainers[0].ds.sample_bits,
            z_isl=trainers[0].sagin.z_isl,
            topology=topology)
        self.router = get_router(cfg.router, self.topo)
        self.workloads = [
            RegionWorkload(
                cfg, i, seed, n_eval=len(t.x_eval),
                n_devices=t.cfg.n_devices,
                churn_prob=(self.scenario.dynamics.churn_prob
                            if self.scenario.dynamics is not None else 0.0),
                phase=(t.region.lon_deg / 360.0
                       if t.region is not None else 0.0))
            for i, t in enumerate(trainers)]
        # serving-plane link dynamics: same DynamicsConfig as training,
        # independent serve-rooted streams (training draws untouched)
        self._link_dyn = None
        if self.scenario.dynamics is not None:
            from ..sim.dynamics import NetworkDynamics
            self._link_dyn = [
                NetworkDynamics(self.scenario.dynamics,
                                rng=serve_rng(seed, i).spawn(1)[0])
                for i in range(len(trainers))]
        self.links: Dict[int, LinkState] = {
            i: LinkState() for i in range(len(trainers))}
        self._link_round = 0

        from .backends import CNNBackend
        self.backend = backend if backend is not None \
            else CNNBackend(trainers)
        # origin-region eval data, host-side, gathered per batch (host
        # copies of the trainers' eval tensors, taken once)
        self._x = [t.x_eval.cpu().numpy() for t in trainers]
        self._y = [t.y_eval.cpu().numpy() for t in trainers]

        self.queues: Dict[NodeKey, List[Tuple[Request, RouteDecision]]] = {}
        self.busy_until: Dict[NodeKey, float] = {}
        self.completed: List[Request] = []
        self.n_batches = 0
        self.wall_infer = 0.0       # wall seconds inside batched inference
        self._rid = 0

    # -- link state ---------------------------------------------------------
    def _refresh_links(self) -> None:
        if self._link_dyn is None:
            return
        for i, dyn in enumerate(self._link_dyn):
            ev = dyn.sample_round(self._link_round, n_sats=1, n_clusters=1,
                                  n_devices=0)
            self.links[i] = LinkState(
                isl_scale=float(ev.isl_scale),
                uplink_delay=float(sum(ev.uplink_delays.values())),
                rate_scale=float(ev.rate_scale))
        self._link_round += 1

    # -- main loop ----------------------------------------------------------
    def run(self, duration: float, t0: Optional[float] = None) -> ServeReport:
        """Serve ``duration`` simulated seconds of traffic starting at
        ``t0`` (default: the latest region wall clock — "now").  Admits
        arrivals slot by slot, dispatches each node's queue at every
        slot boundary, drains all queues at the end, and returns the
        session's :class:`ServeReport`."""
        cfg = self.cfg
        if t0 is None:
            t0 = max(t.wall_clock for t in self.engine.trainers)
        n_slots = int(math.ceil(duration / cfg.dt))
        refresh_every = max(1, int(round(cfg.link_refresh / cfg.dt)))
        n_admitted_before = self._rid
        served_before = len(self.completed)
        wall_before = self.wall_infer
        tr = self.tracer
        for k in range(n_slots):
            t_slot = t0 + k * cfg.dt
            if k % refresh_every == 0:
                self._refresh_links()
            for i, wl in enumerate(self.workloads):
                for off, sample in wl.step(t_slot):
                    self._admit(i, t_slot + off, sample)
            t_edge = t_slot + cfg.dt
            self._dispatch_all(t_edge)
        report = self._report(duration,
                              requests=self._rid - n_admitted_before,
                              served_from=served_before,
                              wall_from=wall_before)
        if tr.enabled:
            tr.flush()
        return report

    def _admit(self, origin: int, t: float, sample: int) -> None:
        req = Request(rid=self._rid, region=origin, t_arrival=t,
                      sample=sample)
        self._rid += 1
        depth = {node: len(q) for node, q in self.queues.items()}
        dec = self.router.route(origin, depth, self.links)
        req.target = dec.target
        self.queues.setdefault(dec.target, []).append((req, dec))
        tr = self.tracer
        if tr.enabled:
            tr.metrics.counter("serve.requests").inc()
            tr.metrics.histogram("serve.est_response_s").observe(
                dec.est_response)

    def _dispatch_all(self, t_now: float) -> None:
        for node in sorted(self.queues):
            q = self.queues[node]
            while q:
                chunk = q[:self.cfg.max_batch]
                del q[:self.cfg.max_batch]
                self._dispatch(node, chunk, t_now)

    def _dispatch(self, node: NodeKey,
                  chunk: List[Tuple[Request, RouteDecision]],
                  t_now: float) -> None:
        """One batched inference at ``node``: pad the chunk to the
        geometric width, execute against the node's region model, and
        complete every request in the chunk."""
        cfg = self.cfg
        n = len(chunk)
        pad = next_geometric(n, cfg.batch_align)
        kind, j = node
        model_region = j
        samples = np.zeros(pad, dtype=np.int64)
        x = np.zeros((pad,) + self._x[0].shape[1:], dtype=self._x[0].dtype)
        for p, (req, _) in enumerate(chunk):
            samples[p] = req.sample
            x[p] = self._x[req.region][req.sample]

        # predict ends in a host copy (CNN) or a synchronize
        # (transformer): the wall covers a finished inference
        w0 = time.perf_counter()
        preds = self.backend.predict(model_region, x, samples)
        infer_wall = time.perf_counter() - w0
        self.wall_infer += infer_wall
        self.n_batches += 1

        dispatch_t = max(t_now, self.busy_until.get(node, 0.0))
        service_sim = n * self.topo.service_time(node)
        self.busy_until[node] = dispatch_t + service_sim
        tr = self.tracer
        region_name = self.engine.scenario.regions[j].name
        for p, (req, dec) in enumerate(chunk):
            req.t_done = dispatch_t + service_sim + dec.network
            req.latency = req.t_done - req.t_arrival
            req.wait = dispatch_t - req.t_arrival
            if preds is not None:
                req.correct = bool(
                    preds[p] == self._y[req.region][req.sample])
            self.completed.append(req)
            if tr.enabled:
                origin_name = self.engine.scenario.regions[req.region].name
                route = ("ground" if kind == "ground"
                         else ("sat" if j == req.region else "isl"))
                tr.span("request", f"req{req.rid}", region=origin_name,
                        round=-1, t_sim=req.t_arrival, dur_sim=req.latency,
                        target=f"{kind}{j}", route=route,
                        wait_s=req.wait,
                        network_s=dec.network, correct=req.correct)
                tr.metrics.histogram("serve.latency_s",
                                     window=4096).observe(req.latency)
                tr.metrics.histogram("serve.wait_s", window=4096).observe(
                    dispatch_t - req.t_arrival)
                if req.correct is not None:
                    tr.metrics.counter("serve.correct").inc(
                        1.0 if req.correct else 0.0)
        if tr.enabled:
            tr.span("serve_batch", f"{kind}{j}/b{self.n_batches}",
                    region=region_name, round=-1, t_sim=dispatch_t,
                    dur_sim=service_sim, dur_wall=infer_wall,
                    node=f"{kind}{j}", n_real=n, n_pad=pad,
                    queue_after=len(self.queues.get(node, ())))
            tr.metrics.counter("serve.batches").inc()
            tr.metrics.histogram("serve.batch_real").observe(n)
            tr.metrics.gauge(f"serve.queue_depth.{kind}{j}").set(
                len(self.queues.get(node, ())))

    # -- reporting ----------------------------------------------------------
    def _report(self, duration: float, requests: int, served_from: int,
                wall_from: float) -> ServeReport:
        done = self.completed[served_from:]
        lats = np.asarray([r.latency for r in done], dtype=np.float64)
        served = len(done)
        wall = self.wall_infer - wall_from
        acc: Optional[float] = None
        acc_by_region: Dict[str, float] = {}
        if self.backend.has_labels and served:
            flags = np.asarray([bool(r.correct) for r in done])
            acc = float(flags.mean())
            for i, region in enumerate(self.engine.scenario.regions):
                mask = np.asarray([r.region == i for r in done])
                if mask.any():
                    acc_by_region[region.name] = float(flags[mask].mean())
        count_by_target: Dict[str, int] = {}
        for r in done:
            kind, j = r.target
            label = kind if (kind == "ground" or j == r.region) else "isl"
            count_by_target[label] = count_by_target.get(label, 0) + 1
        return ServeReport(
            router=self.router.name, duration=duration, requests=requests,
            served=served, batches=self.n_batches,
            qps_sim=served / duration if duration > 0 else 0.0,
            qps_wall=served / wall if wall > 0 else 0.0,
            latency_p50=float(np.percentile(lats, 50)) if served else 0.0,
            latency_p99=float(np.percentile(lats, 99)) if served else 0.0,
            latency_mean=float(lats.mean()) if served else 0.0,
            wait_mean=float(np.mean([r.wait for r in done]))
            if served else 0.0,
            served_accuracy=acc, acc_by_region=acc_by_region,
            count_by_target=count_by_target)
