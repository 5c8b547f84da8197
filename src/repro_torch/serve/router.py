"""Per-request offloading routers: where should this inference run?

Mirrors the paper's adaptive data-offloading decision on the serving
plane.  Every request admitted in region ``i`` has three candidate
execution sites:

* ``("sat", i)`` — the region's serving satellite: fast compute
  (``f ~ U[1,10]`` GHz), one ground-to-space round trip, but exposed to
  uplink dead-air outages;
* ``("isl", j)`` — a neighbouring region's serving satellite, reached
  over the ISL topology (:func:`repro_torch.core.latency.isl_path_hops`):
  pays per-hop transmission at the live ``z_isl * isl_scale`` rate, and
  is served by whatever model region ``j`` currently holds;
* ``("ground", i)`` — the local ground fallback: negligible network
  latency but two orders of magnitude slower compute (``F_GROUND``).

:class:`MinResponseTimeRouter` picks the candidate with the smallest
*estimated* response time — propagation + transmission (outage-aware,
from the live :class:`LinkState`) + queueing (current depth times the
node's per-request service time) + the request's own service — the
serving analogue of the offloading optimizer's latency minimization.
:class:`StaticNearestRouter` is the baseline: always the originating
region's serving satellite, blind to queues and outages (exactly what
the paper's adaptive offloading improves on; ``chip_smoke.py`` checks
min-rt's p99 win under ``flash_crowd``).

Everything here is pure arithmetic over explicit state — no RNG, no
tensors — so routing decisions are deterministic given the link snapshot.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from ..core.latency import isl_path_hops, tx_time
from ..core.network import SAT_ALTITUDE

#: Speed of light (m/s) for propagation delays.
C_LIGHT = 3e8

#: Cycles per inference request — two orders of magnitude below the
#: paper's per-sample TRAINING cost (``M_CYCLES`` = 3e9): a forward
#: pass on one sample, no backprop, no local epochs.
INFER_CYCLES = 3e7

#: Nominal ground-to-space uplink rate for one request payload (bits/s);
#: weather scales it through ``LinkState.rate_scale``.
UPLINK_RATE = 20e6

#: Fixed last-mile latency to the local ground fallback (s).
GROUND_RTT = 2e-3

NodeKey = Tuple[str, int]       # ("sat" | "isl" | "ground", region index)

NODE_KINDS = ("sat", "isl", "ground")


@dataclasses.dataclass(frozen=True)
class LinkState:
    """One region's live serving-plane link snapshot.

    Sampled by the gateway from the scenario's
    :class:`~repro_torch.sim.dynamics.DynamicsConfig` every ``link_refresh``
    seconds: ``isl_scale`` (<1 during an ISL fade) stretches every ISL
    hop, ``uplink_delay`` (>0 during dead-air) adds to any route
    through this region's satellite, ``rate_scale`` is the weather
    multiplier on ground/air channel rates.
    """
    isl_scale: float = 1.0
    uplink_delay: float = 0.0
    rate_scale: float = 1.0


@dataclasses.dataclass(frozen=True)
class RouteDecision:
    """The chosen execution site and its estimated response time (s)."""
    target: NodeKey
    est_response: float
    # estimate components, for spans/debugging
    network: float = 0.0        # propagation + transmission + outage
    queueing: float = 0.0       # depth * service
    service: float = 0.0


class ServeTopology:
    """Static facts the routers price against: per-region satellite and
    ground compute frequencies, request payload size, ISL rate/topology.

    ``sat_f[i]`` is region ``i``'s serving-satellite CPU frequency
    (heterogeneous, from the region's network model); ``req_bits`` is
    one request's payload (one sample, ``ds.sample_bits``).
    """

    def __init__(self, sat_f: List[float], ground_f: float,
                 req_bits: float, z_isl: float, topology: str = "ring"):
        if not sat_f:
            raise ValueError("ServeTopology needs >= 1 region")
        self.sat_f = [float(f) for f in sat_f]
        self.ground_f = float(ground_f)
        self.req_bits = float(req_bits)
        self.z_isl = float(z_isl)
        self.topology = topology
        self.n_regions = len(sat_f)

    def service_time(self, node: NodeKey) -> float:
        """Per-request compute time at a node (``INFER_CYCLES / f``)."""
        kind, j = node
        if kind == "ground":
            return INFER_CYCLES / self.ground_f
        return INFER_CYCLES / self.sat_f[j]

    def candidates(self, origin: int) -> List[NodeKey]:
        """Candidate execution sites for a request from ``origin``: the
        own serving satellite, the adjacent regions' satellites over the
        ISL (the SAME physical node as that region's own traffic — one
        queue per satellite), and the local ground fallback."""
        cands: List[NodeKey] = [("sat", origin)]
        n = self.n_regions
        if n > 1:
            neighbours = {(origin + 1) % n, (origin - 1) % n} - {origin}
            cands += [("sat", j) for j in sorted(neighbours)]
        cands.append(("ground", origin))
        return cands

    def network_time(self, origin: int, node: NodeKey,
                     links: Dict[int, LinkState]) -> float:
        """Network part of the estimate: propagation + transmission +
        realized outage delays along the route."""
        kind, j = node
        if kind == "ground":
            return GROUND_RTT
        ls = links.get(origin, LinkState())
        up = (tx_time(self.req_bits, UPLINK_RATE * max(ls.rate_scale, 1e-6))
              + 2.0 * SAT_ALTITUDE / C_LIGHT + ls.uplink_delay)
        if j == origin:
            return up
        # ISL neighbour: climb to the own satellite first, then hop the
        # payload across at the live (possibly faded) ISL rate
        hops = isl_path_hops(self.topology, origin, j, self.n_regions)
        scale = max(min(ls.isl_scale,
                        links.get(j, LinkState()).isl_scale), 1e-6)
        per_hop = (tx_time(self.req_bits, self.z_isl * scale)
                   + SAT_ALTITUDE / C_LIGHT)
        return up + hops * per_hop


class MinResponseTimeRouter:
    """Adaptive router: smallest estimated response time over all
    candidates, queue- and outage-aware."""

    name = "min_rt"

    def __init__(self, topo: ServeTopology):
        self.topo = topo

    def route(self, origin: int, queue_depth: Dict[NodeKey, int],
              links: Dict[int, LinkState]) -> RouteDecision:
        best: RouteDecision | None = None
        for node in self.topo.candidates(origin):
            service = self.topo.service_time(node)
            network = self.topo.network_time(origin, node, links)
            queueing = queue_depth.get(node, 0) * service
            est = network + queueing + service
            if best is None or est < best.est_response:
                best = RouteDecision(target=node, est_response=est,
                                     network=network, queueing=queueing,
                                     service=service)
        if best is None:        # candidates() always yields >= 2 sites
            raise ValueError(f"no route candidates for origin {origin}")
        return best


class StaticNearestRouter:
    """Baseline: always the originating region's serving satellite —
    the pre-offloading policy the paper's adaptive scheme replaces.
    The estimate still prices the route honestly (outages included),
    it just never influences the choice."""

    name = "static_nearest"

    def __init__(self, topo: ServeTopology):
        self.topo = topo

    def route(self, origin: int, queue_depth: Dict[NodeKey, int],
              links: Dict[int, LinkState]) -> RouteDecision:
        node: NodeKey = ("sat", origin)
        service = self.topo.service_time(node)
        network = self.topo.network_time(origin, node, links)
        queueing = queue_depth.get(node, 0) * service
        return RouteDecision(target=node,
                             est_response=network + queueing + service,
                             network=network, queueing=queueing,
                             service=service)


ROUTERS = {
    "min_rt": MinResponseTimeRouter,
    "static_nearest": StaticNearestRouter,
}


def get_router(name: str, topo: ServeTopology):
    try:
        cls = ROUTERS[name]
    except KeyError:
        raise ValueError(f"unknown router {name!r}; available: "
                         f"{sorted(ROUTERS)}") from None
    return cls(topo)
