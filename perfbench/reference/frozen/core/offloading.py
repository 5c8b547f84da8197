# Frozen copy of src/repro_torch/core/offloading.py at commit ed1d7aa (unchanged but
# for this header): the NumPy control plane that the benchmark's
# reference replays to work out the dataset, partition, pools, plans and
# batches again, independently of the program under test.
"""Adaptive inter-layer data offloading (Section IV, Algorithms 1 & 2).

The paper solves ``min max{tau_S, max_n (tau_A,n + tau_A2S)}`` with
hierarchical bisection: an outer bisection on the amount of data moved
between the space and air layers, and inner bisections equalizing per-node
completion times. We implement the same fixed point organized as a single
bisection on the achieved round latency ``T`` with closed-form per-node
"absorb capacity" / "shed need" inverses of the piecewise-linear latency
functions (eqs. 21, 24-25, 30, 33-34). This produces the same solution to
within the bisection tolerance while keeping the control plane fast; the
literal nested pseudocode of Algorithms 1-2 is provided in
``algorithm1_literal`` and cross-validated in tests.

Directions follow Section IV-A:
  Case I  (tau_S > tau_air):  space -> air -> (possibly) ground
  Case II (tau_S < tau_air):  ground -> air -> space
Within a cluster the transfer direction between the air node and its ground
devices is chosen by the paper's per-cluster test.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np

from . import latency as lat
from .handover import space_latency
from .network import SAGIN

_EPS = 1e-6


# ---------------------------------------------------------------------------
# Generic bisection helpers --------------------------------------------------
# ---------------------------------------------------------------------------
def bisect_min_feasible(pred, lo: float, hi: float, tol: float,
                        max_iter: int = 80) -> float:
    """Smallest x in [lo,hi] with pred(x) True (pred monotone in x)."""
    if pred(lo):
        return lo
    if not pred(hi):
        return hi
    for _ in range(max_iter):
        if hi - lo <= tol:
            break
        mid = 0.5 * (lo + hi)
        if pred(mid):
            hi = mid
        else:
            lo = mid
    return hi


def bisect_max_feasible(pred, lo: float, hi: float, tol: float,
                        max_iter: int = 80) -> float:
    """Largest x in [lo,hi] with pred(x) True (pred anti-monotone in x)."""
    if not pred(lo):
        return lo
    if pred(hi):
        return hi
    for _ in range(max_iter):
        if hi - lo <= tol:
            break
        mid = 0.5 * (lo + hi)
        if pred(mid):
            lo = mid
        else:
            hi = mid
    return lo


# ---------------------------------------------------------------------------
# Closed-form per-device absorb / shed inverses ------------------------------
# ---------------------------------------------------------------------------
def _ground_absorb(a: float, b: float, c: float, e: float, up: float,
                   target: float, cap: float) -> float:
    """Max d with  max(a, b + c*d) + e*d + up <= target,  0 <= d <= cap.

    a: own computation time; b: pre-delay before samples arrive; c: per-sample
    receive delay; e: per-sample compute time; up: model upload delay.
    Closed-form inverse of eq. (25) / its intra-cluster variants.
    """
    t = target - up
    if max(a, b) > t + _EPS:
        return 0.0
    d1 = (t - a) / e if e > 0 else math.inf
    if b + c * d1 <= a + _EPS:
        d = d1
    else:
        d = (t - b) / (c + e) if (c + e) > 0 else math.inf
    return max(0.0, min(d, cap))


def _ground_shed_need(own_t: float, c_send: float, e: float, up: float,
                      target: float, n_samples: float,
                      cap: float) -> Tuple[float, bool]:
    """Min d with  max(e*(n-d), c_send*d) + up <= target,  d <= cap.

    Inverse of eq. (34) + upload. Returns (d, feasible).
    own_t = e*n is the no-shed computation time.
    """
    t = target - up
    if own_t <= t + _EPS:
        return 0.0, True
    if e <= 0:
        return 0.0, False
    d = n_samples - t / e          # from e*(n-d) = t
    if d > cap + _EPS:
        return min(d, cap), False
    if c_send * d > t + _EPS:      # sending that much already misses target
        return d, False
    return max(0.0, d), True


# ---------------------------------------------------------------------------
# Plans ----------------------------------------------------------------------
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ClusterPlan:
    n: int
    d_space_air: float = 0.0                 # + : satellite -> air node n
    d_air_space: float = 0.0                 # + : air node n -> satellite
    d_air_ground: Dict[int, float] = dataclasses.field(default_factory=dict)
    d_ground_air: Dict[int, float] = dataclasses.field(default_factory=dict)
    latency: float = 0.0                     # tau_A,n-bar + tau_A2S


@dataclasses.dataclass
class OffloadPlan:
    case: int                                # 0: none, 1: S->A/G, 2: A/G->S
    clusters: List[ClusterPlan]
    new_sat_samples: float
    space_latency: float
    round_latency: float
    baseline_latency: float                  # eq. (16), no offloading

    def new_sizes(self, sagin: SAGIN):
        """(ground sizes, air sizes, sat size) after applying the plan."""
        g = [d.n_samples for d in sagin.devices]
        a = [x.n_samples for x in sagin.air_nodes]
        s = float(sagin.n_sat_samples)
        for cp in self.clusters:
            a[cp.n] += cp.d_space_air - cp.d_air_space
            s += cp.d_air_space - cp.d_space_air
            for k, d in cp.d_air_ground.items():
                g[k] += d
                a[cp.n] -= d
            for k, d in cp.d_ground_air.items():
                g[k] -= d
                a[cp.n] += d
        # clip numerical dust (sub-sample negatives) back onto the satellite
        for i, v in enumerate(a):
            if -1.0 < v < 0.0:
                s += v
                a[i] = 0.0
        for i, v in enumerate(g):
            if -1.0 < v < 0.0:
                s += v
                g[i] = 0.0
        return g, a, s


# ---------------------------------------------------------------------------
# Intra-cluster balancing, Case I (Algorithm 1) ------------------------------
# ---------------------------------------------------------------------------
def cluster_case1(sagin: SAGIN, n: int, d_s2a: float,
                  tol: float = 1e-3) -> ClusterPlan:
    """Optimal intra-cluster allocation given ``d_s2a`` samples arriving
    from the satellite (Algorithm 1 + the symmetric ground->air sub-case)."""
    air = sagin.air_nodes[n]
    ks = sagin.clusters[n]
    recv_sat = lat.tx_time(sagin.q_bits * d_s2a, sagin.s2a_rate(n)) \
        if d_s2a > 0 else 0.0
    own_air = lat.comp_time(air.m, air.n_samples, air.f)
    e_air = air.m / air.f

    def air_delay_shed(y: float) -> float:
        # eq. (24): air forwards y of (its own + received) samples to ground
        new_size = air.n_samples + d_s2a - y
        if new_size <= air.n_samples:
            return lat.comp_time(air.m, max(0.0, new_size), air.f)
        return max(own_air, recv_sat) + e_air * (d_s2a - y)

    ground0 = 0.0
    for k in ks:
        dev = sagin.devices[k]
        up = lat.model_upload_time(sagin.model_bits, sagin.g2a_rate(k, n))
        ground0 = max(ground0, lat.comp_time(dev.m, dev.n_samples, dev.f) + up)
    air0 = air_delay_shed(0.0)

    plan = ClusterPlan(n=n, d_space_air=d_s2a)
    if air0 >= ground0:
        # --- air -> ground (Algorithm 1 as written) -----------------------
        max_shed = air.n_samples + d_s2a

        def absorb_total(t: float) -> Dict[int, float]:
            out = {}
            for k in ks:
                dev = sagin.devices[k]
                up = lat.model_upload_time(sagin.model_bits,
                                           sagin.g2a_rate(k, n))
                a = lat.comp_time(dev.m, dev.n_samples, dev.f)
                c = sagin.q_bits / sagin.g2a_rate(k, n)
                e = dev.m / dev.f
                out[k] = _ground_absorb(a, recv_sat, c, e, up, t,
                                        cap=max_shed)
            return out

        def ok(t: float) -> bool:
            y = min(sum(absorb_total(t).values()), max_shed)
            return air_delay_shed(y) <= t

        t_star = bisect_min_feasible(ok, lo=0.0, hi=air0, tol=tol)
        alloc = absorb_total(t_star)
        total = sum(alloc.values())
        # air only needs to shed enough to meet t_star (paper equalization)
        y_need = bisect_min_feasible(lambda y: air_delay_shed(y) <= t_star,
                                     0.0, max_shed, tol)
        if total > y_need > 0 and total > 0:
            scale = y_need / total
            alloc = {k: v * scale for k, v in alloc.items()}
        plan.d_air_ground = {k: v for k, v in alloc.items() if v > tol}
    else:
        # --- ground -> air (symmetric sub-case) ---------------------------
        def solve(t: float):
            sheds, feas = {}, True
            for k in ks:
                dev = sagin.devices[k]
                up = lat.model_upload_time(sagin.model_bits,
                                           sagin.g2a_rate(k, n))
                c_send = sagin.q_bits / sagin.g2a_rate(k, n)
                e = dev.m / dev.f
                cap = float(dev.n_offloadable)
                d, f = _ground_shed_need(e * dev.n_samples, c_send, e, up,
                                         t, dev.n_samples, cap)
                sheds[k] = d
                feas = feas and f
            return sheds, feas

        def air_delay_recv(sheds: Dict[int, float]) -> float:
            recv_g = max((sagin.q_bits * d / sagin.g2a_rate(k, n)
                          for k, d in sheds.items()), default=0.0)
            extra = d_s2a + sum(sheds.values())
            return max(own_air, recv_sat, recv_g) + e_air * extra

        def ok(t: float) -> bool:
            sheds, feas = solve(t)
            return feas and air_delay_recv(sheds) <= t

        t_star = bisect_min_feasible(ok, lo=0.0, hi=ground0, tol=tol)
        sheds, _ = solve(t_star)
        plan.d_ground_air = {k: v for k, v in sheds.items() if v > tol}

    plan.latency = evaluate_cluster(sagin, plan) \
        + lat.model_upload_time(sagin.model_bits, sagin.a2s_rate(n))
    return plan


# ---------------------------------------------------------------------------
# Intra-cluster balancing, Case II -------------------------------------------
# ---------------------------------------------------------------------------
def cluster_case2(sagin: SAGIN, n: int, d_a2s: float,
                  tol: float = 1e-3) -> ClusterPlan:
    """Optimal intra-cluster allocation given that air node n must also send
    ``d_a2s`` samples up to the satellite (Case II, Section IV-C)."""
    air = sagin.air_nodes[n]
    ks = sagin.clusters[n]
    e_air = air.m / air.f
    send_sat = lat.tx_time(sagin.q_bits * d_a2s, sagin.a2s_rate(n)) \
        if d_a2s > 0 else 0.0

    ground0 = 0.0
    for k in ks:
        dev = sagin.devices[k]
        up = lat.model_upload_time(sagin.model_bits, sagin.g2a_rate(k, n))
        ground0 = max(ground0, lat.comp_time(dev.m, dev.n_samples, dev.f) + up)
    air_own = max(lat.comp_time(air.m, max(0.0, air.n_samples - d_a2s),
                                air.f), send_sat)

    plan = ClusterPlan(n=n, d_air_space=d_a2s)
    if air_own < ground0:
        # --- ground -> air (the sub-case written out in the paper) --------
        def solve(t: float):
            sheds, feas = {}, True
            for k in ks:
                dev = sagin.devices[k]
                up = lat.model_upload_time(sagin.model_bits,
                                           sagin.g2a_rate(k, n))
                c_send = sagin.q_bits / sagin.g2a_rate(k, n)
                e = dev.m / dev.f
                cap = float(dev.n_offloadable)          # eq. (35)
                d, f = _ground_shed_need(e * dev.n_samples, c_send, e, up,
                                         t, dev.n_samples, cap)
                sheds[k] = d
                feas = feas and f
            return sheds, feas

        def air_delay(sheds: Dict[int, float]) -> float:
            # eq. (33)
            recv_g = max((sagin.q_bits * d / sagin.g2a_rate(k, n)
                          for k, d in sheds.items()), default=0.0)
            own = lat.comp_time(air.m, air.n_samples, air.f)
            extra = sum(sheds.values()) - d_a2s
            if extra <= 0:
                return max(lat.comp_time(
                    air.m, air.n_samples + extra, air.f), send_sat, recv_g)
            return max(max(own, recv_g) + e_air * extra, send_sat)

        def ok(t: float) -> bool:
            sheds, feas = solve(t)
            return feas and air_delay(sheds) <= t

        t_star = bisect_min_feasible(ok, 0.0, max(ground0, air_own), tol)
        sheds, _ = solve(t_star)
        # repair: the air node must actually hold d_a2s samples to forward
        deficit = d_a2s - air.n_samples - sum(sheds.values())
        if deficit > 0:
            caps = {k: max(0.0, sagin.devices[k].n_offloadable - sheds[k])
                    for k in ks}
            r = sum(caps.values())
            if r > 0:
                give = min(deficit, r)
                for k in ks:
                    sheds[k] += give * caps[k] / r
        plan.d_ground_air = {k: v for k, v in sheds.items() if v > tol}
    else:
        # --- air -> ground -------------------------------------------------
        max_shed = max(0.0, air.n_samples - d_a2s)

        def air_delay_shed(y: float) -> float:
            return max(lat.comp_time(air.m,
                                     max(0.0, air.n_samples - d_a2s - y),
                                     air.f), send_sat)

        def absorb_total(t: float) -> Dict[int, float]:
            out = {}
            for k in ks:
                dev = sagin.devices[k]
                up = lat.model_upload_time(sagin.model_bits,
                                           sagin.g2a_rate(k, n))
                a = lat.comp_time(dev.m, dev.n_samples, dev.f)
                c = sagin.q_bits / sagin.g2a_rate(k, n)
                e = dev.m / dev.f
                out[k] = _ground_absorb(a, 0.0, c, e, up, t, cap=max_shed)
            return out

        def ok(t: float) -> bool:
            y = min(sum(absorb_total(t).values()), max_shed)
            return air_delay_shed(y) <= t

        t_star = bisect_min_feasible(ok, 0.0, max(air_own, ground0), tol)
        alloc = absorb_total(t_star)
        total = sum(alloc.values())
        y_need = bisect_min_feasible(lambda y: air_delay_shed(y) <= t_star,
                                     0.0, max_shed, tol)
        if total > y_need > 0 and total > 0:
            scale = y_need / total
            alloc = {k: v * scale for k, v in alloc.items()}
        plan.d_air_ground = {k: v for k, v in alloc.items() if v > tol}

    plan.latency = evaluate_cluster(sagin, plan) \
        + lat.model_upload_time(sagin.model_bits, sagin.a2s_rate(n))
    return plan


# ---------------------------------------------------------------------------
# Faithful evaluation of a cluster plan (eqs. 19, 24-25, 33-34) --------------
# ---------------------------------------------------------------------------
def evaluate_cluster(sagin: SAGIN, cp: ClusterPlan,
                     offline: Sequence[int] = ()) -> float:
    """tau_A,n-bar (eq. 19): completion of air node n + its devices.

    Devices in ``offline`` (churned out for the round) neither train nor
    upload, so they do not bound the cluster's completion time.
    """
    n = cp.n
    offline = set(offline)
    air = sagin.air_nodes[n]
    ks = sagin.clusters[n]
    recv_sat = lat.tx_time(sagin.q_bits * cp.d_space_air, sagin.s2a_rate(n)) \
        if cp.d_space_air > 0 else 0.0
    send_sat = lat.tx_time(sagin.q_bits * cp.d_air_space,
                           sagin.a2s_rate(n)) if cp.d_air_space > 0 else 0.0
    recv_g = max((sagin.q_bits * d / sagin.g2a_rate(k, n)
                  for k, d in cp.d_ground_air.items()), default=0.0)
    sent = sum(cp.d_air_ground.values())
    recvd = sum(cp.d_ground_air.values())
    new_air = air.n_samples + cp.d_space_air - cp.d_air_space + recvd - sent
    own = lat.comp_time(air.m, air.n_samples, air.f)
    if new_air <= air.n_samples:
        t_air = max(lat.comp_time(air.m, max(0.0, new_air), air.f),
                    send_sat, recv_sat if sent > 0 else 0.0)
    else:
        extra = new_air - air.n_samples
        t_air = max(max(own, recv_sat, recv_g)
                    + lat.comp_time(air.m, extra, air.f), send_sat)

    t_ground = 0.0
    for k in ks:
        if k in offline:
            continue
        dev = sagin.devices[k]
        up = lat.model_upload_time(sagin.model_bits, sagin.g2a_rate(k, n))
        d_in = cp.d_air_ground.get(k, 0.0)
        d_out = cp.d_ground_air.get(k, 0.0)
        if d_in > 0:
            a = lat.comp_time(dev.m, dev.n_samples, dev.f)
            recv = recv_sat + sagin.q_bits * d_in / sagin.g2a_rate(k, n)
            t = max(a, recv) + lat.comp_time(dev.m, d_in, dev.f)
        else:
            comp = lat.comp_time(dev.m, dev.n_samples - d_out, dev.f)
            send = sagin.q_bits * d_out / sagin.g2a_rate(k, n)
            t = max(comp, send)
        t_ground = max(t_ground, t + up)
    return max(t_air, t_ground)


def evaluate_plan(sagin: SAGIN, plan: OffloadPlan) -> float:
    """Full round latency (eq. 18) for a candidate plan."""
    t_space = space_latency(plan.new_sat_samples, sagin)
    t_air = 0.0
    for cp in plan.clusters:
        t = evaluate_cluster(sagin, cp) + lat.model_upload_time(
            sagin.model_bits, sagin.a2s_rate(cp.n))
        t_air = max(t_air, t)
    return max(t_space, t_air)


# ---------------------------------------------------------------------------
# Global optimization (Algorithm 2 organized by latency target) --------------
# ---------------------------------------------------------------------------
def optimize_offloading(sagin: SAGIN, tol: float = 1e-2) -> OffloadPlan:
    """Main entry point: decide the case, then jointly optimize inter-layer
    transfer amounts and intra-cluster allocations (Algorithms 1 & 2)."""
    t_space0 = space_latency(sagin.n_sat_samples, sagin)
    t_clusters0 = {
        n: lat.air_cluster_latency_no_offload(sagin, n)
        + lat.model_upload_time(sagin.model_bits, sagin.a2s_rate(n))
        for n in sagin.clusters
    }
    t_air0 = max(t_clusters0.values())
    baseline = max(t_space0, t_air0)

    if abs(t_space0 - t_air0) <= tol:
        plan = OffloadPlan(case=0, clusters=[
            ClusterPlan(n=n, latency=t_clusters0[n]) for n in sagin.clusters],
            new_sat_samples=sagin.n_sat_samples, space_latency=t_space0,
            round_latency=baseline, baseline_latency=baseline)
        return plan

    if t_space0 > t_air0:
        plan = _solve_case1(sagin, baseline, tol)
    else:
        plan = _solve_case2(sagin, baseline, tol)
    plan.baseline_latency = baseline
    # Safety net: adaptive must never be worse than no offloading.
    if plan.round_latency > baseline + tol:
        plan = OffloadPlan(case=0, clusters=[
            ClusterPlan(n=n, latency=t_clusters0[n]) for n in sagin.clusters],
            new_sat_samples=sagin.n_sat_samples, space_latency=t_space0,
            round_latency=baseline, baseline_latency=baseline)
    return plan


def _space_shed_need(sagin: SAGIN, target: float, tol: float) -> float:
    """Min X with tau_S(|D_S| - X) <= target."""
    total = float(sagin.n_sat_samples)
    return bisect_min_feasible(
        lambda x: space_latency(total - x, sagin) <= target,
        0.0, total, tol)


def _space_absorb_cap(sagin: SAGIN, target: float, tol: float,
                      hi: float) -> float:
    """Max X with tau_S(|D_S| + X) <= target."""
    total = float(sagin.n_sat_samples)
    return bisect_max_feasible(
        lambda x: space_latency(total + x, sagin) <= target,
        0.0, hi, tol)


_GRID = 33


def _latency_grid(sagin: SAGIN, n: int, case: int, hi: float, tol: float):
    """Cluster latency (incl. A2S model upload) over a grid of transfer
    amounts — evaluated once so the hierarchical bisections of Algorithm 2
    become interpolations instead of nested exact solves."""
    import numpy as _np
    ds = _np.linspace(0.0, max(hi, 1.0), _GRID)
    fn = cluster_case1 if case == 1 else cluster_case2
    ls = _np.array([fn(sagin, n, float(d), tol).latency for d in ds])
    return ds, ls


def _grid_min_d(ds, ls, nu: float):
    """Smallest d on the grid with latency <= nu (inf if infeasible)."""
    import numpy as _np
    ok = ls <= nu
    if not ok.any():
        return float("inf")
    i = int(_np.argmax(ok))
    if i == 0:
        return float(ds[0])
    # linear interpolation between the bracketing grid points
    d0, d1, l0, l1 = ds[i - 1], ds[i], ls[i - 1], ls[i]
    if l0 == l1:
        return float(d1)
    return float(d0 + (d1 - d0) * (l0 - nu) / (l0 - l1))


def _grid_max_d(ds, ls, nu: float):
    """Largest d on the grid with latency <= nu (-inf if infeasible)."""
    import numpy as _np
    ok = ls <= nu
    if not ok.any():
        return float("-inf")
    i = len(ls) - 1 - int(_np.argmax(ok[::-1]))
    if i == len(ls) - 1:
        return float(ds[-1])
    d0, d1, l0, l1 = ds[i], ds[i + 1], ls[i], ls[i + 1]
    if l0 == l1:
        return float(d0)
    return float(d0 + (d1 - d0) * (nu - l0) / (l1 - l0))


def _solve_case1(sagin: SAGIN, baseline: float, tol: float) -> OffloadPlan:
    """Case I: offload from space to air/ground.

    Outer bisection on the total amount X shed by the satellite until
    tau_S(|D_S| - X) meets the air-layer completion time (Algorithm 2);
    the inner level spreads X across clusters at a common latency level
    (Algorithm 2 line 8 + Algorithm 1 via cluster_case1)."""
    total = float(sagin.n_sat_samples)
    ns = list(sagin.clusters)
    grids = {n: _latency_grid(sagin, n, 1, total, tol) for n in ns}
    nu_lo = max(float(g[1].min()) for g in grids.values())
    nu_hi = max(float(g[1].max()) for g in grids.values())

    def distribute(x: float):
        """Spread x across clusters equalizing latency; return (alloc, nu)."""
        def cap_total(nu: float) -> float:
            return sum(max(0.0, _grid_max_d(*grids[n], nu)) for n in ns)

        nu = bisect_min_feasible(lambda v: cap_total(v) >= x,
                                 nu_lo, nu_hi, max(tol, nu_hi * 1e-4),
                                 max_iter=40)
        caps = {n: max(0.0, _grid_max_d(*grids[n], nu)) for n in ns}
        s = sum(caps.values())
        scale = min(1.0, x / s) if s > 0 else 0.0
        return {n: caps[n] * scale for n in ns}, nu

    lo, hi = 0.0, total
    for _ in range(40):
        x = 0.5 * (lo + hi)
        _, t_air = distribute(x)
        if space_latency(total - x, sagin) >= t_air:
            lo = x
        else:
            hi = x
    alloc, _ = distribute(0.5 * (lo + hi))
    clusters = [cluster_case1(sagin, n, alloc[n], tol) for n in ns]
    new_sat = total - sum(alloc.values())
    plan = OffloadPlan(case=1, clusters=clusters, new_sat_samples=new_sat,
                       space_latency=space_latency(new_sat, sagin),
                       round_latency=0.0, baseline_latency=baseline)
    plan.round_latency = evaluate_plan(sagin, plan)
    return plan


def _solve_case2(sagin: SAGIN, baseline: float, tol: float) -> OffloadPlan:
    """Case II: offload from air/ground to space."""
    ns = list(sagin.clusters)
    max_shed = {}
    for n in ns:
        air = sagin.air_nodes[n]
        cap = float(air.n_samples) + sum(
            sagin.devices[k].n_offloadable for k in sagin.clusters[n])
        max_shed[n] = cap

    grids = {n: _latency_grid(sagin, n, 2, max_shed[n], tol) for n in ns}
    total0 = float(sagin.n_sat_samples)

    def distribute(x: float):
        """Spread x across clusters: each sheds its minimum need at the
        common latency level nu with sum(needs) = x; leftover (when the
        satellite absorbs more than the clusters *need*) goes to clusters
        with remaining offloadable data. Returns (alloc, t_air)."""
        nu_lo = max(float(g[1].min()) for g in grids.values())
        nu_hi = max(float(g[1][0]) for g in grids.values())

        def need_total(nu: float) -> float:
            t = 0.0
            for n in ns:
                d = _grid_min_d(*grids[n], nu)
                t += max_shed[n] if d == float("inf") else d
            return t

        # smallest nu whose total need fits within x (need decreasing in nu)
        nu = bisect_min_feasible(lambda v: need_total(v) <= x,
                                 nu_lo, nu_hi, max(tol, nu_hi * 1e-4),
                                 max_iter=40)
        alloc = {}
        for n in ns:
            d = _grid_min_d(*grids[n], nu)
            alloc[n] = max_shed[n] if d == float("inf") else d
        leftover = x - sum(alloc.values())
        if leftover > 0:
            room = {n: max(0.0, _grid_max_d(*grids[n], nu) - alloc[n])
                    for n in ns}
            r = sum(room.values())
            if r > 0:
                give = min(leftover, r)
                for n in ns:
                    alloc[n] += give * room[n] / r
        t_air = max(float(np.interp(alloc[n], grids[n][0], grids[n][1]))
                    for n in ns)
        return alloc, t_air

    lo, hi = 0.0, sum(max_shed.values())
    for _ in range(40):
        x = 0.5 * (lo + hi)
        _, t_air = distribute(x)
        if space_latency(total0 + x, sagin) >= t_air:
            hi = x   # satellite overloaded -> shed less to space
        else:
            lo = x   # satellite under-used -> shed more (eq. of Alg. 2)
    alloc, _ = distribute(0.5 * (lo + hi))
    clusters = [cluster_case2(sagin, n, alloc[n], tol) for n in ns]
    shed_total = sum(alloc.values())
    new_sat = float(sagin.n_sat_samples) + shed_total
    plan = OffloadPlan(case=2, clusters=clusters, new_sat_samples=new_sat,
                       space_latency=space_latency(new_sat, sagin),
                       round_latency=0.0, baseline_latency=baseline)
    plan.round_latency = evaluate_plan(sagin, plan)
    return plan


# ---------------------------------------------------------------------------
# Literal Algorithm 1 (pseudocode-faithful, for cross-validation) ------------
# ---------------------------------------------------------------------------
def algorithm1_literal(sagin: SAGIN, n: int, d_s2a: float,
                       eps1: float = 1e-2, eps2: float = 5e-2,
                       max_iter: int = 40) -> Dict[int, float]:
    """Algorithm 1 exactly as printed: outer bisection on Y_n, inner
    bisection on the per-device latency level, per-device bisection on
    |D_{n,k}^{A2G}|. Returns the air->ground allocation."""
    air = sagin.air_nodes[n]
    ks = sagin.clusters[n]
    recv_sat = lat.tx_time(sagin.q_bits * d_s2a, sagin.s2a_rate(n)) \
        if d_s2a > 0 else 0.0
    e_air = air.m / air.f
    own_air = lat.comp_time(air.m, air.n_samples, air.f)

    def tau_g(k: int, d: float) -> float:
        dev = sagin.devices[k]
        up = lat.model_upload_time(sagin.model_bits, sagin.g2a_rate(k, n))
        a = lat.comp_time(dev.m, dev.n_samples, dev.f)
        recv = recv_sat + sagin.q_bits * d / sagin.g2a_rate(k, n)
        return max(a, recv) + lat.comp_time(dev.m, d, dev.f) + up

    def tau_a(y: float) -> float:
        new_size = air.n_samples + d_s2a - y
        if new_size <= air.n_samples:
            return lat.comp_time(air.m, max(0.0, new_size), air.f)
        return max(own_air, recv_sat) + e_air * (d_s2a - y)

    max_y = air.n_samples + d_s2a
    nu_l1, nu_u1 = 0.0, max_y
    alloc = {k: 0.0 for k in ks}
    it = 0
    while nu_u1 - nu_l1 >= eps1 and it < max_iter:
        it += 1
        y_n = 0.5 * (nu_u1 + nu_l1)
        # inner: find per-device allocation summing to ~y_n
        lvl_lo, lvl_hi = 0.0, max(tau_g(k, max_y) for k in ks) if ks else 0.0
        inner = 0
        while inner < max_iter:
            inner += 1
            lvl = 0.5 * (lvl_lo + lvl_hi)
            for k in ks:
                d_lo, d_hi = 0.0, min(air.n_samples + d_s2a, y_n)
                for _ in range(40):
                    d_mid = 0.5 * (d_lo + d_hi)
                    if tau_g(k, d_mid) < lvl:
                        d_lo = d_mid
                    else:
                        d_hi = d_mid
                alloc[k] = d_lo
            s = sum(alloc.values())
            if s < (1 - eps2) * y_n:
                lvl_lo = lvl
            elif s > (1 + eps2) * y_n:
                lvl_hi = lvl
            else:
                break
        t_ground = max(tau_g(k, alloc[k]) for k in ks) if ks else 0.0
        if tau_a(sum(alloc.values())) >= t_ground:
            nu_l1 = y_n
        else:
            nu_u1 = y_n
    return alloc


def algorithm2_literal(sagin: SAGIN, eps1: float = 1e-2, eps2: float = 5e-2,
                       max_iter: int = 30) -> Dict[int, float]:
    """Algorithm 2 exactly as printed (Case I direction): outer bisection
    on nu_{L,1}/nu_{U,1} over the total amount X shed by the satellite,
    inner bisection on the latency level distributing X across air nodes,
    per-node bisection on |D_{S,n}^{S2A}| (via the cluster-level solve).
    Returns {n: d_s2a_n}. Used to cross-validate the grid-based fast path.
    """
    ns = list(sagin.clusters)
    total = float(sagin.n_sat_samples)
    nu_l1, nu_u1 = 0.0, total
    alloc = {n: 0.0 for n in ns}
    it = 0
    while nu_u1 - nu_l1 >= max(eps1, total * 1e-3) and it < max_iter:
        it += 1
        x = 0.5 * (nu_u1 + nu_l1)
        # inner: distribute x across air nodes at a common latency level
        lvl_lo = 0.0
        lvl_hi = max(cluster_case1(sagin, n, total, 1e-2).latency
                     for n in ns)
        inner = 0
        while inner < max_iter:
            inner += 1
            lvl = 0.5 * (lvl_lo + lvl_hi)
            for n in ns:
                d_lo, d_hi = 0.0, total
                for _ in range(25):
                    d_mid = 0.5 * (d_lo + d_hi)
                    if cluster_case1(sagin, n, d_mid, 1e-1).latency < lvl:
                        d_lo = d_mid
                    else:
                        d_hi = d_mid
                alloc[n] = d_lo
            sx = sum(alloc.values())
            if sx < (1 - eps2) * x:
                lvl_lo = lvl
            elif sx > (1 + eps2) * x:
                lvl_hi = lvl
            else:
                break
        t_space = space_latency(total - sum(alloc.values()), sagin)
        t_air = max(cluster_case1(sagin, n, alloc[n], 1e-1).latency
                    for n in ns)
        if t_space >= t_air:
            nu_l1 = x
        else:
            nu_u1 = x
    return alloc
