# Frozen copy of src/repro_torch/core/latency.py at commit ed1d7aa (unchanged but
# for this header): the NumPy control plane that the benchmark's
# reference replays to work out the dataset, partition, pools, plans and
# batches again, independently of the program under test.
"""Latency model of the paper: eqs. (5), (7)-(12), (14), (16)-(19).

Pure-Python/NumPy control-plane code (Remark 1: runs at the gateway).
All helpers take explicit scalars so the offloading optimizer can evaluate
candidate allocations cheaply.
"""
from __future__ import annotations

from typing import Sequence

from .network import SAGIN


# ---------------------------------------------------------------------------
# Elementary delays ----------------------------------------------------------
# ---------------------------------------------------------------------------
def comp_time(m: float, n_samples: float, f: float) -> float:
    """Local computation time m*|D|/f (eq. 5)."""
    return m * n_samples / f


def tx_time(bits: float, rate: float) -> float:
    """Transmission delay for ``bits`` over a link of ``rate`` bits/s."""
    return bits / rate


def model_upload_time(model_bits: float, rate: float) -> float:
    """eq. (14): tau^{G2A} = Q(w)/Z."""
    return model_bits / rate


def handover_delay(model_bits: float, q_bits: float, n_samples: float,
                   z_isl: float) -> float:
    """eq. (7): (Q(w) + q|D_S|)/Z_ISL."""
    return (model_bits + q_bits * n_samples) / z_isl


# ---------------------------------------------------------------------------
# Cross-region merge pricing over the ISL topology ---------------------------
# ---------------------------------------------------------------------------
MERGE_TOPOLOGIES = ("ring", "star")


def isl_path_hops(topology: str, src: int, dst: int, n_regions: int) -> int:
    """One-way ISL hops between the serving satellites of two regions.

    * ``"star"`` — every serving satellite has a direct ISL to every
      other (one aggregation plane): 1 hop between distinct regions.
    * ``"ring"`` — serving satellites form a ring in region order (the
      natural Walker-Star cross-plane layout): circular distance.
    """
    for label, idx in (("src", src), ("dst", dst)):
        if not 0 <= idx < n_regions:
            raise ValueError(f"{label}={idx} out of range for "
                             f"{n_regions} region(s)")
    if src == dst:
        return 0
    if topology == "star":
        return 1
    if topology == "ring":
        d = abs(src - dst)
        return min(d, n_regions - d)
    raise ValueError(f"unknown merge topology {topology!r}; "
                     f"expected one of {MERGE_TOPOLOGIES}")


def isl_merge_hops(topology: str, region_index: int, n_regions: int,
                   hub: int = 0) -> int:
    """ISL hops region ``region_index``'s model travels for one global
    merge: up to the aggregating satellite (the one serving region
    ``hub``) and back down with the merged model — twice the one-way
    :func:`isl_path_hops` distance; the hub region pays 0.
    """
    if not 0 <= region_index < n_regions:
        raise ValueError(f"region_index={region_index} out of range for "
                         f"{n_regions} region(s)")
    if n_regions <= 1:
        return 0
    return 2 * isl_path_hops(topology, region_index, hub % n_regions,
                             n_regions)


def global_merge_latency(model_bits: float, z_isl: float, topology: str,
                         region_index: int, n_regions: int,
                         hub: int = 0) -> float:
    """ISL price of one global merge for a region: eq. (7) with a
    model-only payload (no raw data rides along), once per hop."""
    hops = isl_merge_hops(topology, region_index, n_regions, hub=hub)
    return hops * tx_time(model_bits, z_isl)


# ---------------------------------------------------------------------------
# Space-layer latency with handover (eqs. 8-12) ------------------------------
# ---------------------------------------------------------------------------
def space_layer_latency(n_samples: float, sagin: SAGIN) -> float:
    """tau_S^{(r)}: latency for the space layer to process ``n_samples``.

    Walks the ordered list of covering satellites; each satellite processes
    until its coverage window T_i ends, then hands (model + remaining data)
    to the next satellite over the ISL (eq. 7). Faithful to eqs. (8)-(12).
    """
    from .handover import space_schedule
    return space_schedule(n_samples, sagin).total_latency


# ---------------------------------------------------------------------------
# Round latency without offloading (eqs. 16-17) ------------------------------
# ---------------------------------------------------------------------------
def air_cluster_latency_no_offload(sagin: SAGIN, n: int) -> float:
    """eq. (17): completion of air node n incl. its ground devices."""
    air = sagin.air_nodes[n]
    t_air = comp_time(air.m, air.n_samples, air.f)
    t_ground = 0.0
    for k in sagin.clusters[n]:
        dev = sagin.devices[k]
        t = (comp_time(dev.m, dev.n_samples, dev.f)
             + model_upload_time(sagin.model_bits, sagin.g2a_rate(k, n)))
        t_ground = max(t_ground, t)
    return max(t_air, t_ground)


def round_latency_no_offload(sagin: SAGIN) -> float:
    """eq. (16): overall round latency with the *current* datasets."""
    t_space = space_layer_latency(sagin.n_sat_samples, sagin)
    t_air = max(
        air_cluster_latency_no_offload(sagin, n)
        + model_upload_time(sagin.model_bits, sagin.a2s_rate(n))
        for n in sagin.clusters
    )
    return max(t_space, t_air)


# ---------------------------------------------------------------------------
# Post-offloading latencies, Case I (space -> air/ground), eqs. (21)-(25) ----
# ---------------------------------------------------------------------------
def case1_air_local_delay(sagin: SAGIN, n: int, d_s2a: float,
                          d_a2g: Sequence[float]) -> float:
    """eq. (24): air node n's local completion time under Case I."""
    air = sagin.air_nodes[n]
    sent = sum(d_a2g)
    new_size = air.n_samples + d_s2a - sent
    if new_size <= air.n_samples:
        return comp_time(air.m, new_size, air.f)
    recv_delay = tx_time(sagin.q_bits * d_s2a, sagin.s2a_rate(n))
    own = comp_time(air.m, air.n_samples, air.f)
    extra = comp_time(air.m, d_s2a - sent, air.f)
    return max(own, recv_delay) + extra


def case1_ground_local_delay(sagin: SAGIN, k: int, n: int, d_s2a: float,
                             d_a2g_k: float) -> float:
    """eq. (25): ground device k's completion time under Case I."""
    dev = sagin.devices[k]
    own = comp_time(dev.m, dev.n_samples, dev.f)
    recv = (tx_time(sagin.q_bits * d_s2a, sagin.s2a_rate(n))
            + tx_time(sagin.q_bits * d_a2g_k, sagin.g2a_rate(k, n)))
    extra = comp_time(dev.m, d_a2g_k, dev.f)
    return max(own, recv) + extra


# ---------------------------------------------------------------------------
# Post-offloading latencies, Case II (air/ground -> space), eqs. (30)-(34) ---
# ---------------------------------------------------------------------------
def case2_air_local_delay(sagin: SAGIN, n: int, d_a2s: float,
                          d_g2a: Sequence[float]) -> float:
    """eq. (33): air node n's completion time under Case II."""
    air = sagin.air_nodes[n]
    recv_total = sum(d_g2a)
    new_size = air.n_samples - d_a2s + recv_total
    send_delay = tx_time(sagin.q_bits * d_a2s, sagin.a2s_rate(n))
    if new_size <= air.n_samples:
        return max(comp_time(air.m, new_size, air.f), send_delay)
    ks = sagin.clusters[n]
    recv_delay = max(
        tx_time(sagin.q_bits * d, sagin.g2a_rate(k, n))
        for k, d in zip(ks, d_g2a)
    ) if ks else 0.0
    own = comp_time(air.m, air.n_samples, air.f)
    extra = comp_time(air.m, recv_total - d_a2s, air.f)
    return max(max(own, recv_delay) + extra, send_delay)


def case2_ground_local_delay(sagin: SAGIN, k: int, n: int,
                             d_g2a_k: float) -> float:
    """eq. (34): ground device k's completion time under Case II."""
    dev = sagin.devices[k]
    comp = comp_time(dev.m, dev.n_samples - d_g2a_k, dev.f)
    send = tx_time(sagin.q_bits * d_g2a_k, sagin.g2a_rate(k, n))
    return max(comp, send)


# ---------------------------------------------------------------------------
# Aggregate cluster/global latencies (eqs. 18-19) ----------------------------
# ---------------------------------------------------------------------------
def cluster_latency(sagin: SAGIN, n: int, air_local: float,
                    ground_locals: Sequence[float]) -> float:
    """eq. (19): max of air local delay and ground completion+upload."""
    t_ground = 0.0
    for k, t in zip(sagin.clusters[n], ground_locals):
        t_ground = max(t_ground,
                       t + model_upload_time(sagin.model_bits,
                                             sagin.g2a_rate(k, n)))
    return max(air_local, t_ground)


def round_latency(sagin: SAGIN, space_latency: float,
                  cluster_latencies: Sequence[float]) -> float:
    """eq. (18): overall post-offloading round latency."""
    t_air = max(
        t + model_upload_time(sagin.model_bits, sagin.a2s_rate(n))
        for n, t in zip(sagin.clusters, cluster_latencies)
    )
    return max(space_latency, t_air)
