"""Size-bucketed, device-resident cohort execution engine.

Under the paper's adaptive offloading the pools are skewed, so padding
every client to the round's largest batch wastes most of the cohort
tensor on masked slots.  :class:`CohortEngine` uses the geometric width
buckets of :func:`repro_torch.data.pipeline.build_bucketed_cohort`:

* one ``cohort_local_update`` per OCCUPIED bucket (clients padded only
  to their own bucket's width);
* ONE eq.-(13) aggregate over the union of all buckets' stacked params
  (:func:`repro_torch.fl.aggregation.fedavg_stacked_multi`, which runs
  the Hopper ``fedavg_agg`` kernel on the card) — parameters never
  round-trip through the host between local update and aggregation;
* bucket-signature bookkeeping keyed on ``(C_bucket, H, B_bucket,
  sample_shape, dtype)``: both bucket axes are quantized to geometric
  grids, so churn and offloading drift land on signatures already seen.
  PyTorch runs eagerly and compiles nothing per shape, so the signatures
  here are statistics of the layout, not a compilation cache.

The reference's fused single-bucket program with a donated params buffer
has no counterpart: every round is the bucket updates followed by one
aggregate.  In place of donation, the local update overwrites its own
client stack from the second SGD step on (``cohort_local_update``); the
global params are never written in place, so a caller may keep them.

With ``guard=True`` every warm round (each of its bucket signatures
seen before) runs under
:func:`repro_torch.analysis.contracts.no_recompile`: a kernel library
built or loaded, or a ``torch.compile`` graph, on the warm path raises
``ContractViolation`` instead of passing unseen.

Mesh-sharded mode (``sharding="mesh"``, or ``"auto"`` when a
``torch.distributed`` process group of more than one rank is up) shards
every bucket's CLIENT axis over the ``data`` axis of a ``DeviceMesh``
(one process a shard, SPMD): every rank builds the same host-side cohort
from the same seeds (the planner pads each bucket's client count to a
multiple of the shard count: ``client_multiple``), copies only its own
block of each bucket (rank ``i`` of ``n`` takes clients ``[i c/n, (i+1)
c/n)`` of a bucket of ``c``) to its device, runs ``cohort_local_update``
on it, reduces every bucket's block in ONE ``fedavg_agg`` launch with
the weights normalized over the whole round on the host, and joins the
other shards in one all-reduce
(:func:`~repro_torch.fl.aggregation.shard_weighted_aggregate_multi`);
the losses come back to every rank by a second all-reduce of a
zero-padded vector (an all-gather in effect: each rank writes its own
blocks, zeros elsewhere, and a sum with zeros is exact).  Bucket
signatures carry the shard count.  With one shard (no group, a group of
one, or a 1-rank mesh) the engine runs the exact single-device code
path: bit-identical to ``sharding="off"``.  A faulted or quarantined
round takes the single-device path too, on every rank over the whole
cohort (the reference's trade: chaos rounds are rare, and correctness
beats throughput under faults), so every rank ends the round with the
same model.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..analysis import contracts
from ..data.pipeline import BucketedCohort, build_bucketed_cohort
from ..device import resolve_device
from ..launch.mesh import group_size, make_cohort_mesh
from ..sharding.specs import data_axis_size
from ..tree import tree_leaves
from .aggregation import (client_finite_mask, fedavg_stacked_multi,
                          shard_weighted_aggregate_multi)
from .client import cohort_local_update

SHARDING_MODES = ("auto", "mesh", "off")


@dataclasses.dataclass
class CohortEngineStats:
    """Cumulative counters over an engine's lifetime (all rounds)."""
    rounds: int = 0
    bucket_dispatches: int = 0
    compiled_signatures: int = 0   # distinct bucket shapes seen so far
    real_elements: int = 0         # batch elements actually drawn
    layout_elements: int = 0       # batch elements the padded layout ran
    # mesh-sharded path only (all zero / 1.0 on a 1-shard engine):
    sharded_dispatches: int = 0    # bucket dispatches split over shards
    shard_pad_clients: int = 0     # padding client slots in sharded layouts
    last_shard_imbalance: float = 1.0  # max/mean real elements per shard
    max_shard_imbalance: float = 1.0   # worst round so far

    @property
    def padding_ratio(self) -> float:
        """layout / real batch elements — padded-FLOPs overhead factor."""
        return (self.layout_elements / self.real_elements
                if self.real_elements else 1.0)


def cohort_tensors(cb, device: torch.device, rows=slice(None)):
    """One bucket's host arrays (its clients ``rows``) as device tensors:
    (xs, ys, mask)."""
    return (torch.from_numpy(cb.xs[rows]).to(device),
            torch.from_numpy(cb.ys[rows]).to(device=device,
                                             dtype=torch.int64),
            torch.from_numpy(cb.mask[rows]).to(device))


class CohortEngine:
    """Executes FL rounds over size-bucketed cohorts, on one device or
    client-sharded over the ranks of a mesh (module docstring).

    One engine instance per FL job (``RegionTrainer`` owns one); the
    instance carries the signature bookkeeping and counters across
    rounds, and with ``guard`` holds every warm round to
    ``no_recompile``.
    """

    def __init__(self, apply_fn: Callable, batch_align: int = 32,
                 client_align: int = 4, device="cuda", tracer=None,
                 sharding: str = "auto", guard: bool = False, mesh=None):
        from ..obs import NULL_TRACER
        if sharding not in SHARDING_MODES:
            raise ValueError(f"sharding={sharding!r} not in "
                             f"{SHARDING_MODES}")
        self.apply_fn = apply_fn
        self.device = resolve_device(device)
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.batch_align = max(1, int(batch_align))
        self.client_align = max(1, int(client_align))
        self.sharding = sharding
        self.guard = bool(guard)
        # client-axis sharding: "off" never shards; "mesh" shards over the
        # given mesh, or over all ranks of the process group when one is
        # up (without one it is a world of 1); "auto" shards only when a
        # group of more than one rank is up
        group_up = dist.is_available() and dist.is_initialized()
        if sharding == "off":
            mesh = None
        elif mesh is None and group_up and (sharding == "mesh"
                                            or group_size() > 1):
            mesh = make_cohort_mesh(device=self.device)
        if mesh is not None and mesh.get_coordinate() is None:
            raise ValueError(f"rank {dist.get_rank()} is not in the mesh "
                             f"{mesh}")
        self.mesh = mesh
        # client-axis shards a bucket splits into; 1 (including any
        # 1-rank mesh) runs the exact single-device code path
        self.shards = data_axis_size(mesh)
        self.signatures: set = set()
        self.round_signatures: set = set()
        self.stats = CohortEngineStats()
        self.last_quarantined = 0

    # -- cohort construction ------------------------------------------------
    def build(self, x: np.ndarray, y: np.ndarray,
              pools: Sequence[np.ndarray], n_steps: int,
              rng: np.random.Generator, max_batch: int
              ) -> Optional[BucketedCohort]:
        """Plan + materialize this round's bucketed cohort (host side).

        On a sharded engine the planner additionally pads every bucket's
        client axis to a multiple of the shard count, so it splits over
        the shards without a remainder."""
        return build_bucketed_cohort(x, y, pools, n_steps, rng,
                                     max_batch=max_batch,
                                     batch_align=self.batch_align,
                                     client_align=self.client_align,
                                     client_multiple=self.shards)

    # -- execution ----------------------------------------------------------
    def _bucket_signature(self, cb) -> tuple:
        """One bucket dispatch's layout: shape and dtype ⊕ the shard
        count (the same layout splits differently on another mesh)."""
        return cb.xs.shape + (str(cb.xs.dtype), self.shards)

    def _round_signature(self, cohort: BucketedCohort) -> tuple:
        return tuple(self._bucket_signature(cb) for cb in cohort.buckets)

    def _record(self, cohort: BucketedCohort):
        for cb in cohort.buckets:
            self.signatures.add(self._bucket_signature(cb))
        self.round_signatures.add(self._round_signature(cohort))
        st = self.stats
        st.rounds += 1
        st.bucket_dispatches += len(cohort.buckets)
        st.compiled_signatures = len(self.signatures)
        st.real_elements += cohort.real_elements
        st.layout_elements += cohort.layout_elements
        if self.shards > 1:
            st.sharded_dispatches += len(cohort.buckets)
            st.shard_pad_clients += sum(
                cb.xs.shape[0] - len(plan.members)
                for cb, plan in zip(cohort.buckets, cohort.plans))
            per = self._shard_real_elements(cohort)
            imb = (float(per.max() * self.shards / per.sum())
                   if per.sum() else 1.0)
            st.last_shard_imbalance = imb
            st.max_shard_imbalance = max(st.max_shard_imbalance, imb)
            if self.tracer.enabled:
                self.tracer.metrics.histogram(
                    "cohort.shard_imbalance").observe(imb)
                self.tracer.metrics.gauge(
                    "cohort.shard_pad_clients").set(st.shard_pad_clients)

    def _shard_real_elements(self, cohort: BucketedCohort) -> np.ndarray:
        """Real (unmasked) batch elements each shard executes this round.

        Every bucket's client axis splits into ``self.shards`` contiguous
        blocks; padding clients sit at the tail, so the trailing shards
        run the masked slack.
        """
        per = np.zeros(self.shards, dtype=np.int64)
        for cb in cohort.buckets:
            per += self._bucket_shard_real(cb)
        return per

    def _bucket_shard_real(self, cb) -> np.ndarray:
        c = cb.mask.shape[0]
        per_client = cb.mask.reshape(c, -1).sum(axis=1)
        return per_client.reshape(self.shards, c // self.shards).sum(
            axis=1).astype(np.int64)

    def round(self, params, cohort: BucketedCohort, lr: float,
              total: int, corrupt: Sequence[int] = (),
              quarantine: bool = False) -> Tuple[object, List[float]]:
        """Train every bucket and aggregate — one FL round on device.

        Returns ``(new_global_params, losses)`` with ``losses`` the real
        clients' mean local losses in canonical cohort order.

        ``corrupt`` (fault injection: canonical client positions whose
        trained models are NaN-filled AFTER the local update — RNG
        streams untouched) and ``quarantine`` (drop non-finite client
        updates before aggregation, renormalizing the eq.-(13) weights
        over the survivors; the drop count lands in
        :attr:`last_quarantined`).  A round whose every update was
        dropped keeps the previous global model.

        With ``self.guard``, a round whose every bucket signature is
        already in :attr:`signatures` runs under
        ``contracts.no_recompile(label="CohortEngine.round")``.

        On a sharded engine a clean round runs :meth:`_execute_sharded`;
        ``corrupt`` or ``quarantine`` send the round down the
        single-device path on every rank (module docstring).
        """
        tr = self.tracer
        self.last_quarantined = 0
        # new layouts = bucket shapes not seen before (the reference
        # counts these as recompiles; the name is kept for its report)
        fresh = sum(1 for cb in cohort.buckets
                    if self._bucket_signature(cb) not in self.signatures)
        warm = self.guard and not fresh
        if tr.enabled:
            m = tr.metrics
            m.counter("cohort.recompiled_signatures").inc(fresh)
            m.counter("cohort.bucket_dispatches").inc(len(cohort.buckets))
            m.counter("cohort.real_elements").inc(cohort.real_elements)
            m.counter("cohort.layout_elements").inc(cohort.layout_elements)
        self._record(cohort)
        if tr.enabled:
            tr.metrics.gauge("cohort.padding_ratio").set(
                self.stats.padding_ratio)
        if self.shards > 1 and not (corrupt or quarantine):
            def execute():
                return self._execute_sharded(params, cohort, lr)
        else:
            def execute():
                return self._execute(params, cohort, lr, total,
                                     corrupt=corrupt, quarantine=quarantine)
        if warm:
            with contracts.no_recompile(label="CohortEngine.round"):
                return execute()
        return execute()

    def _trace_dispatch(self, cb, t0: float):
        """Emit one ``bucket_dispatch`` span (enabled tracer only).

        ``dur_wall`` is host dispatch time; with
        ``ObsConfig.device_timing`` the device is synchronized first, so
        it is true device time (changes performance, never values).
        """
        tr = self.tracer
        if tr.device_timing and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        c, h, b = cb.xs.shape[0], cb.xs.shape[1], cb.xs.shape[2]
        attrs = dict(clients=c, batch_width=b,
                     real=int(np.count_nonzero(cb.mask)),
                     layout=int(cb.mask.size), mesh_shape=[self.shards])
        if self.shards > 1:
            # per-shard real elements of THIS bucket: shard i runs
            # clients [i*c/n, (i+1)*c/n) — the report's per-shard
            # dispatch-time breakdown apportions dur_wall by these
            attrs["shard_real"] = [int(v)
                                   for v in self._bucket_shard_real(cb)]
        tr.span("bucket_dispatch", f"C{c}xH{h}xB{b}",
                dur_wall=time.perf_counter() - t0, **attrs)
        tr.metrics.histogram("cohort.dispatch_wall_s").observe(
            time.perf_counter() - t0)

    def _execute(self, params, cohort: BucketedCohort, lr: float,
                 total: int, corrupt: Sequence[int] = (),
                 quarantine: bool = False) -> Tuple[object, List[float]]:
        trace = self.tracer.enabled
        corrupt = set(corrupt)
        # eq.-(13) weights over the concatenated client axis, bucket
        # order; padding clients hold size 0 and therefore weight 0
        w = np.concatenate([cb.sizes for cb in cohort.buckets])
        weights = (w / max(1, total)).astype(np.float32)
        stacked_parts, loss_parts = [], []
        for bi, cb in enumerate(cohort.buckets):
            t0 = time.perf_counter() if trace else 0.0
            xs, ys, mask = cohort_tensors(cb, self.device)
            stacked, losses = cohort_local_update(self.apply_fn, params,
                                                  xs, ys, mask, lr)
            if trace:
                self._trace_dispatch(cb, t0)
            # fault injection: NaN-fill the victims' trained models AFTER
            # the update (the stack is this round's own) — every RNG draw
            # is the one the clean run makes
            for row, m in enumerate(cohort.plans[bi].members):
                if m in corrupt:
                    for leaf in tree_leaves(stacked):
                        leaf[row] = float("nan")
                    losses[row] = float("nan")
            stacked_parts.append(stacked)
            loss_parts.append(losses)
        dropped: List[int] = []
        if quarantine:
            weights, dropped = self._quarantine(cohort, stacked_parts,
                                                weights)
            self.last_quarantined = len(dropped)
        if quarantine and weights.sum() <= 0:
            # every real update was non-finite: keep the previous model
            new_params = params
        else:
            new_params = fedavg_stacked_multi(
                stacked_parts, torch.from_numpy(weights).to(self.device))
        losses = self._scatter_losses(cohort, loss_parts)
        if dropped:
            bad = set(dropped)
            losses = [v for i, v in enumerate(losses) if i not in bad]
        return new_params, losses

    @staticmethod
    def _quarantine(cohort: BucketedCohort, stacked_parts: List,
                    weights: np.ndarray) -> Tuple[np.ndarray, List[int]]:
        """Drop every non-finite client update from the aggregate.

        One :func:`client_finite_mask` reduction per bucket.  A dropped
        client's weight becomes 0, and its rows of the stack (this
        round's own) become 0 too: a weight of 0 alone would still carry
        its NaN into the weighted sum (0 * NaN = NaN).  The zeroed
        weights renormalize inside the aggregate (it divides by the
        weight sum), so the eq.-(13) mass redistributes over the finite
        survivors.  Returns the adjusted weights and the quarantined
        clients' canonical positions.
        """
        w = np.array(weights, copy=True)
        dropped: List[int] = []
        off = 0
        for cb, stacked, plan in zip(cohort.buckets, stacked_parts,
                                     cohort.plans):
            finite = client_finite_mask(stacked).cpu().numpy()
            for row in np.nonzero(~finite)[0]:
                for leaf in tree_leaves(stacked):
                    leaf[row] = 0.0
                if row < len(plan.members):  # real client (not padding)
                    w[off + row] = 0.0
                    dropped.append(int(plan.members[row]))
            off += cb.xs.shape[0]
        return w, dropped

    # -- mesh-sharded execution ---------------------------------------------
    def _execute_sharded(self, params, cohort: BucketedCohort, lr: float
                         ) -> Tuple[object, List[float]]:
        """This rank's block of every bucket: local updates, one
        ``fedavg_agg`` launch over all the blocks with the round's
        globally normalized weights, one all-reduce of the model and one
        of the losses.  The model is replicated on every rank before and
        after."""
        trace = self.tracer.enabled
        n = self.shards
        i = self.mesh.get_local_rank("data")
        w = np.concatenate([cb.sizes for cb in cohort.buckets]).astype(
            np.float64)
        weights = (w / max(1.0, w.sum())).astype(np.float32)
        parts, loss_parts, shard_w = [], [], []
        off = 0
        for cb in cohort.buckets:
            c = cb.xs.shape[0]
            rows = slice(i * c // n, (i + 1) * c // n)
            t0 = time.perf_counter() if trace else 0.0
            xs, ys, mask = cohort_tensors(cb, self.device, rows)
            stacked, losses = cohort_local_update(self.apply_fn, params,
                                                  xs, ys, mask, lr)
            if trace:
                self._trace_dispatch(cb, t0)
            parts.append(stacked)
            loss_parts.append(losses)
            shard_w.append(weights[off + rows.start:off + rows.stop])
            off += c
        new_params = shard_weighted_aggregate_multi(
            parts, torch.from_numpy(np.concatenate(shard_w)).to(
                self.device), ("data",), self.mesh)
        return new_params, self._scatter_losses(
            cohort, self._gather_losses(cohort, loss_parts))

    def _gather_losses(self, cohort: BucketedCohort, loss_parts: List
                       ) -> List[torch.Tensor]:
        """Every bucket's whole loss vector on every rank, from each
        rank's block: an all-reduce of a zero-padded vector."""
        n = self.shards
        i = self.mesh.get_local_rank("data")
        sizes = [cb.xs.shape[0] for cb in cohort.buckets]
        full = torch.zeros(sum(sizes), dtype=torch.float32,
                           device=self.device)
        off = 0
        for c, losses in zip(sizes, loss_parts):
            full[off + i * c // n:off + (i + 1) * c // n] = losses
            off += c
        dist.all_reduce(full, group=self.mesh.get_group("data"))
        return list(torch.split(full, sizes))

    @staticmethod
    def _scatter_losses(cohort: BucketedCohort,
                        loss_parts: List) -> List[float]:
        """Map per-bucket loss vectors back to canonical client order."""
        out = np.zeros(cohort.n_clients, dtype=np.float64)
        for plan, losses in zip(cohort.plans, loss_parts):
            vals = losses.detach().cpu().numpy()[:len(plan.members)]
            out[list(plan.members)] = vals
        return [float(v) for v in out]
