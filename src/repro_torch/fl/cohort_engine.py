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

The mesh-sharded path and the ``no_recompile`` guard wait for the
multi-GPU slice and the tooling slice (ROADMAP).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.pipeline import BucketedCohort, build_bucketed_cohort
from ..device import resolve_device
from .aggregation import fedavg_stacked_multi
from .client import cohort_local_update

SHARDING_MODES = ("auto", "off")


@dataclasses.dataclass
class CohortEngineStats:
    """Cumulative counters over an engine's lifetime (all rounds)."""
    rounds: int = 0
    bucket_dispatches: int = 0
    compiled_signatures: int = 0   # distinct bucket shapes seen so far
    real_elements: int = 0         # batch elements actually drawn
    layout_elements: int = 0       # batch elements the padded layout ran

    @property
    def padding_ratio(self) -> float:
        """layout / real batch elements — padded-FLOPs overhead factor."""
        return (self.layout_elements / self.real_elements
                if self.real_elements else 1.0)


def cohort_tensors(cb, device: torch.device):
    """One bucket's host arrays as device tensors: (xs, ys, mask)."""
    return (torch.from_numpy(cb.xs).to(device),
            torch.from_numpy(cb.ys).to(device=device, dtype=torch.int64),
            torch.from_numpy(cb.mask).to(device))


class CohortEngine:
    """Executes FL rounds over size-bucketed cohorts on one device.

    One engine instance per FL job (``RegionTrainer`` owns one); the
    instance carries the signature bookkeeping and counters across
    rounds.
    """

    def __init__(self, apply_fn: Callable, batch_align: int = 32,
                 client_align: int = 4, device="cuda", tracer=None,
                 sharding: str = "auto"):
        from ..obs import NULL_TRACER
        if sharding not in SHARDING_MODES:
            raise ValueError(
                f"sharding={sharding!r} not in {SHARDING_MODES}: the "
                f"mesh-sharded cohort path waits for the multi-GPU slice "
                f"(ROADMAP)")
        self.apply_fn = apply_fn
        self.device = resolve_device(device)
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.batch_align = max(1, int(batch_align))
        self.client_align = max(1, int(client_align))
        self.sharding = sharding
        self.signatures: set = set()
        self.round_signatures: set = set()
        self.stats = CohortEngineStats()

    # -- cohort construction ------------------------------------------------
    def build(self, x: np.ndarray, y: np.ndarray,
              pools: Sequence[np.ndarray], n_steps: int,
              rng: np.random.Generator, max_batch: int
              ) -> Optional[BucketedCohort]:
        """Plan + materialize this round's bucketed cohort (host side)."""
        return build_bucketed_cohort(x, y, pools, n_steps, rng,
                                     max_batch=max_batch,
                                     batch_align=self.batch_align,
                                     client_align=self.client_align)

    # -- execution ----------------------------------------------------------
    @staticmethod
    def _bucket_signature(cb) -> tuple:
        return cb.xs.shape + (str(cb.xs.dtype),)

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

    def round(self, params, cohort: BucketedCohort, lr: float,
              total: int) -> Tuple[object, List[float]]:
        """Train every bucket and aggregate — one FL round on device.

        Returns ``(new_global_params, losses)`` with ``losses`` the real
        clients' mean local losses in canonical cohort order.
        """
        tr = self.tracer
        if tr.enabled:
            # new layouts = bucket shapes not seen before (the reference
            # counts these as recompiles; the name is kept for its report)
            fresh = sum(1 for cb in cohort.buckets
                        if self._bucket_signature(cb)
                        not in self.signatures)
            m = tr.metrics
            m.counter("cohort.recompiled_signatures").inc(fresh)
            m.counter("cohort.bucket_dispatches").inc(len(cohort.buckets))
            m.counter("cohort.real_elements").inc(cohort.real_elements)
            m.counter("cohort.layout_elements").inc(cohort.layout_elements)
        self._record(cohort)
        if tr.enabled:
            tr.metrics.gauge("cohort.padding_ratio").set(
                self.stats.padding_ratio)
        return self._execute(params, cohort, lr, total)

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
        tr.span("bucket_dispatch", f"C{c}xH{h}xB{b}",
                dur_wall=time.perf_counter() - t0, clients=c,
                batch_width=b, real=int(np.count_nonzero(cb.mask)),
                layout=int(cb.mask.size), mesh_shape=[1])
        tr.metrics.histogram("cohort.dispatch_wall_s").observe(
            time.perf_counter() - t0)

    def _execute(self, params, cohort: BucketedCohort, lr: float,
                 total: int) -> Tuple[object, List[float]]:
        trace = self.tracer.enabled
        # eq.-(13) weights over the concatenated client axis, bucket
        # order; padding clients hold size 0 and therefore weight 0
        w = np.concatenate([cb.sizes for cb in cohort.buckets])
        weights = torch.from_numpy(
            (w / max(1, total)).astype(np.float32)).to(self.device)
        stacked_parts, loss_parts = [], []
        for cb in cohort.buckets:
            t0 = time.perf_counter() if trace else 0.0
            xs, ys, mask = cohort_tensors(cb, self.device)
            stacked, losses = cohort_local_update(self.apply_fn, params,
                                                  xs, ys, mask, lr)
            if trace:
                self._trace_dispatch(cb, t0)
            stacked_parts.append(stacked)
            loss_parts.append(losses)
        new_params = fedavg_stacked_multi(stacked_parts, weights)
        return new_params, self._scatter_losses(cohort, loss_parts)

    @staticmethod
    def _scatter_losses(cohort: BucketedCohort,
                        loss_parts: List) -> List[float]:
        """Map per-bucket loss vectors back to canonical client order."""
        out = np.zeros(cohort.n_clients, dtype=np.float64)
        for plan, losses in zip(cohort.plans, loss_parts):
            vals = losses.detach().cpu().numpy()[:len(plan.members)]
            out[list(plan.members)] = vals
        return [float(v) for v in out]
