# Frozen copy of src/repro_torch/data/pipeline.py at commit ed1d7aa (unchanged but
# for this header): the NumPy control plane that the benchmark's
# reference replays to work out the dataset, partition, pools, plans and
# batches again, independently of the program under test.
"""Host-side batching pipeline for FL training and the big-model trainer.

Two entry points feed the FL round driver:

* ``batch_for_local_steps`` — per-node (H, B) batch stacks, used by the
  sequential execution path (one dispatch per node).
* ``build_cohort`` — the batched path's cohort builder: it gathers every
  data-holding node's (H, B) stack into ONE padded ``(C, H, Bmax, ...)``
  tensor plus a per-client validity mask and per-client pool sizes, so a
  single vmapped+jitted local-update step can train the whole cohort.
  Batches are drawn through ``batch_for_local_steps`` with the same RNG
  stream and call order as the sequential loop, which is what makes the
  two execution modes numerically equivalent at equal seeds.
* ``build_bucketed_cohort`` — the size-bucketed planner on top of the
  same batch draw: clients are partitioned by per-client batch width
  into geometric buckets (powers of two times ``batch_align``), each
  bucket padded only to ITS OWN width, so padded FLOPs are bounded by a
  constant factor of real FLOPs instead of growing with pool skew as
  the global-``Bmax`` layout does.  Bucket client counts are quantized
  geometrically too (powers of two, floored at ``client_align``), which
  keeps the set of compiled-step signatures tiny and drift-stable.  In
  shard-aware mode (``client_multiple`` = the mesh's ``data`` axis
  size) the client grid additionally divides evenly across mesh shards
  so buckets can dispatch through ``shard_map`` without a remainder
  shard, and a final collapse pass folds dispatch-bound small cohorts
  back into a single bucket.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterator, List, Sequence, Tuple

import numpy as np


class BatchIterator:
    """Infinite shuffled mini-batch iterator over an index pool."""

    def __init__(self, x: np.ndarray, y: np.ndarray, indices: np.ndarray,
                 batch_size: int, seed: int = 0):
        self.x, self.y = x, y
        self.indices = np.asarray(indices)
        self.batch_size = max(1, int(batch_size))
        self._rng = np.random.default_rng(seed)
        self._order = self._rng.permutation(len(self.indices))
        self._pos = 0

    def __iter__(self) -> "BatchIterator":
        return self

    def __next__(self) -> Tuple[np.ndarray, np.ndarray]:
        if len(self.indices) == 0:
            raise StopIteration
        if self._pos + self.batch_size > len(self._order):
            self._order = self._rng.permutation(len(self.indices))
            self._pos = 0
        sel = self.indices[self._order[self._pos:self._pos + self.batch_size]]
        self._pos += self.batch_size
        return self.x[sel], self.y[sel]


def batch_width_for_pool(n_samples: int, n_steps: int,
                         max_batch: int = 64) -> int:
    """The per-step batch width B that ``batch_for_local_steps`` draws
    for a pool of ``n_samples`` (paper: |D|/H per batch at the
    satellite, capped for memory on ground devices but letting big
    post-offloading pools use proportionally bigger batches so their
    lambda-weighted gradients are not noise-dominated).  Exposed so
    planners and benchmarks can size layouts without materializing any
    batches; 0 for an empty pool."""
    if n_samples <= 0:
        return 0
    b = int(np.ceil(n_samples / n_steps))
    eff_cap = int(np.clip(max(max_batch, n_samples // (4 * n_steps)),
                          max_batch, 8 * max_batch))
    return int(np.clip(b, 1, eff_cap))


def batch_for_local_steps(x: np.ndarray, y: np.ndarray, indices: np.ndarray,
                          n_steps: int, rng: np.random.Generator,
                          max_batch: int = 64):
    """Split a node's pool into H mini-batches (sizing rule in
    ``batch_width_for_pool``). Returns stacked arrays of shape
    (H, B, ...) padded by resampling when the pool is small."""
    indices = np.asarray(indices)
    if len(indices) == 0:
        return None
    b = batch_width_for_pool(len(indices), n_steps, max_batch)
    order = rng.permutation(indices)
    need = n_steps * b
    reps = int(np.ceil(need / len(order)))
    pool = np.concatenate([rng.permutation(indices) for _ in range(reps)])
    sel = pool[:need].reshape(n_steps, b)
    return x[sel], y[sel]


@dataclasses.dataclass
class CohortBatch:
    """A full round's worth of client batches, padded and masked.

    ``xs[c, h, :sizes-derived-B_c]`` are client ``c``'s real samples for
    local step ``h``; slots beyond that (and whole clients beyond
    ``n_clients``, when the cohort is padded to a fixed width) are zero
    and carry ``mask == 0`` so they contribute nothing to loss, gradient,
    or aggregation.
    """
    xs: np.ndarray        # (C, H, Bmax, ...) float
    ys: np.ndarray        # (C, H, Bmax) int
    mask: np.ndarray      # (C, H, Bmax) float32; 1.0 = real sample
    sizes: np.ndarray     # (C,) int pool size per client; 0 = padding client

    @property
    def n_clients(self) -> int:
        """Number of real (data-holding) clients in the cohort."""
        return int(np.sum(self.sizes > 0))

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.xs.shape


def _draw_client_batches(x: np.ndarray, y: np.ndarray,
                         pools: Sequence[np.ndarray], n_steps: int,
                         rng: np.random.Generator, max_batch: int):
    """Draw every non-empty pool's (H, B_c) batch stack in canonical pool
    order — the ONE place both cohort builders consume the round RNG, so
    bucketed, global-Bmax and sequential execution see identical samples
    at equal seeds."""
    per_client: List[Tuple[np.ndarray, np.ndarray]] = []
    sizes: List[int] = []
    for idx in pools:
        idx = np.asarray(idx)
        if len(idx) == 0:
            continue
        out = batch_for_local_steps(x, y, idx, n_steps, rng,
                                    max_batch=max_batch)
        per_client.append(out)
        sizes.append(len(idx))
    return per_client, sizes


def build_cohort(x: np.ndarray, y: np.ndarray,
                 pools: Sequence[np.ndarray], n_steps: int,
                 rng: np.random.Generator, max_batch: int = 64,
                 pad_clients: int = 0,
                 batch_align: int = 32) -> "CohortBatch | None":
    """Gather heterogeneous node pools into one (C, H, Bmax, ...) cohort.

    Each non-empty pool is batched via ``batch_for_local_steps`` (same RNG
    stream and call order as the sequential driver, so both execution
    modes see identical samples), then right-padded along the batch axis
    to a common ``Bmax``. ``Bmax`` is rounded up to a multiple of
    ``batch_align`` and the client axis is optionally padded up to
    ``pad_clients`` zero-weight dummies — both quantize the compiled
    cohort step's shapes so that pool drift only forces a recompile when
    the round's largest per-client batch crosses an alignment bucket.
    Note ``Bmax`` is global: every client is padded to the widest
    client's batch, which is wasteful when pool sizes are heavily
    skewed.
    """
    per_client, sizes = _draw_client_batches(x, y, pools, n_steps, rng,
                                             max_batch)
    if not per_client:
        return None

    b_max = max(bx.shape[1] for bx, _ in per_client)
    align = max(1, int(batch_align))
    b_max = int(np.ceil(b_max / align) * align)
    c = max(len(per_client), int(pad_clients))

    sample_shape = x.shape[1:]
    xs = np.zeros((c, n_steps, b_max) + sample_shape, dtype=x.dtype)
    ys = np.zeros((c, n_steps, b_max), dtype=y.dtype)
    mask = np.zeros((c, n_steps, b_max), dtype=np.float32)
    for ci, (bx, by) in enumerate(per_client):
        b = bx.shape[1]
        xs[ci, :, :b] = bx
        ys[ci, :, :b] = by
        mask[ci, :, :b] = 1.0
    out_sizes = np.zeros(c, dtype=np.int64)
    out_sizes[:len(sizes)] = sizes
    return CohortBatch(xs=xs, ys=ys, mask=mask, sizes=out_sizes)


# ---------------------------------------------------------------------------
# Size-bucketed cohorts ------------------------------------------------------
# ---------------------------------------------------------------------------
def next_geometric(value: int, align: int) -> int:
    """Smallest ``align * 2**k >= value`` (the geometric bucket grid)."""
    b = max(1, int(align))
    value = int(value)
    while b < value:
        b *= 2
    return b


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """One width bucket of the partition produced by :func:`plan_buckets`.

    ``members`` are positions into the canonical real-client order
    (ground 0..K-1, air, satellite — the order both execution modes
    share); the bucket's cohort tensor is padded to ``(c_bucket, H,
    b_bucket, ...)``.
    """
    b_bucket: int               # padded batch width (align * 2^k)
    c_bucket: int               # padded client count (>= len(members))
    members: Tuple[int, ...]    # canonical-order client positions


def plan_buckets(widths: Sequence[int], batch_align: int = 32,
                 client_align: int = 4,
                 merge_slack: float = 1.25,
                 client_multiple: int = 1,
                 collapse_slack: float = 1.5) -> List[BucketPlan]:
    """Partition clients into geometric batch-width buckets.

    Every client lands in the bucket whose width is the smallest
    ``batch_align * 2**k`` covering its batch; within a bucket the batch
    padding is therefore < 2x for any client wider than ``batch_align``
    (and bounded by ``batch_align`` absolutely for narrower ones).  The
    client axis of each bucket is quantized to the same geometric grid
    (``client_align * 2**k``) so pool-size drift between rounds re-uses
    previously compiled step signatures instead of forcing a recompile
    per distinct client count.

    ``client_multiple`` is the shard-aware planner mode: every
    ``c_bucket`` must also be divisible by it (the mesh's ``data`` axis
    size), so a bucket's client axis splits evenly across shards.  The
    client grid becomes ``lcm(client_align, client_multiple) * 2**k`` —
    still geometric, so drift-stability of compiled signatures is
    preserved.

    A greedy coalescing pass then merges a bucket into the next-wider
    one whenever the joint layout costs at most ``merge_slack`` times
    the separate layouts: near-uniform pools collapse back to a single
    dispatch (bucketing must not tax the regime the global layout
    already handles well), while skewed pools — where merging would
    multiply the padding — stay split.  The constant-factor padding
    bound only weakens by ``merge_slack``.

    Finally, when the whole cohort laid out as ONE bucket (every client
    padded to the widest bucket) costs at most ``collapse_slack`` times
    the multi-bucket layout, the plan collapses to that single bucket:
    small cohorts are dispatch-bound, not padding-bound, and paying a
    bounded padding premium to halve the dispatch count is a win there
    (the uniform C=16 regime regressed to 0.62x of the global layout
    before this pass).  ``collapse_slack <= 0`` disables the pass.
    """
    groups: dict = {}
    for pos, w in enumerate(widths):
        groups.setdefault(next_geometric(w, batch_align), []).append(pos)
    align = math.lcm(max(1, int(client_align)), max(1, int(client_multiple)))

    def cost(members, b):
        return next_geometric(len(members), align) * b

    merged: List[Tuple[int, List[int]]] = []       # (b_bucket, members)
    for b in sorted(groups):
        if merged:
            b_prev, m_prev = merged[-1]
            joint = m_prev + groups[b]
            if cost(joint, b) <= merge_slack * (cost(m_prev, b_prev)
                                                + cost(groups[b], b)):
                merged[-1] = (b, joint)
                continue
        merged.append((b, list(groups[b])))

    if collapse_slack > 0 and len(merged) > 1:
        all_members = [p for _, m in merged for p in m]
        b_top = merged[-1][0]
        if cost(all_members, b_top) <= collapse_slack * sum(
                cost(m, b) for b, m in merged):
            merged = [(b_top, all_members)]

    return [BucketPlan(b_bucket=b,
                       c_bucket=next_geometric(len(m), align),
                       members=tuple(sorted(m)))
            for b, m in merged]


@dataclasses.dataclass
class BucketedCohort:
    """A round's client batches partitioned into width-aligned buckets.

    ``buckets[i]`` is a :class:`CohortBatch` padded to
    ``plans[i].c_bucket`` clients by ``plans[i].b_bucket`` batch slots;
    ``plans[i].members`` maps its leading real clients back to canonical
    cohort order.  ``sizes`` are the real clients' pool sizes in that
    canonical order (what eq.-(13) aggregation weights derive from).
    """
    buckets: List[CohortBatch]
    plans: List[BucketPlan]
    sizes: np.ndarray            # (n_real_clients,) canonical order

    @property
    def n_clients(self) -> int:
        return len(self.sizes)

    @property
    def real_elements(self) -> int:
        """Batch elements actually drawn (sum of H * B_c over clients)."""
        return sum(int(np.sum(cb.mask)) for cb in self.buckets)

    @property
    def layout_elements(self) -> int:
        """Batch elements the padded layout materializes and trains on."""
        return sum(int(np.prod(cb.mask.shape)) for cb in self.buckets)

    @property
    def padding_ratio(self) -> float:
        """layout / real elements — the padded-FLOPs overhead factor."""
        real = self.real_elements
        return float(self.layout_elements) / real if real else 1.0


def build_bucketed_cohort(x: np.ndarray, y: np.ndarray,
                          pools: Sequence[np.ndarray], n_steps: int,
                          rng: np.random.Generator, max_batch: int = 64,
                          batch_align: int = 32,
                          client_align: int = 4,
                          client_multiple: int = 1
                          ) -> "BucketedCohort | None":
    """Gather heterogeneous pools into width-aligned sub-cohorts.

    Batches are drawn exactly as :func:`build_cohort` draws them (same
    RNG stream, same canonical pool order), then grouped by per-client
    batch width via :func:`plan_buckets` — so the union of the buckets
    holds the same samples as the global-``Bmax`` cohort while the
    padded-element count stays within a constant factor of the real
    element count regardless of pool skew.  ``client_multiple`` is
    forwarded to the planner so every bucket's client axis divides
    evenly across that many mesh shards.
    """
    per_client, sizes = _draw_client_batches(x, y, pools, n_steps, rng,
                                             max_batch)
    if not per_client:
        return None
    widths = [bx.shape[1] for bx, _ in per_client]
    plans = plan_buckets(widths, batch_align=batch_align,
                         client_align=client_align,
                         client_multiple=client_multiple)
    sample_shape = x.shape[1:]
    buckets = []
    for plan in plans:
        xs = np.zeros((plan.c_bucket, n_steps, plan.b_bucket) + sample_shape,
                      dtype=x.dtype)
        ys = np.zeros((plan.c_bucket, n_steps, plan.b_bucket), dtype=y.dtype)
        mask = np.zeros((plan.c_bucket, n_steps, plan.b_bucket),
                        dtype=np.float32)
        bucket_sizes = np.zeros(plan.c_bucket, dtype=np.int64)
        for slot, pos in enumerate(plan.members):
            bx, by = per_client[pos]
            b = bx.shape[1]
            xs[slot, :, :b] = bx
            ys[slot, :, :b] = by
            mask[slot, :, :b] = 1.0
            bucket_sizes[slot] = sizes[pos]
        buckets.append(CohortBatch(xs=xs, ys=ys, mask=mask,
                                   sizes=bucket_sizes))
    return BucketedCohort(buckets=buckets, plans=plans,
                          sizes=np.asarray(sizes, dtype=np.int64))
