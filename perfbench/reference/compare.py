"""The numbers by which a training cell's run is judged against its
reference.

For each leaf, the norm of its change over a span of steps, on each
side.  A leaf's gap is the gap between the two norms (not the norm of
their difference), as a share of the reference's norm of that leaf or of
the median leaf, whichever is larger; a span's gap is its worst leaf's.
Leaves whose first change in the reference is under a thousandth of the
median leaf's are left out (a gradient that is nought to rounding moves
a leaf by round-off alone).
"""
from __future__ import annotations

import math
import statistics
from typing import List, Sequence

import torch

NEGLIGIBLE = 1e-3


def change_norms(after: Sequence[torch.Tensor],
                 before: Sequence[torch.Tensor]) -> List[float]:
    """Per leaf, the float32 norm of ``after - before``."""
    return [float(torch.linalg.vector_norm(a.float() - b.float()))
            for a, b in zip(after, before)]


def kept(first_ref: Sequence[float]) -> List[int]:
    """The leaves that count: their first change in the reference is at
    least a thousandth of the median leaf's."""
    med = statistics.median(first_ref)
    return [i for i, v in enumerate(first_ref) if v >= NEGLIGIBLE * med]


def _worst(gaps) -> float:
    gaps = list(gaps)
    if not all(math.isfinite(g) for g in gaps):
        return math.inf
    return max(gaps)


def norm_gap(prog: Sequence[float], ref: Sequence[float],
             keep: Sequence[int]) -> float:
    """The worst kept leaf's gap of norms (``inf`` if any is not
    finite)."""
    med = statistics.median(ref[i] for i in keep)
    return _worst(abs(prog[i] - ref[i]) / max(ref[i], med) for i in keep)


def median_gap(prog: Sequence[float], ref: Sequence[float],
               keep: Sequence[int]) -> float:
    """The median kept leaf's gap of norms (printed beside the worst)."""
    med = statistics.median(ref[i] for i in keep)
    gaps = [abs(prog[i] - ref[i]) / max(ref[i], med) for i in keep]
    if not all(math.isfinite(g) for g in gaps):
        return math.inf
    return statistics.median(gaps)


def loss_gap(prog: Sequence[float], ref: Sequence[float]) -> float:
    """The worst step's relative gap of losses."""
    return _worst(abs(p - r) / abs(r) for p, r in zip(prog, ref))


def unmoved(prog_first, ref_first, exact: Sequence[int]) -> int:
    """How many of the ``exact`` leaves (float32: any gradient moves
    them) the reference's first step moves and the program's leaves
    exactly where they were."""
    return sum(1 for i in exact if ref_first[i] > 0 and prog_first[i] == 0)


def readings(prog_losses, ref_losses, prog_first, ref_first, prog_span,
             ref_span, exact: Sequence[int] = None) -> dict:
    """Every number of a training cell's comparison: the losses, the
    first step's change (the first gradient as SGD applied it) and the
    change over the compared span, and the float32 leaves the program
    left unmoved (``exact``: their indices, default all).  A non-finite
    reading comes back as ``inf``, which no limit passes."""
    keep = kept(ref_first)
    if exact is None:
        exact = range(len(ref_first))
    out = {"loss_gap": loss_gap(prog_losses, ref_losses),
           "first_loss_gap": loss_gap(prog_losses[:1], ref_losses[:1]),
           "first_change_gap": norm_gap(prog_first, ref_first, keep),
           "span_change_gap": norm_gap(prog_span, ref_span, keep),
           "first_change_median_gap": median_gap(prog_first, ref_first,
                                                 keep),
           "span_change_median_gap": median_gap(prog_span, ref_span, keep),
           "unmoved_leaves": unmoved(prog_first, ref_first, exact),
           "leaves_kept": len(keep), "leaves": len(ref_first)}
    return out
