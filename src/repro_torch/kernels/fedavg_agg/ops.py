"""Dispatch by device: the CUDA kernel for a CUDA tensor, the plain
PyTorch version for a CPU tensor, and for a ``meta`` tensor too, as one
region (:mod:`..region`)."""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ...analysis.contracts import check_kernel_outputs
from .. import region
from . import kernel, ref


def weighted_aggregate(stacked: torch.Tensor, weights: torch.Tensor
                       ) -> torch.Tensor:
    """eq. (13): sum_c weights[c] * stacked[c] over the client axis.

    A CPU tensor goes to :mod:`.ref`, a ``meta`` one to :mod:`.ref` as a
    region; any other goes to the kernel, which launches or raises.
    """
    region.local_only("fedavg_agg", stacked, weights)
    if stacked.device.type == "cpu":
        return ref.weighted_aggregate(stacked, weights)
    if stacked.device.type == "meta":
        return region.run("fedavg_agg", ref.weighted_aggregate, stacked,
                          weights)
    out = kernel.weighted_aggregate(stacked, weights)
    check_kernel_outputs("fedavg_agg", out)
    return out


def aggregate(buckets: Sequence[Sequence[torch.Tensor]],
              weights: torch.Tensor,
              out: Optional[Sequence[torch.Tensor]] = None
              ) -> List[torch.Tensor]:
    """eq. (13) for every leaf over every size bucket: ``buckets[b][l]``
    is leaf ``l``'s (C_b, ...) stack in bucket ``b``, ``weights`` the
    (sum C_b,) vector in bucket order.  With ``out`` (one contiguous
    tensor a leaf, of its shape and type) the results are written there
    and ``out`` is returned.

    CPU tensors go to :mod:`.ref`, ``meta`` ones to :mod:`.ref` as one
    region; any others to the kernel, one launch for all of them, which
    launches or raises.
    """
    region.local_only("fedavg_agg", weights,
                      *(x for leaves in buckets for x in leaves))
    device = buckets[0][0].device.type
    if device == "cpu":
        return ref.aggregate(buckets, weights, out)
    if device == "meta":
        n = len(buckets[0])
        outs = region.run("fedavg_agg", lambda *x: ref.aggregate(
            [x[i:i + n] for i in range(0, len(x) - 1, n)], x[-1]),
            *(x for leaves in buckets for x in leaves), weights)
        return outs if out is None else list(out)
    outs = kernel.aggregate(buckets, weights, out)
    check_kernel_outputs("fedavg_agg", *outs)
    return outs
