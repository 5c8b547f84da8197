"""Dispatch by device: the CUDA kernel for a CUDA tensor, the plain
PyTorch version for a CPU tensor."""
from __future__ import annotations

from typing import List, Sequence

import torch

from . import kernel, ref


def weighted_aggregate(stacked: torch.Tensor, weights: torch.Tensor
                       ) -> torch.Tensor:
    """eq. (13): sum_c weights[c] * stacked[c] over the client axis.

    A CPU tensor goes to :mod:`.ref`; any other goes to the kernel,
    which launches or raises.
    """
    if stacked.device.type == "cpu":
        return ref.weighted_aggregate(stacked, weights)
    return kernel.weighted_aggregate(stacked, weights)


def aggregate(buckets: Sequence[Sequence[torch.Tensor]],
              weights: torch.Tensor) -> List[torch.Tensor]:
    """eq. (13) for every leaf over every size bucket: ``buckets[b][l]``
    is leaf ``l``'s (C_b, ...) stack in bucket ``b``, ``weights`` the
    (sum C_b,) vector in bucket order.

    CPU tensors go to :mod:`.ref`; any others to the kernel, one launch
    for all of them, which launches or raises.
    """
    if buckets[0][0].device.type == "cpu":
        return ref.aggregate(buckets, weights)
    return kernel.aggregate(buckets, weights)
