"""Dispatch by device: the CUDA kernel for a CUDA tensor, the plain
PyTorch version for a CPU tensor."""
from __future__ import annotations

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
