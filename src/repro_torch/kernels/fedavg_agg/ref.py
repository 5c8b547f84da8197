"""Plain PyTorch version of the fused FedAvg aggregation (eq. 13)."""
from __future__ import annotations

import torch


def weighted_aggregate(stacked: torch.Tensor, weights: torch.Tensor
                       ) -> torch.Tensor:
    """out = sum_c weights[c] * stacked[c]; stacked: (C, ...), weights: (C,).

    Accumulates in float32 and casts back to the input type."""
    out = torch.tensordot(weights.to(torch.float32),
                          stacked.to(torch.float32), dims=1)
    return out.to(stacked.dtype)
