"""Plain PyTorch version of the fused FedAvg aggregation (eq. 13)."""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch


def weighted_aggregate(stacked: torch.Tensor, weights: torch.Tensor
                       ) -> torch.Tensor:
    """out = sum_c weights[c] * stacked[c]; stacked: (C, ...), weights: (C,).

    Accumulates in float32 and casts back to the input type."""
    out = torch.tensordot(weights.to(torch.float32),
                          stacked.to(torch.float32), dims=1)
    return out.to(stacked.dtype)


def aggregate(buckets: Sequence[Sequence[torch.Tensor]],
              weights: torch.Tensor,
              out: Optional[Sequence[torch.Tensor]] = None
              ) -> List[torch.Tensor]:
    """Every leaf over every bucket: ``buckets[b][l]`` is leaf ``l``'s
    (C_b, ...) stack in bucket ``b``, ``weights`` (sum C_b,) in bucket
    order.  Per leaf, the buckets' stacks are concatenated along the
    client axis and aggregated with :func:`weighted_aggregate`; with
    ``out``, each result is copied into ``out[l]``, which is returned."""
    outs = [weighted_aggregate(torch.cat(leaves) if len(leaves) > 1
                               else leaves[0], weights)
            for leaves in zip(*buckets)]
    if out is None:
        return outs
    for o, r in zip(out, outs):
        o.copy_(r)
    return list(out)
