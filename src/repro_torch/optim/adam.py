"""Adam/AdamW on parameter trees: the reference's ``optim/adam.py``
arithmetic, with the step ``count`` an int32 tensor on the params'
device."""
from __future__ import annotations

import torch

from ..tree import tree_leaves, tree_map


def adam_init(params):
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    return {"mu": tree_map(torch.zeros_like, params),
            "nu": tree_map(torch.zeros_like, params),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def adam_update(params, grads, state, lr, b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-8, weight_decay: float = 0.0):
    count = state["count"] + 1
    mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state["mu"], grads)
    nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, state["nu"],
                  grads)
    c = count.to(torch.float32)
    bc1 = 1.0 - b1 ** c
    bc2 = 1.0 - b2 ** c

    def upd(p, m, v):
        step = lr * (m / bc1) / (torch.sqrt(v / bc2) + eps)
        if weight_decay:
            step = step + lr * weight_decay * p
        return p - step

    new_params = tree_map(upd, params, mu, nu)
    return new_params, {"mu": mu, "nu": nu, "count": count}
