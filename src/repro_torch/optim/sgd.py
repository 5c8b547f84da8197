"""Plain/momentum SGD on parameter trees (nested dicts and lists of
tensors, :mod:`repro_torch.tree`): the reference's ``optim/sgd.py``
arithmetic, functional (new tensors, the inputs untouched)."""
from __future__ import annotations

import torch

from ..tree import tree_map


def sgd_init(params, momentum: float = 0.0):
    if momentum == 0.0:
        return ()
    return tree_map(torch.zeros_like, params)


def sgd_update(params, grads, state, lr, momentum: float = 0.0,
               weight_decay: float = 0.0):
    """Returns (new_params, new_state)."""
    if weight_decay:
        grads = tree_map(lambda g, p: g + weight_decay * p, grads, params)
    if momentum == 0.0:
        return tree_map(lambda p, g: p - lr * g, params, grads), state
    new_state = tree_map(lambda m, g: momentum * m + g, state, grads)
    new_params = tree_map(lambda p, m: p - lr * m, params, new_state)
    return new_params, new_state
