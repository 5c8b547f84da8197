"""Carry parameters between the reference's layout and the port's.

The reference stores conv kernels HWIO (``(kh, kw, cin, cout)``, for its
NHWC convolutions); the port's convolutions run ``torch.nn.functional
.conv2d``, which takes OIHW.  Every 4-D leaf is a conv kernel in both
models' trees, so the conversion is a permutation of the 4-D leaves and
a copy of every other leaf.  Dense weights keep the reference's
``(din, dout)`` layout, and the port flattens NHWC before its dense
layers exactly as the reference does, so no row permutation is needed.
"""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .tree import tree_map


def params_from_jax(tree, device="cuda"):
    """A reference pytree of numpy arrays (nested dicts and lists) as the
    port's parameter tree on ``device``: HWIO conv kernels become OIHW."""
    dev = resolve_device(device)

    def leaf(a):
        t = torch.from_numpy(np.array(a))
        if t.ndim == 4:
            t = t.permute(3, 2, 0, 1)
        return t.contiguous().to(dev)

    return tree_map(leaf, tree)


def params_to_numpy(tree):
    """The port's parameter tree as numpy arrays in the reference's
    layout (OIHW conv kernels back to HWIO)."""
    def leaf(t):
        t = t.detach()
        if t.ndim == 4:
            t = t.permute(2, 3, 1, 0)
        return t.contiguous().cpu().numpy()

    return tree_map(leaf, tree)
