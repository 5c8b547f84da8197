"""Serve-step factory: one-token decode with a KV / state cache.

The counterpart of the reference's ``launch/serve.py`` on one device
(``abstract_cache``, ``make_serve_step``): no mesh and no shardings.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..configs.shapes import InputShape
from ..device import resolve_device
from ..models import transformer as T


def abstract_cache(cfg: ModelConfig, shape: InputShape):
    """The decode cache's tree for ``shape`` with shapes and dtypes only
    (``meta`` tensors), as ``train.abstract_params`` is for the params."""
    return T.init_cache(cfg, shape.global_batch, shape.seq_len,
                        device="meta")


def make_serve_step(cfg: ModelConfig, device="cuda",
                    shape: InputShape = None):
    """Returns ``step(params, cache, inputs, pos) -> (logits (B, V) f32,
    new_cache)`` on ``device``, under ``torch.no_grad``.

    The attention caches' K/V tensors are updated in place, the port's
    counterpart of the reference's donated cache: the cache passed in is
    spent, use the one returned.  ``shape``, when given, fixes the batch
    (``global_batch``) the step takes.
    """
    dev = resolve_device(device)

    @torch.no_grad()
    def step(params, cache, inputs, pos: int):
        inputs = inputs.to(dev)
        if shape is not None and inputs.shape[0] != shape.global_batch:
            raise ValueError(f"step built for batch {shape.global_batch}, "
                             f"got {inputs.shape[0]}")
        return T.serve_step(params, cfg, cache, inputs, int(pos))

    return step
