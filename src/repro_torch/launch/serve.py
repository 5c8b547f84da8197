"""Serve-step factory: one-token decode with a KV / state cache.

The counterpart of the reference's ``launch/serve.py``
(``abstract_cache``, ``make_serve_step``).  ``mesh=None`` runs on one
device; with a mesh the params are DTensors placed by ``param_pspecs``
and the cache by ``cache_pspecs``: the batch over the batch axes where
it divides them, the attention caches' sequence over ``model`` (or, for
a batch too small to split, over ``("data", "model")``: sequence-
parallel decode), the state caches' inner dim over ``model``.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..configs.shapes import InputShape
from ..device import resolve_device
from ..models import transformer as T
from ..sharding import activations as A
from ..sharding.specs import (cache_pspecs, distribute_cache,
                              distribute_params, param_pspecs,
                              redistribute_to)
from ..tree import tree_leaves, tree_map
from .train import abstract_params, on_mesh, place_batch


def abstract_cache(cfg: ModelConfig, shape: InputShape):
    """The decode cache's tree for ``shape`` with shapes and dtypes only
    (``meta`` tensors), as ``train.abstract_params`` is for the params."""
    return T.init_cache(cfg, shape.global_batch, shape.seq_len,
                        device="meta")


def make_serve_step(cfg: ModelConfig, device="cuda",
                    shape: InputShape = None, mesh=None,
                    donate: bool = True):
    """Returns ``step(params, cache, inputs, pos) -> (logits (B, V) f32,
    new_cache)`` on ``device``, under ``torch.no_grad``.

    ``donate=True``: the attention caches' K/V tensors are updated in
    place, the port's counterpart of the reference's donated cache: the
    cache passed in is spent, use the one returned.  ``donate=False``
    steps on a copy and leaves the given cache readable.  ``shape``, when
    given, fixes the batch (``global_batch``) the step takes.

    With ``mesh`` (``shape`` is then required): the params are DTensors
    placed by ``param_pspecs`` (``step.place(params)``), the cache
    DTensors placed by ``cache_pspecs`` (``step.place_cache(cache)``),
    the inputs (whole on every rank) are split as the cache's batch, and
    the logits are a DTensor split likewise, whole over ``model``.  The
    new cache keeps the cache's placements.
    """
    dev = resolve_device(device)
    if mesh is not None and shape is None:
        raise ValueError("make_serve_step(mesh=...) needs the shape whose "
                         "cache it places")

    def check(inputs):
        if shape is not None and inputs.shape[0] != shape.global_batch:
            raise ValueError(f"step built for batch {shape.global_batch}, "
                             f"got {inputs.shape[0]}")

    def fresh(cache):
        return cache if donate else tree_map(torch.clone, cache)

    if mesh is None:
        @torch.no_grad()
        def step(params, cache, inputs, pos: int):
            inputs = inputs.to(dev)
            check(inputs)
            return T.serve_step(params, cfg, fresh(cache), inputs, int(pos))

        return step

    multi_pod = "pod" in (mesh.mesh_dim_names or ())
    pspecs = param_pspecs(cfg, abstract_params(cfg))
    cspecs = cache_pspecs(cfg, abstract_cache(cfg, shape), shape, multi_pod)
    # the batch axes are the cache's: its batch entry wherever it has one
    bspec = next((s[0] for s in tree_leaves(cspecs) if len(s)), None)
    axes = (bspec if isinstance(bspec, tuple)
            else (bspec,) if bspec else ())

    @torch.no_grad()
    def step(params, cache, inputs, pos: int):
        check(inputs)
        with on_mesh(mesh, axes):
            inputs = place_batch({"inputs": inputs}, mesh, axes,
                                 ("inputs",))["inputs"]
            logits, new = T.serve_step(params, cfg, fresh(cache), inputs,
                                       int(pos))
            new = tree_map(lambda c, s: redistribute_to(c, mesh, s), new, cspecs)
            return A.shard(logits, "batch", None), new

    step.pspecs, step.cspecs = pspecs, cspecs
    step.place = lambda params: distribute_params(params, mesh, pspecs)
    step.place_cache = lambda cache: distribute_cache(cache, mesh, cspecs)
    return step
