"""Partition specs for every tensor role in the model zoo, as tables.

The counterpart of the reference's ``sharding/specs.py``.  Sharding
scheme:
  * ``model`` axis: tensor-parallel dims — attention heads, FFN hidden,
    experts, vocab; also the Mamba inner dim and RWKV head dim.
  * ``data`` axis: batch (with ``pod``) + FSDP over the d_model dim of
    weight matrices (the paper's air-node clusters).
  * ``pod``  axis: batch only; weights are *replicated* across pods — each
    pod is a satellite-era model replica in the FL mapping, aggregated by
    the lambda-weighted all-reduce (eq. 13) between rounds.

The port has no ``jax.sharding.PartitionSpec``: a spec here is a
:class:`PartitionSpec`, an immutable tuple with one entry per leading
dim of its tensor (``None``, an axis name, or a tuple of names; trailing
dims left out are replicated).  :func:`placements` turns a spec into
DTensor placements on a ``DeviceMesh``, and :func:`distribute_params` /
:func:`distribute_cache` place a whole tree by these tables: this is
where weights (``convert.transformer_params_from_jax``'s, say) are
carried onto a mesh.

Rules are keyed on weight-leaf names and applied by walking the port's
param tree (``launch/train.py::abstract_params``) by key path.  The
reference stacks every block's leaves along a leading layer axis and
prepends ``None`` for it; the port keeps ``params["blocks"]`` as a list
of per-block dicts (``convert.transformer_params_from_jax`` splits the
layer axis and transposes no leaf), so a block leaf's spec is the
reference's without that leading ``None``.  The decode cache
(``models/transformer.py::init_cache``) is a list of per-block dicts
too, and :func:`cache_pspecs` drops the same leading ``None``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from ..configs.base import ModelConfig
from ..configs.shapes import InputShape
from ..tree import tree_map, tree_map_with_path


class PartitionSpec:
    """One tensor's sharding: ``PartitionSpec("data", None, ("pod",
    "data"))`` splits dim 0 over ``data``, keeps dim 1 whole and splits
    dim 2 over ``pod`` x ``data``.  ``PartitionSpec()`` replicates.  A
    one-name tuple is stored as the name, as ``jax`` stores it.

    Immutable and hashable; ``tuple(spec)`` gives its entries.  Not a
    ``tuple`` itself, so the tree helpers take a spec for a leaf."""

    __slots__ = ("_entries",)

    def __init__(self, *entries):
        entries = tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                        for e in entries)
        for e in entries:
            names = e if isinstance(e, tuple) else (e,)
            if e is not None and not all(isinstance(n, str) for n in names):
                raise TypeError(f"a spec entry is None, an axis name or a "
                                f"tuple of names, got {e!r}")
        object.__setattr__(self, "_entries", entries)

    def __setattr__(self, name, value):
        raise AttributeError("a PartitionSpec is immutable")

    def __iter__(self):
        return iter(self._entries)

    def __len__(self) -> int:
        return len(self._entries)

    def __getitem__(self, i):
        return self._entries[i]

    def __eq__(self, other) -> bool:
        return (isinstance(other, PartitionSpec)
                and self._entries == other._entries)

    def __hash__(self) -> int:
        return hash(self._entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{self._entries!r}"


P = PartitionSpec

# leaf name -> (spec without the stacked-layer axis)
_PARAM_RULES: Dict[str, Tuple] = {
    # attention (gqa + rwkv time-mix share names; same orientation)
    "wq": ("data", "model"),
    "wk": ("data", "model"),
    "wv": ("data", "model"),
    "ww": ("data", "model"),
    "wg": ("data", "model"),
    "wr": ("data", "model"),
    "wo": ("model", "data"),
    "q_norm": (None,),
    "k_norm": (None,),
    # MLA
    "wkv_a": ("data", None),
    "wkv_b": (None, "model"),
    "kv_norm": (None,),
    # dense FFN / shared experts
    "w1": ("data", "model"),
    "w3": ("data", "model"),
    "w2": ("model", "data"),
    # MoE
    "router": ("data", None),
    "we1": ("model", "data", None),
    "we3": ("model", "data", None),
    "we2": ("model", None, "data"),
    # mamba
    "in_proj": ("data", "model"),
    "conv_w": (None, "model"),
    "conv_b": ("model",),
    "x_proj": ("model", None),
    "dt_proj": (None, "model"),
    "dt_bias": ("model",),
    "a_log": ("model", None),
    "d_skip": ("model",),
    "out_proj": ("model", "data"),
    # rwkv extras
    "w_bias": ("model",),
    "u": ("model", None),
    "ln_scale": (None,),
    "mix_r": (None,),
    "mix_k": (None,),
    "mix_v": (None,),
    "mix_w": (None,),
    "mix_g": (None,),
    # rwkv channel-mix
    "wck": ("data", "model"),
    "wcv": ("model", "data"),
    "wcr": ("data", "model"),
    # norms
    "scale": (None,),
}

_TOP_LEVEL = {
    ("embed", "w"): ("model", "data"),
    ("lm_head", "w"): ("data", "model"),
    ("in_proj", "w"): ("data", None),
}


def param_pspecs(cfg: ModelConfig, params_shape, fsdp: bool = True,
                 pod_shard_params: bool = False):
    """A :class:`PartitionSpec` tree matching ``params_shape`` (the
    port's params, or ``abstract_params(cfg)`` on ``meta``).

    ``fsdp=False`` drops the ``data``-axis weight sharding (weights then
    replicate across data).  ``pod_shard_params=True`` additionally
    FSDP-shards the d_model dim over ("data", "pod") — a beyond-paper
    memory optimization that breaks the per-pod-replica FL semantics.
    """
    data_axis = ("data", "pod") if pod_shard_params else "data"

    def spec_for(names, leaf):
        rank = len(leaf.shape)
        # top-level (embed / lm_head / model-input proj)
        for (k0, k1), rule in _TOP_LEVEL.items():
            if k0 in names and names[-1] == k1:
                return P(*(data_axis if r == "data" and fsdp
                           else (None if r == "data" else r)
                           for r in rule))
        rule = _PARAM_RULES.get(names[-1])
        if rule is None:
            return P()
        rule = tuple((data_axis if fsdp else None) if r == "data" else r
                     for r in rule)
        # prepend None for any leading axis the rule does not name
        pad = rank - len(rule)
        if pad < 0:
            return P()
        return P(*([None] * pad + list(rule)))

    return tree_map_with_path(spec_for, params_shape)


def batch_axes(multi_pod: bool):
    return ("pod", "data") if multi_pod else ("data",)


# ---------------------------------------------------------------------------
# Cohort client-axis sharding (the FL mega-constellation mapping) ------------
# ---------------------------------------------------------------------------
def data_axis_size(mesh) -> int:
    """Size of the mesh's ``data`` axis (1 when absent, or for ``None``)
    — the number of client-axis shards the cohort engine splits into.
    ``mesh`` is a ``torch.distributed`` ``DeviceMesh``."""
    if mesh is None:
        return 1
    names = tuple(mesh.mesh_dim_names or ())
    return int(mesh.size(names.index("data"))) if "data" in names else 1


def cohort_step_specs():
    """Specs of one bucket dispatch of the mesh-sharded cohort engine:
    ``(in_specs, out_specs)``.

    Inputs  ``(params, xs, ys, mask, weights, lr)``: the model replicates
    while every client-stacked tensor (and the per-client aggregation
    weights) shards its leading client axis over ``data``.  Outputs
    ``(new_params, losses)``: the all-reduced model is replicated, the
    per-client losses stay client-sharded.
    """
    client = P("data")
    return (P(), client, client, client, client, P()), (P(), client)


def data_pspec(cfg: ModelConfig, shape: InputShape, multi_pod: bool,
               which: str = "inputs"):
    """Sharding for a batch input: batch dim over (pod, data)."""
    baxes = batch_axes(multi_pod)
    b = shape.global_batch
    n_batch_shards = int(np.prod([16 if a == "data" else 2 for a in baxes]))
    batch_spec = baxes if b % n_batch_shards == 0 else (
        "data" if b % 16 == 0 else None)
    if shape.kind == "decode" and which != "inputs":
        raise ValueError(which)
    # train/prefill: (B, S) or (B, S, D) and labels (B, S); decode (B, 1)
    return P(batch_spec)


def cache_pspecs(cfg: ModelConfig, cache_shape, shape: InputShape,
                 multi_pod: bool):
    """Sharding for the decode cache (``init_cache``: one dict a block).

    decode_32k (B=128): batch over (pod, data), attention-cache seq over
    ``model``.  long_500k (B=1): cache seq over ("data", "model") —
    sequence-parallel decode; state tensors (mamba/rwkv) shard their
    inner dim on ``model``.
    """
    baxes = batch_axes(multi_pod)
    b = shape.global_batch
    n_batch = int(np.prod([16 if a == "data" else 2 for a in baxes]))
    if b % n_batch == 0:
        bspec: object = baxes
        seq_axes: object = "model"
    elif b % 16 == 0:
        bspec = "data"
        seq_axes = "model"
    else:
        bspec = None
        seq_axes = ("data", "model")

    def spec_for(names, leaf):
        name = names[-1]
        if name in ("k", "v"):          # (B, Hkv, S, hd)
            return P(bspec, None, seq_axes, None)
        if name in ("c_kv", "k_rope"):  # (B, S, r)
            return P(bspec, seq_axes, None)
        if name == "h":                 # (B, di, st)
            return P(bspec, "model", None)
        if name == "conv":              # (B, ck-1, di)
            return P(bspec, None, "model")
        if name == "wkv":               # (B, h, hd, hd)
            return P(bspec, "model", None, None)
        if name in ("shift_t", "shift_c"):  # (B, D)
            return P(bspec, None)
        return P()

    return tree_map_with_path(spec_for, cache_shape)


# ---------------------------------------------------------------------------
# Placing trees on a mesh (DTensor) -------------------------------------------
# ---------------------------------------------------------------------------
def placements(spec: PartitionSpec, mesh):
    """The DTensor placements of ``spec`` on ``mesh``, one per mesh dim:
    ``Shard(i)`` on the mesh dims that entry ``i`` names (a tuple entry
    such as ``("pod", "data")`` splits dim ``i`` over both, in the mesh's
    dim order), ``Replicate()`` on the others.  An axis ``mesh`` lacks is
    left out."""
    from ..sharding.activations import placements_for
    return placements_for(tuple(spec), mesh)


def redistribute_to(x, mesh, spec: PartitionSpec):
    """The DTensor ``x`` brought to ``spec``'s placements (itself where it
    has them): a leaf a step replaced, back as its tree holds it."""
    want = placements(spec, mesh)
    return x if tuple(x.placements) == tuple(want) else x.redistribute(
        mesh, want)


def _distribute(tree, mesh, specs):
    from torch.distributed.tensor import distribute_tensor
    # every rank holds the full value: each keeps a copy of its own chunk
    # (not a view: a donated step must not write into the caller's
    # tensors), nothing is sent
    return tree_map(lambda x, s: distribute_tensor(
        x, mesh, placements(s, mesh), src_data_rank=None).clone(), tree,
        specs)


def distribute_params(params, mesh, pspecs):
    """``params`` (one full copy on every rank, on the mesh's device) as
    DTensors placed by ``pspecs`` (:func:`param_pspecs`): each rank keeps
    its own shard of every leaf.  Every rank must pass the same values."""
    return _distribute(params, mesh, pspecs)


def distribute_cache(cache, mesh, cspecs):
    """The decode cache as DTensors placed by ``cspecs``
    (:func:`cache_pspecs`), as :func:`distribute_params` places params."""
    return _distribute(cache, mesh, cspecs)
