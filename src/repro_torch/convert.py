"""Carry parameters between the reference's layout and the port's.

CNN trees (``params_from_jax`` / ``params_to_numpy``): the reference
stores conv kernels HWIO (``(kh, kw, cin, cout)``, for its NHWC
convolutions); the port's convolutions run ``torch.nn.functional
.conv2d``, which takes OIHW.  Every 4-D leaf is a conv kernel in the
paper's CNN trees, so the conversion is a permutation of the 4-D leaves
and a copy of every other leaf.  Dense weights keep the reference's
``(din, dout)`` layout, and the port flattens NHWC before its dense
layers exactly as the reference does, so no row permutation is needed.

Transformer trees (``transformer_params_from_jax`` /
``transformer_params_to_numpy``): the reference stacks every block's
leaves along a leading layer axis; the port keeps a list of per-block
dicts.  The conversion walks the tree the config's block template gives
(``init_params`` on the ``meta`` device), splits or stacks the layer
axis and permutes nothing: a 4-D leaf there is not a convolution.
"""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .models import transformer as T
from .tree import tree_map


def params_from_jax(tree, device="cuda"):
    """A reference CNN pytree of numpy arrays (nested dicts and lists) as
    the port's parameter tree on ``device``: HWIO conv kernels become
    OIHW.  For the paper's CNN trees only; a transformer tree goes
    through :func:`transformer_params_from_jax`."""
    dev = resolve_device(device)

    def leaf(a):
        t = torch.from_numpy(np.array(a))
        if t.ndim == 4:
            t = t.permute(3, 2, 0, 1)
        return t.contiguous().to(dev)

    return tree_map(leaf, tree)


def params_to_numpy(tree):
    """The port's CNN parameter tree as numpy arrays in the reference's
    layout (OIHW conv kernels back to HWIO)."""
    def leaf(t):
        t = t.detach()
        if t.ndim == 4:
            t = t.permute(2, 3, 1, 0)
        return t.contiguous().cpu().numpy()

    return tree_map(leaf, tree)


def _tensor(a) -> torch.Tensor:
    """A numpy array (bf16 ones as ``ml_dtypes.bfloat16``) as a tensor of
    the same type and values."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(a.view(np.uint16).astype(np.int16))
        return bits.view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array; bf16 widens exactly to float32."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.contiguous().numpy()


def _walk(template, ref, path: str, take):
    """``template``'s nesting filled leaf by leaf with ``take(ref_leaf,
    template_leaf, path)``; raises when ``ref`` has other keys."""
    if isinstance(template, dict):
        if not isinstance(ref, dict) or set(ref) != set(template):
            got = sorted(ref) if isinstance(ref, dict) else type(ref)
            raise ValueError(f"{path or 'params'}: expected keys "
                             f"{sorted(template)}, got {got}")
        return {k: _walk(template[k], ref[k], f"{path}/{k}", take)
                for k in sorted(template)}
    return take(ref, template, path)


def transformer_params_from_jax(cfg, tree, device="cuda"):
    """A reference transformer tree (numpy arrays, every ``blocks`` leaf
    stacked over the layer axis) as the port's params on ``device``:
    ``blocks`` split into a list of per-block dicts, values and types
    kept."""
    dev = resolve_device(device)
    template = T.init_params(cfg, device="meta")
    n = len(template["blocks"])

    def leaf(i):
        def take(a, t, path):
            x = _tensor(a)
            if i is not None:
                x = x[i]
            if x.shape != t.shape or x.dtype != t.dtype:
                raise ValueError(f"{path}: expected {t.dtype} "
                                 f"{tuple(t.shape)}, got {x.dtype} "
                                 f"{tuple(x.shape)}")
            return x.contiguous().to(dev)
        return take

    params = {"blocks": [_walk(template["blocks"][i], tree["blocks"],
                               "blocks", leaf(i)) for i in range(n)]}
    rest = {k: v for k, v in template.items() if k != "blocks"}
    params.update(_walk(rest, {k: v for k, v in tree.items()
                               if k != "blocks"}, "", leaf(None)))
    return params


def transformer_params_to_numpy(cfg, params):
    """The port's transformer params as the reference's tree of numpy
    arrays: the per-block dicts stacked over a leading layer axis (bf16
    widened exactly to float32)."""
    template = T.init_params(cfg, device="meta")
    blocks = params["blocks"]
    if len(blocks) != len(template["blocks"]):
        raise ValueError(f"expected {len(template['blocks'])} blocks, got "
                         f"{len(blocks)}")

    def leaf(t, _, path):
        return _numpy(t)

    per_block = [_walk(template["blocks"][0], block, "blocks", leaf)
                 for block in blocks]
    out = {"blocks": tree_map(lambda *xs: np.stack(xs), *per_block)}
    rest = {k: v for k, v in template.items() if k != "blocks"}
    out.update(_walk(rest, {k: v for k, v in params.items()
                            if k != "blocks"}, "", leaf))
    return out
