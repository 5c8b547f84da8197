"""Assigned input shapes and the policy of which (arch x shape) is built.

  train_4k     seq=4096    global_batch=256   (training)      -> train_step
  prefill_32k  seq=32768   global_batch=32    (prefill)       -> prefill
  decode_32k   seq=32768   global_batch=128   (decode)        -> serve_step
  long_500k    seq=524288  global_batch=1     (long decode)   -> serve_step

The counterpart of the reference's ``configs/shapes.py``: its
``ShapeDtypeStruct`` stand-ins become tensors on the ``meta`` device
(shapes and dtypes, no storage), which the dry-run (``launch/dryrun.py``)
feeds to the port's steps.  long_500k requires a sub-quadratic attention
path (SSM / hybrid / MLA latent cache / sliding window) — ``supports()``
encodes the policy.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from .base import ModelConfig


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train|prefill|decode


SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


def supports(cfg: ModelConfig, shape: InputShape) -> bool:
    """Policy for which (arch x shape) combos are built."""
    if shape.name == "long_500k":
        return cfg.is_subquadratic
    return True


def input_specs(cfg: ModelConfig, shape: InputShape,
                batch_override: Optional[int] = None,
                device="meta") -> Dict[str, torch.Tensor]:
    """Stand-ins for every model input, with the reference's shapes and
    dtypes: ``meta`` tensors (no allocation), or zeros on ``device``
    (token 0 is a valid token)."""
    b = batch_override or shape.global_batch
    s = shape.seq_len if shape.kind in ("train", "prefill") else 1
    f = getattr(torch, cfg.param_dtype)

    def zeros(dims, dtype):
        return torch.zeros(dims, dtype=dtype, device=device)

    # decode: ONE new token; the cache spec is created separately
    if cfg.input_mode == "tokens":
        out = {"inputs": zeros((b, s), torch.int32)}
    else:
        out = {"inputs": zeros((b, s, cfg.d_model), f)}
    if shape.kind == "train":
        out["labels"] = zeros((b, s), torch.int32)
    return out


def cache_specs(cfg: ModelConfig, shape: InputShape,
                batch_override: Optional[int] = None, device="meta"):
    """The decode cache of ``transformer.init_cache`` for ``shape``, on
    ``device`` (``meta``: shapes and dtypes only)."""
    from ..models import transformer as T
    b = batch_override or shape.global_batch
    return T.init_cache(cfg, b, shape.seq_len, device=device)
