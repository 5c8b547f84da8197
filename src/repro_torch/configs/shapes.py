"""Assigned input shapes and the policy of which (arch x shape) is built.

  train_4k     seq=4096    global_batch=256   (training)      -> train_step
  prefill_32k  seq=32768   global_batch=32    (prefill)       -> prefill
  decode_32k   seq=32768   global_batch=128   (decode)        -> serve_step
  long_500k    seq=524288  global_batch=1     (long decode)   -> serve_step

A copy of the reference's ``configs/shapes.py`` without its
``ShapeDtypeStruct`` specs, which serve the dry-run only.  long_500k
requires a sub-quadratic attention path (SSM / hybrid / MLA latent cache
/ sliding window) — ``supports()`` encodes the policy.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

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
