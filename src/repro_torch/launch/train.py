"""Prefill step factory of the transformer stack.

The counterpart of the reference's ``launch/train.py::make_prefill_step``
on one device: no mesh and no shardings.  The training steps come with
the training slice (ROADMAP.md §1).
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from ..models import transformer as T


def make_prefill_step(cfg: ModelConfig, device="cuda"):
    """Forward-only step (inference prefill) on ``device``.

    Returns ``prefill(params, {"inputs": ...}) -> (B, V)`` float32 logits
    of the last position.  Runs under ``torch.no_grad``.
    """
    dev = resolve_device(device)

    @torch.no_grad()
    def prefill(params, batch):
        inputs = batch["inputs"].to(dev)
        h, _ = T.forward(params, cfg, inputs)
        # last-token logits only (decode bootstrap)
        logits = T.unembed(params, cfg, h[:, -1:, :])
        return logits[:, 0].to(torch.float32)

    return prefill
