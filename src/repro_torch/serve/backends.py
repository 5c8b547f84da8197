"""Model-execution backends of the serving path.

* :class:`CNNBackend` serves each region's CURRENT federated CNN — the
  params the region trainer holds right now, so federation staleness
  shows as served accuracy.
* :class:`TransformerBackend` dispatches one-token decode steps through
  :func:`repro_torch.launch.serve.make_serve_step`, one step, cache and
  position per padded batch width.  Requests map to token batches; there
  are no labels.

Backends expose ``predict(model_region, x, samples)`` returning an int
prediction array (or ``None`` when the workload has no ground truth)
and a ``has_labels`` flag.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..configs import InputShape, get_config
from ..device import resolve_device
from ..launch.serve import make_serve_step
from ..models import transformer as T
from ..tree import tree_map


class CNNBackend:
    """Serve each region's live federated model (read-only).

    ``predict`` reads ``trainers[j].params`` AT DISPATCH TIME — never a
    copy taken at construction — so a merge installed between serve
    ticks is immediately visible.
    """

    has_labels = True

    def __init__(self, trainers: List):
        self.trainers = trainers

    @torch.no_grad()
    def predict(self, model_region: int, x: np.ndarray,
                samples: np.ndarray) -> Optional[np.ndarray]:
        tr = self.trainers[model_region]
        logits = tr.apply_fn(tr.params, torch.as_tensor(x).to(tr.device))
        return logits.argmax(dim=-1).cpu().numpy()


class TransformerBackend:
    """One-token decode through ``make_serve_step`` on one device.

    Builds one step (plus its KV cache) per padded batch width; caches
    are threaded through successive dispatches of the same width and
    updated in place (with ``donate=False`` each step works on a copy,
    so the previous cache survives).  Any config of the port's families
    decodes here: GQA and RWKV6, and MLA with MoE (deepseek-v2-lite-16b:
    ``mla_decode`` over the latent cache, the flat MoE dispatch, whose
    capacity is global over the batch, as in the reference).  Request
    sample ids map to vocabulary tokens.  ``params`` holds the seeded
    random model (the port's layout; assign converted params to serve
    those); ``last_logits`` holds the latest step's logits.
    """

    has_labels = False

    def __init__(self, model_cfg=None, seq_len: int = 64,
                 donate: bool = True, seed: int = 0, device="cuda"):
        cfg = model_cfg if model_cfg is not None else (
            get_config("llama3.2-3b").reduced(n_layers=2, d_model=64))
        self.cfg = cfg
        self.seq_len = int(seq_len)
        self.donate = donate
        self.device = resolve_device(device)
        self.params = T.init_params(cfg, seed, self.device)
        self._steps: Dict[int, object] = {}   # padded width -> step
        self._caches: Dict[int, object] = {}  # padded width -> live cache
        self._pos: Dict[int, int] = {}
        self.last_logits: Optional[torch.Tensor] = None

    def _step(self, b: int):
        step = self._steps.get(b)
        if step is None:
            shape = InputShape(f"serve_b{b}", self.seq_len, b, "decode")
            step = make_serve_step(self.cfg, self.device, shape)
            self._steps[b] = step
            self._caches[b] = T.init_cache(self.cfg, b, self.seq_len,
                                           device=self.device)
            self._pos[b] = 0
        return step

    def predict(self, model_region: int, x: np.ndarray,
                samples: np.ndarray) -> Optional[np.ndarray]:
        b = len(samples)
        step = self._step(b)
        tokens = torch.as_tensor(np.asarray(samples) % self.cfg.vocab_size,
                                 dtype=torch.int64).reshape(b, 1)
        cache = self._caches[b]
        if not self.donate:
            cache = tree_map(torch.clone, cache)
        pos = self._pos[b]
        logits, self._caches[b] = step(self.params, cache, tokens, pos)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.last_logits = logits
        self._pos[b] = (pos + 1) % self.seq_len
        return None
