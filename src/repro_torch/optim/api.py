"""Uniform optimizer interface used by the trainers."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

from .adam import adam_init, adam_update
from .sgd import sgd_init, sgd_update


@dataclasses.dataclass
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[..., Any]   # (params, grads, state, lr) -> (params, state)
    name: str = "sgd"


def make_optimizer(name: str = "sgd", momentum: float = 0.0,
                   weight_decay: float = 0.0, **kw) -> Optimizer:
    if name == "sgd":
        return Optimizer(
            init=lambda p: sgd_init(p, momentum),
            update=lambda p, g, s, lr: sgd_update(
                p, g, s, lr, momentum=momentum, weight_decay=weight_decay),
            name="sgd")
    if name in ("adam", "adamw"):
        wd = weight_decay if name == "adamw" else 0.0
        return Optimizer(
            init=adam_init,
            update=lambda p, g, s, lr: adam_update(
                p, g, s, lr, weight_decay=wd, **kw),
            name=name)
    raise ValueError(f"unknown optimizer {name!r}")
