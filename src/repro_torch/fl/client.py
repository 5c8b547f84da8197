"""Per-node local training (eqs. 3-4, 6): H mini-batch SGD iterations.

``local_update`` runs H steps of ``torch.func.grad_and_value`` on one
node's ``(H, B, ...)`` batch stack (the reference's ``lax.scan`` becomes
a Python loop over H); ``vmapped_local_update`` runs a stack of clients,
each from its own params and learning rate, through ``torch.func.vmap``.
``masked_local_update`` / ``cohort_local_update``
are the batched engine's versions: a per-sample validity mask lets
clients with different pool sizes share one padded ``(C, H, Bmax, ...)``
cohort tensor, and ``cohort_local_update`` trains all C clients at once
through ``torch.func.vmap``.  Masked slots contribute exactly zero loss
and gradient, so a client's update equals what ``local_update`` computes
on its unpadded batches.

The reference's fused single-bucket program (``cohort_round_step``) has
no counterpart here: a single-bucket round in the port is the same local
update followed by the same aggregate kernel.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch
from torch.func import grad_and_value, vmap

from ..tree import tree_map


def cross_entropy(logits, labels):
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.mean(torch.gather(logp, -1, labels[:, None]))


def make_loss_fn(apply_fn: Callable):
    def loss_fn(params, x, y):
        return cross_entropy(apply_fn(params, x), y)
    return loss_fn


def _sgd(params, grads, lr):
    return tree_map(lambda a, g: a - lr * g, params, grads)


def local_update(apply_fn: Callable, params, xs, ys, lr):
    """H local SGD iterations (eq. 3/4/6).

    xs: (H, B, ...), ys: (H, B). Returns (new_params, mean_loss).
    """
    step = grad_and_value(make_loss_fn(apply_fn))
    losses = []
    for h in range(xs.shape[0]):
        g, loss = step(params, xs[h], ys[h])
        params = _sgd(params, g, lr)
        losses.append(loss)
    return params, torch.stack(losses).mean()


def vmapped_local_update(apply_fn: Callable, stacked_params, xs, ys, lrs):
    """Run many clients at once.

    stacked_params: parameter tree with leading client axis C.
    xs: (C, H, B, ...), ys: (C, H, B), lrs: (C,).  Returns (stacked new
    params, per-client mean losses of shape (C,)).
    """
    def one(params, x, y, lr):
        return local_update(apply_fn, params, x, y, lr)

    return vmap(one)(stacked_params, xs, ys, lrs)


def masked_cross_entropy(logits, labels, mask):
    """Mean NLL over the valid (mask == 1) samples of a padded batch.

    With an all-ones mask this equals ``cross_entropy``; padded slots are
    excluded from both the numerator and the denominator, and an all-zero
    mask (a padding client) yields loss 0 with zero gradient.
    """
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels[:, None])[:, 0]
    denom = torch.clamp(torch.sum(mask), min=1.0)
    return torch.sum(nll * mask) / denom


def _masked_loss_fn(apply_fn: Callable):
    def loss_fn(params, x, y, m):
        return masked_cross_entropy(apply_fn(params, x), y, m)
    return loss_fn


def masked_local_update(apply_fn: Callable, params, xs, ys, mask, lr):
    """``local_update`` over padded batches.

    xs: (H, B, ...), ys: (H, B), mask: (H, B). Returns
    (new_params, mean_loss) where padded slots are ignored.
    """
    step = grad_and_value(_masked_loss_fn(apply_fn))
    losses = []
    for h in range(xs.shape[0]):
        g, loss = step(params, xs[h], ys[h], mask[h])
        params = _sgd(params, g, lr)
        losses.append(loss)
    return params, torch.stack(losses).mean()


def cohort_local_update(apply_fn: Callable, params, xs, ys, mask, lr):
    """Train a whole cohort of clients at once.

    ``params`` is the single global model, broadcast to every client by
    the first step (no replication up front); xs: (C, H, B, ...),
    ys/mask: (C, H, B).  Returns (stacked params with leading client axis
    C, per-client mean losses of shape (C,)).  Padding clients (all-zero
    mask rows) come back with unchanged params and loss 0.

    The client stack is this function's own from the first step on, so
    steps 2..H update it in place.
    """
    grad_fn = grad_and_value(_masked_loss_fn(apply_fn))
    first = vmap(grad_fn, in_dims=(None, 0, 0, 0))
    rest = vmap(grad_fn, in_dims=(0, 0, 0, 0))
    losses = []
    g, loss = first(params, xs[:, 0], ys[:, 0], mask[:, 0])
    stacked = _sgd(params, g, lr)
    losses.append(loss)
    for h in range(1, xs.shape[1]):
        g, loss = rest(stacked, xs[:, h], ys[:, h], mask[:, h])
        tree_map(lambda a, b: a.sub_(lr * b), stacked, g)
        losses.append(loss)
    return stacked, torch.stack(losses).mean(dim=0)


def evaluate(apply_fn: Callable, params, x, y) -> Tuple[torch.Tensor,
                                                         torch.Tensor]:
    """Returns (loss, accuracy) over a single large batch."""
    with torch.no_grad():
        logits = apply_fn(params, x)
        loss = cross_entropy(logits, y)
        acc = torch.mean((torch.argmax(logits, -1) == y).to(torch.float32))
    return loss, acc


def stacked_evaluate(apply_fn: Callable, stacked_params, x,
                     y) -> Tuple[torch.Tensor, torch.Tensor]:
    """(losses, accuracies), each of shape (C,), for a stack of models
    (leading axis C) on ONE shared eval batch — the apples-to-apples
    comparison of per-region models against the merged global model."""
    return vmap(lambda p: evaluate(apply_fn, p, x, y))(stacked_params)
