"""Plain VGG-11 for CIFAR-10 (arXiv:1409.1556, the paper's third payload),
its local SGD and the eq.-(13) mean, in plain PyTorch.

Images come NHWC; the convolutions are 3x3 with padding 1, each followed
by ReLU, with 2x2 max-pooling after the 1st, 2nd, 4th, 6th and 8th; the
1x1x512 map feeds one dense layer to the 10 logits.  In float32 (under
:func:`.precision.exact`, with no TF32).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F


LAYOUT = [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"]


def apply(params, x):
    x = x.permute(0, 3, 1, 2)
    ci = 0
    for v in LAYOUT:
        if v == "M":
            x = F.max_pool2d(x, 2)
        else:
            p = params["convs"][ci]
            x = F.relu(F.conv2d(x, p["w"], p["b"], padding=1))
            ci += 1
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    return x @ params["fc"]["w"] + params["fc"]["b"]


def leaves(params) -> List[torch.Tensor]:
    out = []
    for c in params["convs"]:
        out += [c["w"], c["b"]]
    return out + [params["fc"]["w"], params["fc"]["b"]]


def rebuild(params, flat: Sequence[torch.Tensor]):
    it = iter(flat)
    return {"convs": [{"w": next(it), "b": next(it)} for _ in params["convs"]],
            "fc": {"w": next(it), "b": next(it)}}


def local_sgd(params, xs, ys, lr: float) -> Tuple[List[torch.Tensor],
                                                 float]:
    """H steps of plain SGD on one client's (H, B, ...) batches, each on
    the mean cross-entropy of its B samples.  Returns the client's leaves
    and the mean of its H losses."""
    ps = [p.detach().clone() for p in leaves(params)]
    losses = []
    for h in range(xs.shape[0]):
        ps = [p.requires_grad_() for p in ps]
        logits = apply(rebuild(params, ps), xs[h])
        loss = F.cross_entropy(logits.float(), ys[h])
        grads = torch.autograd.grad(loss, ps)
        with torch.no_grad():
            ps = [p - lr * g for p, g in zip(ps, grads)]
        losses.append(float(loss.detach()))
    return [p.detach() for p in ps], sum(losses) / len(losses)


def round_update(params, clients, lr: float):
    """One FL round: every client's local SGD from ``params``, then the
    eq.-(13) mean weighted by the clients' pool sizes.  ``clients`` holds
    (xs, ys, pool size) per client.  Returns (new params, mean client
    loss)."""
    acc = [torch.zeros_like(p, dtype=torch.float32) for p in leaves(params)]
    total, losses = 0.0, []
    for xs, ys, n in clients:
        ps, loss = local_sgd(params, xs, ys, lr)
        for a, p in zip(acc, ps):
            a.add_(p.float(), alpha=float(n))
        total += float(n)
        losses.append(loss)
    return rebuild(params, [a / total for a in acc]), sum(losses) / len(
        losses)
