"""Plain RWKV6 (Finch, arXiv:2404.05892) language model, its loss, SGD
and the eq.-(13) mean over replicas, in float32 with no kernel.

A block is x += TimeMix(RMSNorm(x)); x += ChannelMix(RMSNorm(x)).
TimeMix: token shift, per-projection interpolation with the previous
token, r k v g and the decay's logit by (d, d) products, the decay
w = exp(-exp(logit + bias)) (handed on as its log), the WKV recurrence
per 64-wide head (:mod:`.wkv`) with the bonus u, an RMS norm of each head's output with
its scale, the SiLU(g) gate and the output product.  ChannelMix: token
shift, relu(k)^2 through d_ff and back, gated by sigmoid(r).  The
embedding, a final RMS norm, the output product and the mean
next-token cross-entropy, the logits in 512-position slices.

Weights are held in their configured type (bf16 matrices; float32
vectors and ``u``) and widened to float32 where used; an SGD step is
computed in float32 and rounded back to the leaf's type, and so is the
mean over replicas.  ``precision`` rounds both operands of every matrix
product, forward and backward (:mod:`.precision`).  Each block is checkpointed, so
the reference fits beside nothing but its own state.
"""
from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .precision import operand, result
from .wkv import wkv_chunked

LOSS_CHUNK = 512


def _mm(x, w, precision):
    return result(operand(x, precision) @ operand(w.to(x.dtype), precision),
                  precision)


def _rms(x, scale, eps=1e-6):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def _shift(x):
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)


def time_mix(p, x, precision=None):
    b, s, d = x.shape
    h = max(1, d // 64)
    hd = d // h
    xs = _shift(x)

    def mix(m):
        return x * m + xs * (1.0 - m)

    r = _mm(mix(p["mix_r"]), p["wr"], precision)
    k = _mm(mix(p["mix_k"]), p["wk"], precision)
    v = _mm(mix(p["mix_v"]), p["wv"], precision)
    g = _mm(mix(p["mix_g"]), p["wg"], precision)
    lw = -torch.exp(_mm(mix(p["mix_w"]), p["ww"], precision) + p["w_bias"])

    def heads(t):
        return t.reshape(b, s, h, hd).transpose(1, 2)

    o = wkv_chunked(heads(r), heads(k), heads(v), heads(lw), p["u"].to(x.dtype))
    o = _rms(o, p["ln_scale"])
    o = o.transpose(1, 2).reshape(b, s, d) * F.silu(g)
    return _mm(o, p["wo"], precision)


def channel_mix(p, x, precision=None):
    xs = _shift(x)
    xk = x * p["mix_k"] + xs * (1.0 - p["mix_k"])
    xr = x * p["mix_r"] + xs * (1.0 - p["mix_r"])
    k = torch.square(torch.relu(_mm(xk, p["wck"], precision)))
    return torch.sigmoid(_mm(xr, p["wcr"], precision)) * _mm(
        k, p["wcv"], precision)


def _block(sub, x, precision):
    x = x + time_mix(sub["mixer"]["time"], _rms(x, sub["norm1"]["scale"]),
                     precision)
    return x + channel_mix(sub["mixer"]["channel"],
                           _rms(x, sub["norm2"]["scale"]), precision)


def loss(params, batch, precision=None) -> torch.Tensor:
    """The mean next-token cross-entropy of ``batch``."""
    x = F.embedding(batch["inputs"], params["embed"]["w"]).float()
    for blk in params["blocks"]:
        x = checkpoint(_block, blk["sub0"], x, precision,
                       use_reentrant=False)
    h = _rms(x, params["final_norm"]["scale"])
    return loss_from_hidden(params, h, batch["labels"], precision)


def loss_from_hidden(params, h, labels, precision=None) -> torch.Tensor:
    """The mean cross-entropy of the final hidden states ``h``."""
    b, s, _ = h.shape
    total = torch.zeros((), dtype=h.dtype, device=h.device)
    for i in range(0, s, LOSS_CHUNK):
        logits = _mm(h[:, i:i + LOSS_CHUNK], params["lm_head"]["w"],
                     precision)
        total = total + F.cross_entropy(
            logits.reshape(-1, logits.shape[-1]),
            labels[:, i:i + LOSS_CHUNK].reshape(-1), reduction="sum")
    return total / (b * s)


def leaves(params) -> List[torch.Tensor]:
    out = []

    def walk(t):
        if isinstance(t, dict):
            for key in sorted(t):
                walk(t[key])
        elif isinstance(t, list):
            for x in t:
                walk(x)
        else:
            out.append(t)

    walk(params)
    return out


def paths(params) -> List[str]:
    """Every leaf's path, in :func:`leaves`' order."""
    out = []

    def walk(t, at):
        if isinstance(t, dict):
            for key in sorted(t):
                walk(t[key], f"{at}.{key}" if at else key)
        elif isinstance(t, list):
            for i, x in enumerate(t):
                walk(x, f"{at}[{i}]")
        else:
            out.append(at)

    walk(params, "")
    return out


def rebuild(params, flat):
    it = iter(flat)

    def walk(t):
        if isinstance(t, dict):
            return {key: walk(t[key]) for key in sorted(t)}
        if isinstance(t, list):
            return [walk(x) for x in t]
        return next(it)

    return walk(params)


def sgd_step(params, batch, lr: float, precision=None):
    """One SGD step: (new params in the leaves' types, the loss)."""
    ps = [p.detach().requires_grad_() for p in leaves(params)]
    value = loss(rebuild(params, ps), batch, precision)
    grads = torch.autograd.grad(value, ps)
    with torch.no_grad():
        new = [(p.float() - lr * g.float()).to(p.dtype)
               for p, g in zip(ps, grads)]
    return rebuild(params, new), float(value.detach())


def fl_round(params, batches: Dict[str, torch.Tensor], lr: float,
             h_local: int, precision=None):
    """Every replica's ``h_local`` SGD steps from ``params`` on its rows
    (``batches`` lead with the replica axis), then the mean over the
    replicas in float32, rounded to each leaf's type.  Returns (the new
    global params, the replicas' last losses averaged)."""
    n_rep = batches["inputs"].shape[0]
    acc = [torch.zeros_like(p, dtype=torch.float32) for p in leaves(params)]
    losses = []
    for r in range(n_rep):
        local = {k: batches[k][r] for k in ("inputs", "labels")}
        rep = params
        for _ in range(h_local):
            rep, value = sgd_step(rep, local, lr, precision)
        losses.append(value)
        for a, p in zip(acc, leaves(rep)):
            a.add_(p.float())
        del rep
    new = [(a / n_rep).to(p.dtype) for a, p in zip(acc, leaves(params))]
    return rebuild(params, new), sum(losses) / n_rep
