"""Plain RWKV6 (Finch) WKV recurrence, in float32 (or float64), with no
kernel.

Per head of size D, with the per-channel decay w_t = exp(lw_t) in (0, 1]:

    S_0 = 0,  o_t = r_t @ (S_t + diag(u) k_t v_t^T),
    S_{t+1} = diag(w_t) S_t + k_t v_t^T

:func:`wkv_scan` is the step-by-step recurrence (the oracle of the tests);
:func:`wkv_chunked` the same in chunks of 64 steps, sub-chunks of 16.
The chunked form's layout is that of ``wkv_chunked`` in
src/repro_torch/kernels/wkv6/ref.py at commit ed1d7aa, with one change:
it takes the log-decays lw, which the model has exactly (lw = -exp(logit
+ bias)), and forms every product of decays as the exponential of a sum
of them.  Against a float64 scan it agrees to ~1e-7 (float32) on
rwkv6-1.6b's inputs, forward and backward.
"""
from __future__ import annotations

import math

import torch


def wkv_scan(r, k, v, lw, u):
    """r, k, v, lw: (B, H, T, D); u: (H, D).  The recurrence, step by
    step, in r's type widened to float32 (float64 stays float64)."""
    b, h, t, d = r.shape
    dt = torch.float64 if r.dtype == torch.float64 else torch.float32
    s = torch.zeros((b, h, d, d), dtype=dt, device=r.device)
    out = []
    for i in range(t):
        kv = k[:, :, i, :, None].to(dt) * v[:, :, i, None, :].to(dt)
        out.append(torch.einsum("bhi,bhij->bhj", r[:, :, i].to(dt),
                                s + u.to(dt)[None, :, :, None] * kv))
        s = torch.exp(lw[:, :, i].to(dt))[..., None] * s + kv
    return torch.stack(out, dim=2)


def _excl(x):
    """Sum of x over the steps before each, along dim -2."""
    return torch.cumsum(x, dim=-2) - x


def _rexcl(x):
    """Sum of x over the steps after each, along dim -2."""
    return torch.flip(_excl(torch.flip(x, dims=[-2])), dims=[-2])


def wkv_chunked(r, k, v, lw, u, chunk: int = 64):
    """The chunked form (module docstring); returns (B, H, T, D) in
    float32, or float64 for float64 inputs.

    Within a sub-chunk, fwd_t = prod_{tau<t} w_tau, bwd_s = prod_{tau>s}
    w_tau, g = prod_tau w_tau.  Target t of sub-chunk i gets the cross
    term (r_t fwd_t prod_{q<i} g_q) @ S (S the chunk's state), the terms
    of earlier sub-chunks j < i through prod_{j<q<i} g_q, the terms
    within its sub-chunk through prod_{s<tau<t} w_tau per channel, and
    the bonus (sum_c r_t u k_t) v_t; the state moves a chunk at a time.
    """
    b, h, t, d = r.shape
    chunk = min(chunk, t)
    sub = math.gcd(chunk, 16)
    m = chunk // sub
    n = -(-t // chunk)
    dt = torch.float64 if r.dtype == torch.float64 else torch.float32

    def chunks(x):
        x = x.to(dt)
        if n * chunk > t:  # the padding only moves the state past the end
            x = torch.nn.functional.pad(x, (0, 0, 0, n * chunk - t))
        return x.reshape(b, h, n, m, sub, d)

    rf, kf, vf, lwf = (chunks(x) for x in (r, k, v, lw))
    lfwd = _excl(lwf)                                       # log fwd_t
    r_fwd = rf * torch.exp(lfwd)
    k_bwd = kf * torch.exp(_rexcl(lwf))
    lg = lwf.sum(dim=-2)                                    # (b,h,n,m,d)

    # within: log prod_{s<tau<t} w_tau = sum of lw over s < tau < t
    steps = torch.arange(sub, device=r.device)
    between = ((steps[None, :, None] < steps[None, None, :])
               & (steps[None, None, :] < steps[:, None, None]))  # [t,s,tau]
    ldecay = torch.einsum("tsq,bhnmqd->bhnmtsd", between.to(dt), lwf)
    scores = torch.einsum("bhnmtd,bhnmtsd->bhnmts", rf,
                          kf[..., None, :, :] * torch.exp(ldecay))
    bonus = torch.sum(rf * u.to(dt)[None, :, None, None, None, :] * kf,
                      dim=-1)
    scores = torch.tril(scores, diagonal=-1) + torch.diag_embed(bonus)
    out = torch.einsum("bhnmts,bhnmsd->bhnmtd", scores, vf)

    # earlier sub-chunks: log prod_{j<q<i} g_q for j < i
    subs = torch.arange(m, device=r.device)
    inside = ((subs[None, :, None] < subs[None, None, :])
              & (subs[None, None, :] < subs[:, None, None]))  # [i, j, q]
    lspan = torch.einsum("ijq,bhnqd->bhnijd", inside.to(dt), lg)
    span = torch.exp(lspan) * (subs[None, :] < subs[:, None])[..., None]
    k_ref = k_bwd[:, :, :, None] * span[..., None, :]      # [i, j, s]
    scores = torch.einsum("bhnitd,bhnijsd->bhnitjs", r_fwd, k_ref)
    out = out + torch.einsum("bhnitjs,bhnjsd->bhnitd", scores, vf)

    # cross and state, a chunk at a time
    lhead = _excl(lg)
    r_cross = r_fwd * torch.exp(lhead)[..., None, :]
    k_state = k_bwd * torch.exp(_rexcl(lg))[..., None, :]
    g_chunk = torch.exp(lg.sum(dim=-2))                     # (b,h,n,d)
    s = torch.zeros((b, h, d, d), dtype=dt, device=r.device)
    cross = []
    for i in range(n):
        cross.append(torch.einsum("bhmtd,bhde->bhmte", r_cross[:, :, i], s))
        s = g_chunk[:, :, i, :, None] * s + torch.einsum(
            "bhmsd,bhmse->bhde", k_state[:, :, i], vf[:, :, i])
    out = (out + torch.stack(cross, dim=2)).reshape(b, h, n * chunk, d)
    return out[:, :, :t]
