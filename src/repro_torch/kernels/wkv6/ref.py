"""Plain PyTorch versions of the RWKV6 (Finch) WKV recurrence.

Per head of dim d, with data-dependent per-channel decay w_t in (0,1):

    S_0 = 0                       (d x d state)
    o_t = r_t @ (S_t + diag(u) k_t v_t^T)
    S_{t+1} = diag(w_t) S_t + k_t v_t^T
"""
from __future__ import annotations

import math

import torch


def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
        u: torch.Tensor) -> torch.Tensor:
    """r,k,v,w: (B, H, T, D); u: (H, D). Returns (B, H, T, D) in r's type.

    The step-by-step scan, in f32: the oracle."""
    b, h, t, d = r.shape
    s = torch.zeros((b, h, d, d), dtype=torch.float32, device=r.device)
    outs = []
    for i in range(t):
        s, o = wkv_step(s, r[:, :, i], k[:, :, i], v[:, :, i], w[:, :, i],
                        u)
        outs.append(o)
    if not outs:
        return torch.empty_like(r)
    return torch.stack(outs, dim=2)


def wkv_step(s: torch.Tensor, r_t, k_t, v_t, w_t, u):
    """Single decode step. s: (B,H,D,D) f32; r_t..w_t: (B,H,D); u: (H,D).

    Returns (new_state, out (B,H,D) in r_t's type).
    """
    kv = torch.einsum("bhi,bhj->bhij", k_t.to(torch.float32),
                      v_t.to(torch.float32))
    o = torch.einsum("bhi,bhij->bhj", r_t.to(torch.float32),
                     s + u.to(torch.float32)[None, :, :, None] * kv)
    s_new = w_t.to(torch.float32)[..., None] * s + kv
    return s_new, o.to(r_t.dtype)


def _before(x: torch.Tensor) -> torch.Tensor:
    """prod of x over the steps before each, along dim -2 (1 at the
    first)."""
    ones = torch.ones_like(x[..., :1, :])
    return torch.cumprod(torch.cat([ones, x[..., :-1, :]], dim=-2), dim=-2)


def _after(x: torch.Tensor) -> torch.Tensor:
    """prod of x over the steps after each, along dim -2 (1 at the
    last)."""
    return torch.flip(_before(torch.flip(x, dims=[-2])), dims=[-2])


def wkv_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                w: torch.Tensor, u: torch.Tensor,
                chunk: int = 64) -> torch.Tensor:
    """Chunked *parallel* WKV, in f32: the plain twin of the CUDA kernel's
    chunked form (``csrc/wkv6.cu``).  Any T: the last chunk is padded and
    the padding dropped.

    T is cut into chunks of ``chunk`` steps and each chunk into
    sub-chunks of ``gcd(chunk, 16)``.  Within a sub-chunk, fwd_t =
    prod_{tau<t} w_tau (from its start to t), bwd_s = prod_{tau>s} w_tau
    (from s to its end) and g = prod_tau w_tau.  Target t of sub-chunk i
    of a chunk gets

      cross:   (r_t * fwd_t * prod_{q<i} g_q) @ S, S the chunk's state
      between: sum over s of sub-chunk j < i of ((r_t * fwd_t) .
               (k_s * bwd_s * prod_{j<q<i} g_q)) v_s, both sides
               referenced to the start of sub-chunk i
      within:  sum_{s<t} (sum_c r_t[c] k_s[c] prod_{s<tau<t} w_tau[c]) v_s
               in sub-chunk i, the decay per channel
      bonus:   (sum_c r_t[c] u[c] k_t[c]) v_t

    and the state moves a chunk at a time: S' = diag(prod_q g_q) S +
    sum_s (k_s * bwd_s * prod_{q>j(s)} g_q)^T v_s.  Every decay factor
    is a product of decays in [0, 1]: none overflows, and a decay of 0
    (or a product that underflows) gives the exact 0.  The reference's
    form (``repro/kernels/wkv6/ref.py``) divides k by the inclusive
    product clamped at 1e-30 instead, which is wrong once a chunk's
    product underflows.
    """
    b, h, t, d = r.shape
    if t == 0:
        return torch.empty_like(r)
    chunk = min(chunk, t)
    sub = math.gcd(chunk, 16)
    m = chunk // sub
    n = -(-t // chunk)
    f32 = torch.float32

    def chunks(x):
        x = x.to(f32)
        if n * chunk > t:  # the padding only moves the state past the end
            x = torch.nn.functional.pad(x, (0, 0, 0, n * chunk - t))
        return x.reshape(b, h, n, m, sub, d)

    rf, kf, vf, wf = (chunks(x) for x in (r, k, v, w))
    fwd = _before(wf)
    r_fwd = rf * fwd                                        # (b,h,n,m,sub,d)
    k_bwd = kf * _after(wf)
    g = fwd[..., -1, :] * wf[..., -1, :]                    # (b,h,n,m,d)

    # within: decay[t, s] = prod_{s+1<tau<=t} w_{tau-1}, a cumulative
    # product over t of the previous step's decay, from t = s + 2 on
    steps = torch.arange(sub, device=r.device)
    later = (steps[:, None] > steps[None, :] + 1)[..., None]  # [t, s]
    w_prev = torch.cat([torch.ones_like(wf[..., :1, :]), wf[..., :-1, :]],
                       dim=-2)
    decay = torch.cumprod(torch.where(later, w_prev[..., :, None, :], 1.0),
                          dim=-3)
    scores = torch.einsum("bhnmtd,bhnmtsd->bhnmts", rf,
                          kf[..., None, :, :] * decay)
    bonus = torch.sum(rf * u.to(f32)[None, :, None, None, None, :] * kf,
                      dim=-1)
    scores = torch.tril(scores, diagonal=-1) + torch.diag_embed(bonus)
    out = torch.einsum("bhnmts,bhnmsd->bhnmtd", scores, vf)

    # between: span[i, j] = prod_{j<q<i} g_q for j < i, else 0
    subs = torch.arange(m, device=r.device)
    inside = ((subs[None, :, None] < subs[None, None, :])
              & (subs[None, None, :] < subs[:, None, None]))  # [i, j, q]
    span = torch.where(inside[..., None], g[..., None, None, :, :],
                       1.0).prod(dim=-2)
    span = span * (subs[None, :] < subs[:, None])[..., None]
    k_ref = k_bwd[:, :, :, None] * span[..., None, :]      # [i, j, s]
    scores = torch.einsum("bhnitd,bhnijsd->bhnitjs", r_fwd, k_ref)
    out = out + torch.einsum("bhnitjs,bhnjsd->bhnitd", scores, vf)

    # cross and state, a chunk at a time
    head = _before(g)
    r_cross = r_fwd * head[..., None, :]
    k_state = k_bwd * _after(g)[..., None, :]
    g_chunk = head[..., -1, :] * g[..., -1, :]              # (b,h,n,d)
    s = torch.zeros((b, h, d, d), dtype=f32, device=r.device)
    cross = []
    for i in range(n):
        cross.append(torch.einsum("bhmtd,bhde->bhmte", r_cross[:, :, i], s))
        s = g_chunk[:, :, i, :, None] * s + torch.einsum(
            "bhmsd,bhmse->bhde", k_state[:, :, i], vf[:, :, i])
    out = (out + torch.stack(cross, dim=2)).reshape(b, h, n * chunk, d)
    return out[:, :, :t].to(r.dtype)


def _split(x: torch.Tensor) -> torch.Tensor:
    """x as the sum of its bfloat16 high and low parts (x to ~2**-17):
    what a tensor-core product of the kernel sees of an f32 operand."""
    hi = x.to(torch.bfloat16).to(torch.float32)
    return hi + (x - hi).to(torch.bfloat16).to(torch.float32)


def wkv_chunked_backward(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         w: torch.Tensor, u: torch.Tensor, do: torch.Tensor,
                         chunk: int = 64, sub: int = 16,
                         split: bool = False):
    """The gradients of :func:`wkv` by the chunked decomposition of the
    bf16 backward kernel (``csrc/wkv6_bwd.cu``), in f32: its plain twin.

    Returns (dr, dk, dv, dw, du) in r's type, as ``kernel.wkv_backward``.
    First the state S at the start of every ``chunk``-step chunk (forward)
    and its gradient dS at every chunk's end (reverse), each a chunk at a
    time; then, per chunk, the same at the ends of its ``sub``-step
    sub-chunks; then, per sub-chunk of steps st..e with S_0 at its start
    and dS_E at its end, with f_t = prod_{st<=tau<t} w_tau, b_t =
    prod_{t<tau<=e} w_tau, d(s, t) = prod_{s<tau<t} w_tau and
    M = dO V^T:

      dr_t = f_t (do_t S_0^T) + sum_{s<t} M[t,s] d(s,t) k_s + u k_t M[t,t]
      dk_s = b_s (v_s dS_E^T) + sum_{t>s} M[t,s] d(s,t) r_t + u r_s M[s,s]
      dv_s = (k_s b_s) dS_E + sum_{t>=s} A[t,s] do_t  (A: the forward's
             intra-sub-chunk scores, the bonus on the diagonal)
      dw_t = f_t b_t rowsum(dS_E S_0)                           (a)
           + b_t sum_{s<t} d(s,t) k_s (v_s dS_E^T)              (b)
           + f_t sum_{t'>t} d(t,t') r_t' (do_t' S_0^T)          (c)
           + sum_{s<t<t'} d(s,t) d(t,t') k_s r_t' M[t',s]       (d)

    with (d) by the scan U_{t+1}[t'] = w_t U_t[t'] + k_t M[t',t], (d)_t =
    sum_{t'>t} d(t,t') r_t' U_t[t'].  Every factor is a product of decays
    in [0, 1]; nothing divides by a decay, so decays of exactly 0 are
    exact.  ``split``: every f32 operand of what the kernel multiplies on
    the tensor cores (the states, r and k times their decays, A) is
    rounded to its bf16 high and low parts first, as the kernel does.
    """
    b, h, t, d = r.shape
    if chunk % sub:
        raise ValueError(f"chunk {chunk} is no multiple of sub {sub}")
    f32 = torch.float32
    op = _split if split else (lambda x: x)
    n, m = -(-t // chunk), chunk // sub

    def pad(x):  # the padding contributes nothing and is never returned
        x = x.to(f32)
        if n * chunk > t:
            x = torch.nn.functional.pad(x, (0, 0, 0, n * chunk - t))
        return x.reshape(b, h, n, chunk, d)

    rc, kc, vc, wc, dc = (pad(x) for x in (r, k, v, w, do))
    uf = u.to(f32)[None, :, None, None, None, :]

    # the state at every chunk's start and its gradient at every chunk's end
    g_chunk = wc.prod(dim=-2)
    k_end = op(kc * _after(wc))
    r_start = op(rc * _before(wc))
    s = torch.zeros((b, h, d, d), dtype=f32, device=r.device)
    ds = torch.zeros_like(s)
    s_start, ds_end = [], []
    for c in range(n):
        s_start.append(s)
        s = g_chunk[:, :, c, :, None] * s + torch.einsum(
            "bhsi,bhsj->bhij", k_end[:, :, c], vc[:, :, c])
    for c in reversed(range(n)):
        ds_end.append(ds)
        ds = g_chunk[:, :, c, :, None] * ds + torch.einsum(
            "bhti,bhtj->bhij", r_start[:, :, c], dc[:, :, c])
    ds_end.reverse()

    # the same at the sub-chunks' ends, within each chunk
    rs, ks, vs, ws, ds_ = (x.reshape(b, h, n, m, sub, d)
                           for x in (rc, kc, vc, wc, dc))
    f, bk = _before(ws), _after(ws)
    g = f[..., -1, :] * ws[..., -1, :]                     # (b,h,n,m,d)
    rf, kb = op(rs * f), op(ks * bk)
    s0 = [torch.stack(s_start, dim=2)]                     # (b,h,n,d,d)
    for p in range(m - 1):
        s0.append(g[:, :, :, p, :, None] * s0[-1] + torch.einsum(
            "bhnsi,bhnsj->bhnij", kb[:, :, :, p], vs[:, :, :, p]))
    dse = [torch.stack(ds_end, dim=2)]
    for p in range(m - 1, 0, -1):
        dse.insert(0, g[:, :, :, p, :, None] * dse[0] + torch.einsum(
            "bhnti,bhntj->bhnij", rf[:, :, :, p], ds_[:, :, :, p]))
    s0, dse = torch.stack(s0, dim=3), torch.stack(dse, dim=3)

    # d(s, t) per channel for s < t, else 0: [..., t, s, i]
    steps = torch.arange(sub, device=r.device)
    lower = steps[:, None] > steps[None, :]
    later = (steps[:, None] > steps[None, :] + 1)[..., None]
    w_prev = torch.cat([torch.ones_like(ws[..., :1, :]), ws[..., :-1, :]],
                       dim=-2)
    decay = torch.cumprod(torch.where(later, w_prev[..., :, None, :], 1.0),
                          dim=-3) * lower[..., None]

    mm = torch.einsum("...tj,...sj->...ts", ds_, vs)
    diag = torch.diagonal(mm, dim1=-2, dim2=-1)[..., None]  # v_t . do_t
    mm_low = mm * lower
    s0_op, dse_op = op(s0), op(dse)
    drc = torch.einsum("...tj,...ij->...ti", ds_, s0_op)
    dkc = torch.einsum("...sj,...ij->...si", vs, dse_op)
    a = torch.einsum("...ti,...tsi,...si->...ts", rs, decay, ks)
    a = a + torch.diag_embed((rs * uf * ks).sum(-1))
    dv = (torch.einsum("...si,...ij->...sj", kb, dse_op)
          + torch.einsum("...ts,...tj->...sj", op(a), ds_))
    dr = (f * drc + torch.einsum("...ts,...tsi,...si->...ti", mm_low, decay,
                                 ks) + uf * ks * diag)
    dk = (bk * dkc + torch.einsum("...ts,...tsi,...ti->...si", mm_low,
                                  decay, rs) + uf * rs * diag)

    rho = (s0_op * dse).sum(-1)[..., None, :]
    term_b = bk * torch.einsum("...tsi,...si->...ti", decay, ks * dkc)
    term_c = f * torch.einsum("...tsi,...ti->...si", decay, rs * drc)
    u_scan = torch.zeros_like(rs)                           # U_t[t']
    term_d = []
    for q in range(sub):
        term_d.append((decay[..., :, q, :] * rs * u_scan).sum(-2))
        u_scan = (ws[..., q, None, :] * u_scan
                  + ks[..., q, None, :] * mm[..., :, q, None])
    dw = f * bk * rho + term_b + term_c + torch.stack(term_d, dim=-2)
    du = (rs * ks * diag).sum(dim=(0, 2, 3, 4))

    def out(x):
        return x.reshape(b, h, n * chunk, d)[:, :, :t].to(r.dtype)

    return (out(dr), out(dk), out(dv), out(dw), du.to(r.dtype))
