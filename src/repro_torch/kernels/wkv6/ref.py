"""Plain PyTorch versions of the RWKV6 (Finch) WKV recurrence.

Per head of dim d, with data-dependent per-channel decay w_t in (0,1):

    S_0 = 0                       (d x d state)
    o_t = r_t @ (S_t + diag(u) k_t v_t^T)
    S_{t+1} = diag(w_t) S_t + k_t v_t^T
"""
from __future__ import annotations

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


def wkv_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                w: torch.Tensor, u: torch.Tensor,
                chunk: int = 64) -> torch.Tensor:
    """Chunked *parallel* WKV: the linear-attention chunk decomposition.

    Within a chunk of length C (exclusive decay products
    P_t = prod_{tau<t} w_tau, inclusive P^i_t = prod_{tau<=t} w_tau):

      intra: o_t += sum_{s<t} ((r_t*P_t) . (k_s/P^i_s)) v_s
             (lower-triangular (C,C) matmul)
      bonus: o_t += (sum_i r_t[i] u[i] k_t[i]) v_t
      cross: o_t += (r_t*P_t) @ S_chunk_start
      state: S' = diag(p_end) S + sum_s ((p_end/P^i_s) * k_s)^T v_s

    Sequential work drops from T steps to T/C chunk steps of matmuls.
    Numerics: f32; 1/P^i_s is bounded for the w = exp(-exp(x)) decays of
    RWKV6 with C <= 64.
    """
    b, h, t, d = r.shape
    chunk = min(chunk, t)
    if t % chunk:
        raise ValueError(f"sequence {t} is not a multiple of chunk {chunk}")
    n = t // chunk
    f32 = torch.float32
    rf = r.to(f32).reshape(b, h, n, chunk, d)
    kf = k.to(f32).reshape(b, h, n, chunk, d)
    vf = v.to(f32).reshape(b, h, n, chunk, d)
    wf = w.to(f32).reshape(b, h, n, chunk, d)
    uf = u.to(f32)

    # exclusive / inclusive cumulative decay products within each chunk
    p_excl = torch.cumprod(
        torch.cat([torch.ones_like(wf[..., :1, :]), wf[..., :-1, :]],
                  dim=-2), dim=-2)                          # (b,h,n,C,d)
    p_incl = p_excl * wf
    p_end = p_incl[..., -1, :]                              # (b,h,n,d)

    r_p = rf * p_excl
    # source s -> target t decay: prod_{tau=s+1}^{t-1} = P_excl[t]/P_incl[s]
    k_ip = kf / torch.clamp(p_incl, min=1e-30)
    intra_scores = torch.einsum("bhncd,bhned->bhnce", r_p, k_ip)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=r.device), diagonal=-1)
    intra = torch.einsum("bhnce,bhned->bhncd",
                         torch.where(mask, intra_scores, 0.0), vf)
    # bonus: o_t[j] += (sum_i r_t[i] u[i] k_t[i]) v_t[j]
    dot_ruk = torch.sum(rf * uf[None, :, None, None, :] * kf, dim=-1,
                        keepdim=True)                       # (b,h,n,C,1)
    bonus = dot_ruk * vf

    # cross-chunk state: source s feeds the next chunk with decay
    # prod_{tau=s+1}^{C-1} = p_end / P_incl[s]
    kw = (p_end[..., None, :] / torch.clamp(p_incl, min=1e-30)) * kf

    s = torch.zeros((b, h, d, d), dtype=f32, device=r.device)
    cross = []
    for c in range(n):
        cross.append(torch.einsum("bhcd,bhde->bhce", r_p[:, :, c], s))
        s = p_end[:, :, c, :, None] * s + torch.einsum(
            "bhcd,bhce->bhde", kw[:, :, c], vf[:, :, c])
    out = intra + bonus + torch.stack(cross, dim=2)
    return out.reshape(b, h, t, d).to(r.dtype)
