"""Plain PyTorch versions of causal (optionally sliding-window) GQA
attention: the exact form and a KV-blocked online-softmax form; and the
rows' log-sum-exp that the forward kernels hand to the backward."""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint


def _mask(rows: torch.Tensor, cols: torch.Tensor, causal: bool,
          window: Optional[int]) -> torch.Tensor:
    mask = torch.ones(rows.shape[0], cols.shape[1], dtype=torch.bool,
                      device=rows.device)
    if causal:
        mask = mask & (cols <= rows)
    if window is not None:
        mask = mask & (cols > rows - window)
    return mask


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True,
              window: Optional[int] = None) -> torch.Tensor:
    """q: (B, Hq, S, D); k, v: (B, Hkv, S, D); Hq % Hkv == 0.

    Returns (B, Hq, S, D) in q's type. ``window`` limits attention to the
    last ``window`` positions (sliding-window attention).
    """
    b, hq, s, d = q.shape
    group = hq // k.shape[1]
    kr = k.repeat_interleave(group, dim=1).to(torch.float32)
    vr = v.repeat_interleave(group, dim=1).to(torch.float32)
    scale = 1.0 / math.sqrt(d)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32), kr) * scale
    idx = torch.arange(s, device=q.device)
    mask = _mask(idx[:, None], idx[None, :], causal, window)
    scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    probs = probs / probs.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, vr)
    return out.to(q.dtype)


def row_lse(q: torch.Tensor, k: torch.Tensor, causal: bool = True,
            window: Optional[int] = None) -> torch.Tensor:
    """Each row's log-sum-exp of its scaled scores ``q . k / sqrt(D)`` over
    its allowed keys, in base 2 (``logsumexp * log2(e)``), as f32
    (B, Hq, S): what the forward kernels write for the backward, which
    takes P = 2^(scores * log2(e) - lse).  A row with no allowed key gives
    -inf (none exists below S: every row may see its own key)."""
    b, hq, s, d = q.shape
    kr = k.repeat_interleave(hq // k.shape[1], dim=1).to(torch.float32)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32), kr)
    idx = torch.arange(s, device=q.device)
    mask = _mask(idx[:, None], idx[None, :], causal, window)
    scores = (scores * (1.0 / math.sqrt(d))).masked_fill(~mask,
                                                          float("-inf"))
    return torch.logsumexp(scores, dim=-1) * math.log2(math.e)


def blocked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True, window: Optional[int] = None,
                      block: int = 1024) -> torch.Tensor:
    """Flash-style attention over KV blocks of ``block`` keys.

    Equal to :func:`attention` up to rounding, but never materializes the
    (S, S) score matrix: an online softmax with f32 running max ``m``,
    sum ``l`` and accumulator; rows with no unmasked key give 0.  Each
    block's step is checkpointed, so its gradient keeps one block's
    probabilities at a time.
    """
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    group = hq // hkv
    block = min(block, s)
    if s % block:
        raise ValueError(f"sequence {s} is not a multiple of block {block}")
    scale = 1.0 / math.sqrt(d)
    rows = torch.arange(s, device=q.device)[:, None]
    qf = q.to(torch.float32)

    def step(m, l, acc, j):
        sl = slice(j * block, (j + 1) * block)
        k_j = k[:, :, sl].to(torch.float32).repeat_interleave(group, dim=1)
        v_j = v[:, :, sl].to(torch.float32).repeat_interleave(group, dim=1)
        scores = torch.einsum("bhqd,bhkd->bhqk", qf, k_j) * scale
        cols = j * block + torch.arange(block, device=q.device)[None, :]
        mask = _mask(rows, cols, causal, window)
        scores = scores.masked_fill(~mask, -1e30)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        p = torch.exp(scores - m_new[..., None]).masked_fill(~mask, 0.0)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p,
                                                    v_j)
        return m_new, l, acc

    m = torch.full((b, hq, s), -1e30, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hq, s), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hq, s, d), dtype=torch.float32, device=q.device)
    # checkpoint the KV-block step, as the reference does: backward
    # recomputes the (S, block) probabilities instead of saving one per
    # block
    for j in range(s // block):
        m, l, acc = checkpoint(step, m, l, acc, j, use_reentrant=False)
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    return (acc / l[..., None]).to(q.dtype)
