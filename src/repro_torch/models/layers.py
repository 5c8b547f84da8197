"""Layer library of the transformer stack (plain-dict params, PyTorch).

The counterpart of the reference's ``models/layers.py``: RMSNorm /
non-parametric LN, RoPE (interleaved pairs), GQA attention (+qk-norm,
sliding window) with its one-token decode over a ring-buffer cache, MLA
(DeepSeek-V2's latent attention) with its decode over the latent cache,
SwiGLU, the routed MoE FFN (grouped and flat dispatch) with its Switch
aux loss, the Mamba block (depthwise causal conv, selective scan) with
its one-token decode, and the RWKV6 time / channel mix with their
decode forms.
GQA's full-sequence attention runs through ``kernels/flash_attention``
and the RWKV6 recurrence through ``kernels/wkv6``, whose gradients on
the card come from their backward kernels (the ops' autograd Functions);
MLA, the MoE FFN, the Mamba block (its selective scan included) and the
decode steps are plain torch, as they are plain jnp in the reference.

Weights keep the reference's ``(din, dout)`` layout, so every projection
is ``x @ W`` as in the reference, and the dtype casts follow the
reference's line for line: bf16 parity depends on them.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..kernels.flash_attention import ops as fa
from ..kernels.wkv6 import ops as wkv_ops
from ..sharding import activations as A
from ..sharding.activations import shard


class Init:
    """Leaf factory of ``init_params``: seeded normals scaled by
    ``1/sqrt(fan_in)`` as the reference's ``_init``, and constants.  On
    the ``meta`` device it allocates nothing and gives shapes only."""

    def __init__(self, seed: int, device: torch.device):
        self.device = device
        self.gen = (None if device.type == "meta" else
                    torch.Generator(device=device).manual_seed(seed))

    def normal(self, shape, scale_dim: int, dtype: torch.dtype):
        if self.gen is None:
            return torch.empty(shape, dtype=dtype, device=self.device)
        x = torch.randn(shape, generator=self.gen, device=self.device,
                        dtype=torch.float32)
        return (x * (1.0 / math.sqrt(scale_dim))).to(dtype)

    def full(self, shape, value: float):
        return torch.full(shape, value, dtype=torch.float32,
                          device=self.device)


def param_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


# ---------------------------------------------------------------------------
# Norms ----------------------------------------------------------------------
# ---------------------------------------------------------------------------
def rmsnorm_init(cfg: ModelConfig, init: Init, dim: Optional[int] = None):
    if cfg.norm_type == "nonparametric_ln":
        return {}
    return {"scale": init.full((dim or cfg.d_model,), 1.0)}


def norm_apply(params, x, cfg: ModelConfig):
    """Statistics in f32, the (broadcast) factor applied in x's type."""
    xf = x.to(torch.float32)
    if cfg.norm_type == "nonparametric_ln":
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, unbiased=False, keepdim=True)
        inv = torch.rsqrt(var + 1e-5)
        return (x - mu.to(x.dtype)) * inv.to(x.dtype)
    ms = (xf * xf).mean(dim=-1, keepdim=True)
    factor = torch.rsqrt(ms + 1e-6)
    return x * factor.to(x.dtype) * params["scale"].to(x.dtype)


def head_rmsnorm(x, scale):
    """qk-norm: RMS-normalize the head dim. x: (..., D_head)."""
    xf = x.to(torch.float32)
    ms = (xf * xf).mean(dim=-1, keepdim=True)
    factor = torch.rsqrt(ms + 1e-6)
    return x * factor.to(x.dtype) * scale.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE -----------------------------------------------------------------------
# ---------------------------------------------------------------------------
def rope_frequencies(dim: int, theta: float, device) -> torch.Tensor:
    # theta stays a Python scalar: a tensor made from it on the card
    # would be a blocking host-to-device copy in every layer
    exps = -torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return theta ** exps


def apply_rope(x, positions, theta: float):
    """x: (B, H, S, D); positions: (S,) or (B, S).

    Rotates the interleaved pairs ``(x[..., 0::2], x[..., 1::2])``;
    angles in f32, the rotation in x's type."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, x.device)               # (D/2,)
    ang = positions.to(torch.float32)[..., None] * freqs
    ang = ang[None, None] if positions.ndim == 1 else ang[:, None]
    cos = torch.cos(ang).to(x.dtype)
    sin = torch.sin(ang).to(x.dtype)
    x1, x2 = x[..., ::2], x[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape)


# ---------------------------------------------------------------------------
# GQA attention ---------------------------------------------------------------
# ---------------------------------------------------------------------------
def gqa_init(cfg: ModelConfig, init: Init):
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = param_dtype(cfg)
    p = {
        "wq": init.normal((d, hq * hd), d, dt),
        "wk": init.normal((d, hkv * hd), d, dt),
        "wv": init.normal((d, hkv * hd), d, dt),
        "wo": init.normal((hq * hd, d), hq * hd, dt),
    }
    if cfg.qk_norm:
        p["q_norm"] = init.full((hd,), 1.0)
        p["k_norm"] = init.full((hd,), 1.0)
    return p


def _split_heads(x, n_heads: int, head_dim: int):
    b, s, _ = x.shape
    return x.reshape(b, s, n_heads, head_dim).transpose(1, 2)


def attention_layout(n_q: int, n_kv: int) -> str:
    """How GQA's heads sit on the installed mesh's ``model`` axis (which
    is recorded, ``sharding.activations.note_layout``): ``"one"`` without
    a mesh; ``"split"`` where both head counts divide by it (each rank its
    own q heads and the kv heads they read); ``"kv_per_rank"`` where the
    q heads divide and a rank's q heads all read one kv head (the group is
    a multiple of a rank's q heads); else ``"gathered"``: the heads are
    gathered over ``model`` and each model rank computes all of them for
    its batch rows."""
    if A.current_mesh() is None:
        return "one"
    m = A.axis_size("model")
    if n_q % m == 0 and n_kv % m == 0:
        layout = "split"
    elif n_q % m == 0 and (n_q // n_kv) % (n_q // m) == 0:
        layout = "kv_per_rank"
    else:
        layout = "gathered"
    A.note_layout("attention", layout, n_q=n_q, n_kv=n_kv, model=m)
    return layout


def _sharded_attention(q, k, v, win, layout: str):
    """The attention kernel on each rank's local shards (``layout`` from
    :func:`attention_layout`; without a mesh, on q, k, v themselves): q,
    k, v split over the batch axes, and the heads as the layout says.
    Under ``"kv_per_rank"`` k and v arrive whole over ``model`` and each
    rank takes the one kv head its q heads read; their gradients are then
    partial sums over ``model``."""
    heads = "model" if layout == "split" else None
    q_heads = "model" if layout in ("split", "kv_per_rank") else None
    partial = ()
    if layout == "kv_per_rank":
        mesh = A.current_mesh()
        group = q.shape[1] // k.shape[1]
        j = mesh.get_local_rank("model") * (q.shape[1]
                                            // A.axis_size("model")) // group

        def fn(ql, kl, vl):
            return fa.attention(ql, kl[:, j:j + 1].contiguous(),
                                vl[:, j:j + 1].contiguous(), causal=True,
                                window=win)
        partial = ((), ("model",), ("model",))
    else:
        def fn(ql, kl, vl):
            return fa.attention(ql, kl, vl, causal=True, window=win)
    return A.local_call(fn, (q.contiguous(), k.contiguous(), v.contiguous()),
                        (("batch", q_heads, None, None),
                         ("batch", heads, None, None),
                         ("batch", heads, None, None)),
                        ("batch", q_heads, None, None), partial)


def _merged(o, heads: Optional[str]):
    """The heads' outputs merged to (B, S, H * D), split over ``model``
    for the row-parallel output projection.  Where the heads were
    gathered (``heads`` None) the merge is first pinned whole, so that its
    gradient is whole again before it is split back into heads."""
    if heads is None:
        o = shard(o, "batch", None, None)
    return shard(o, "batch", None, "model")


def gqa_apply(p, x, cfg: ModelConfig, positions,
              window: Optional[int] = None):
    """Full-sequence causal attention (prefill), through the kernel on a
    CUDA tensor (:func:`_sharded_attention`: on local shards under a
    mesh).  ``window`` defaults to ``cfg.sliding_window``."""
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    layout = attention_layout(hq, hkv)
    q_spec = "model" if layout in ("one", "split", "kv_per_rank") else None
    kv_spec = "model" if layout in ("one", "split") else None
    q = _split_heads(shard(x @ p["wq"], "batch", None, q_spec), hq, hd)
    k = _split_heads(shard(x @ p["wk"], "batch", None, kv_spec), hkv, hd)
    v = _split_heads(shard(x @ p["wv"], "batch", None, kv_spec), hkv, hd)
    if cfg.qk_norm:
        q = head_rmsnorm(q, p["q_norm"])
        k = head_rmsnorm(k, p["k_norm"])
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    win = window if window is not None else cfg.sliding_window
    o = _sharded_attention(q, k, v, win, layout)
    b, _, s, _ = o.shape
    o = _merged(o.transpose(1, 2).reshape(b, s, hq * hd), q_spec)
    return shard(o @ p["wo"], "batch", None, None)


def gqa_init_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype,
                   device):
    shape = (batch, cfg.n_kv_heads, cache_len, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def gqa_decode(p, x, cache, pos: int, cfg: ModelConfig):
    """One-token decode. x: (B, 1, D); cache k/v: (B, Hkv, L, hd).

    ``pos`` is the absolute position of the new token; the cache is a
    ring buffer and the new k/v go to slot ``pos % L``, written into the
    cache's tensors in place (the counterpart of the reference's donated
    cache).  Returns (out (B, 1, D), cache).
    """
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    b = x.shape[0]
    # under a mesh the new token's heads are gathered: the cache splits
    # its sequence, not its heads
    q = _split_heads(shard(x @ p["wq"], "batch", None, None), hq, hd)
    k = _split_heads(shard(x @ p["wk"], "batch", None, None), hkv, hd)
    v = _split_heads(shard(x @ p["wv"], "batch", None, None), hkv, hd)
    if cfg.qk_norm:
        q = head_rmsnorm(q, p["q_norm"])
        k = head_rmsnorm(k, p["k_norm"])
    posv = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q = apply_rope(q, posv, cfg.rope_theta)
    k = apply_rope(k, posv, cfg.rope_theta)
    cache_len = cache["k"].shape[2]
    slot = pos % cache_len
    A.write_slot(cache["k"], 2, slot, k[:, :, 0])
    A.write_slot(cache["v"], 2, slot, v[:, :, 0])
    # slots written so far: <= pos and (ring) within the window
    valid = torch.arange(cache_len, device=x.device) < min(pos + 1,
                                                           cache_len)
    # (B, Hkv, group, hd): query head h reads kv head h // group, as the
    # reference's repeat does, without copying the cache per query head
    group = hq // hkv
    qg = q.to(torch.float32).reshape(b, hkv, group, hd)
    scores = torch.einsum("bhgd,bhkd->bhgk", qg,
                          cache["k"].to(torch.float32)) / math.sqrt(hd)
    scores = scores.masked_fill(~valid, -1e30)
    probs = torch.softmax(scores, dim=-1)
    o = torch.einsum("bhgk,bhkd->bhgd", probs, cache["v"].to(torch.float32))
    o = shard(o.to(x.dtype).reshape(b, 1, hq * hd), "batch", None, "model")
    return o @ p["wo"], cache


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention, DeepSeek-V2) ------------------------------
# ---------------------------------------------------------------------------
def mla_init(cfg: ModelConfig, init: Init):
    d, h = cfg.d_model, cfg.n_heads
    r = cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    dt = param_dtype(cfg)
    return {
        "wq": init.normal((d, h * (dn + dr)), d, dt),
        "wkv_a": init.normal((d, r + dr), d, dt),   # latent + shared rope key
        "wkv_b": init.normal((r, h * (dn + dv)), r, dt),
        "wo": init.normal((h * dv, d), h * dv, dt),
        "kv_norm": init.full((r,), 1.0),
    }


def heads_spec(n_heads: int, what: str) -> Optional[str]:
    """The spec token of a head dim of ``n_heads`` heads: ``"model"``
    where they split evenly over the installed mesh's ``model`` axis (and
    without a mesh), else ``None``: gathered, every model rank computes
    all of them (recorded as ``what``'s layout)."""
    if A.current_mesh() is None:
        return "model"
    m = A.axis_size("model")
    split = n_heads % m == 0
    A.note_layout(what, "split" if split else "gathered", n_heads=n_heads,
                  model=m)
    return "model" if split else None


def _mla_qkv(p, x, cfg: ModelConfig, positions, hs="model"):
    h = cfg.n_heads
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    b, s, _ = x.shape
    q = shard(x @ p["wq"], "batch", None, hs).reshape(
        b, s, h, dn + dr).transpose(1, 2)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    kv = x @ p["wkv_a"]                                   # (B,S,r+dr)
    c_kv, k_rope = kv[..., :cfg.kv_lora_rank], kv[..., cfg.kv_lora_rank:]
    c_kv = head_rmsnorm(c_kv, p["kv_norm"])
    k_rope = apply_rope(k_rope[:, None], positions, cfg.rope_theta)
    return q_nope, q_rope, c_kv, k_rope                  # k_rope (B,1,S,dr)


def _mla_attend(p, q_nope, q_rope, c_kv, k_rope, mask, cfg: ModelConfig,
                hs="model"):
    """Attention over the latent cache, in f32.

    q_nope: (B,H,Sq,dn); q_rope: (B,H,Sq,dr); c_kv: (B,Skv,r); k_rope:
    (B,1,Skv,dr); mask: broadcasts to (B,H,Sq,Skv), True where a key is
    seen.  Key decompression is folded into the query (q_nope @ wk_b), so
    the scores are taken over the rank-r latent, as the reference's.
    ``hs`` is the heads' spec token under a mesh (:func:`heads_spec`)."""
    h = cfg.n_heads
    dn, dv = cfg.qk_nope_head_dim, cfg.v_head_dim
    r = cfg.kv_lora_rank
    wkv_b = shard(p["wkv_b"], None, hs).reshape(r, h, dn + dv).to(
        torch.float32)
    wk_b, wv_b = wkv_b[..., :dn], wkv_b[..., dn:]         # (r,H,dn),(r,H,dv)
    c = c_kv.to(torch.float32)
    q_lat = torch.einsum("bhsd,rhd->bhsr", q_nope.to(torch.float32), wk_b)
    # k_rope's one head as an einsum over batch rows, not a broadcast
    # matmul: that flattens (B, H) into one dim, which DTensor refuses
    # when both are split (batch over data, heads over model)
    scores = (torch.einsum("bhsr,btr->bhst", q_lat, c)
              + torch.einsum("bhsd,btd->bhst", q_rope.to(torch.float32),
                             k_rope[:, 0].to(torch.float32)))
    scores = scores / math.sqrt(dn + cfg.qk_rope_head_dim)
    scores = scores.masked_fill(~mask, -1e30)
    probs = torch.softmax(scores, dim=-1)
    o_lat = torch.einsum("bhst,btr->bhsr", probs, c)
    return torch.einsum("bhsr,rhd->bhsd", o_lat, wv_b)


def mla_apply(p, x, cfg: ModelConfig, positions):
    """Full-sequence causal MLA (prefill), plain torch as in the
    reference (it does not go through the attention kernel)."""
    b, s, _ = x.shape
    hs = heads_spec(cfg.n_heads, "mla")
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(p, x, cfg, positions, hs)
    idx = torch.arange(s, device=x.device)
    mask = idx[None, :] <= idx[:, None]
    o = _mla_attend(p, q_nope, q_rope, c_kv, k_rope, mask, cfg, hs)
    o = o.to(x.dtype).transpose(1, 2).reshape(b, s,
                                              cfg.n_heads * cfg.v_head_dim)
    return _merged(o, hs) @ p["wo"]


def mla_init_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype,
                   device):
    return {
        "c_kv": torch.zeros((batch, cache_len, cfg.kv_lora_rank),
                            dtype=dtype, device=device),
        "k_rope": torch.zeros((batch, cache_len, cfg.qk_rope_head_dim),
                              dtype=dtype, device=device),
    }


def mla_decode(p, x, cache, pos: int, cfg: ModelConfig):
    """One-token MLA decode. x: (B, 1, D); cache c_kv: (B, L, r), k_rope:
    (B, L, dr).  The new latent and rope key go to slot ``pos`` (the
    reference's ``dynamic_update_slice``, which clamps the slot to
    L - 1), written into the cache's tensors in place.  Returns
    (out (B, 1, D), cache)."""
    b = x.shape[0]
    hs = heads_spec(cfg.n_heads, "mla")
    posv = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(p, x, cfg, posv, hs)
    cache_len = cache["c_kv"].shape[1]
    slot = min(pos, cache_len - 1)
    A.write_slot(cache["c_kv"], 1, slot, c_kv[:, 0])
    A.write_slot(cache["k_rope"], 1, slot, k_rope[:, 0, 0])
    valid = torch.arange(cache_len, device=x.device) <= pos
    o = _mla_attend(p, q_nope, q_rope, cache["c_kv"],
                    cache["k_rope"][:, None], valid, cfg, hs)
    o = o.to(x.dtype).transpose(1, 2).reshape(b, 1,
                                              cfg.n_heads * cfg.v_head_dim)
    return _merged(o, hs) @ p["wo"], cache


# ---------------------------------------------------------------------------
# FFN -------------------------------------------------------------------------
# ---------------------------------------------------------------------------
def swiglu_init(cfg: ModelConfig, init: Init, d_ff: Optional[int] = None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    dt = param_dtype(cfg)
    return {"w1": init.normal((d, f), d, dt),
            "w3": init.normal((d, f), d, dt),
            "w2": init.normal((f, d), f, dt)}


def swiglu_apply(p, x):
    h = F.silu(x @ p["w1"]) * (x @ p["w3"])
    if h.ndim == 3:
        h = shard(h, "batch", None, "model")
    return h @ p["w2"]


def moe_init(cfg: ModelConfig, init: Init):
    d, e = cfg.d_model, cfg.n_experts
    f = cfg.moe_d_ff or cfg.d_ff
    dt = param_dtype(cfg)
    p = {
        "router": init.normal((d, e), d, torch.float32),
        "we1": init.normal((e, d, f), d, dt),
        "we3": init.normal((e, d, f), d, dt),
        "we2": init.normal((e, f, d), f, dt),
    }
    if cfg.n_shared_experts:
        p["shared"] = swiglu_init(cfg, init, d_ff=f * cfg.n_shared_experts)
    return p


def _route(p, xt, k: int):
    """Top-k routing of tokens ``xt`` (..., D): the router in f32 (the
    reference's ``x @ router`` promotes bf16 to f32), softmax, top-k, the
    k weights renormalized.  Returns (top_w, top_i), (..., k)."""
    probs = torch.softmax(xt.to(torch.float32) @ p["router"], dim=-1)
    top_w, top_i = torch.topk(probs, k, dim=-1)
    return top_w / top_w.sum(dim=-1, keepdim=True), top_i


def _experts(p, xe, spec: str):
    """The routed SwiGLU experts over dispatched tokens ``xe`` (``spec``
    names its axes, the expert axis ``e``, features last)."""
    lhs = spec[:-1]
    h = (F.silu(torch.einsum(f"{spec},edf->{lhs}f", xe, p["we1"]))
         * torch.einsum(f"{spec},edf->{lhs}f", xe, p["we3"]))
    return torch.einsum(f"{lhs}f,efd->{spec}", h, p["we2"])


def _moe_grouped(p, x, cfg: ModelConfig, e_lo: int = 0):
    """The grouped dispatch's routed output (B, S, D): routing and
    capacity per sequence; each expert takes its ``cap`` most-preferred
    tokens of the row, and each token gathers its k experts' outputs
    back (both directions gathers).  ``p["we*"]`` may hold only the
    experts ``e_lo, e_lo + 1, ...`` (a rank's share under a mesh): the
    output then sums only their contributions."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.n_experts_active
    n_local = p["we1"].shape[0]
    top_w, top_i = _route(p, x, k)                            # (B,S,k)
    gates = torch.zeros((b, s, e), dtype=torch.float32,
                        device=x.device).scatter(-1, top_i, top_w)
    cap = max(1, min(s, int(k * s / e * cfg.capacity_factor)))
    g_bet = gates.detach().transpose(1, 2)                    # (B,E,S)
    # each expert's preference order over the row (stable, as
    # jnp.argsort), and every token's rank in it: index math only
    order = torch.argsort(-g_bet, dim=-1, stable=True)
    ranks = torch.empty_like(order).scatter_(
        -1, order, torch.arange(s, device=x.device).expand_as(order))
    rows = torch.arange(b, device=x.device)[:, None, None]
    sel_i = order[:, e_lo:e_lo + n_local, :cap]               # (B,E,C)
    xe = x.reshape(b * s, d)[rows * s + sel_i]                # (B,E,C,D)
    ye = _experts(p, xe, "becd").to(x.dtype)                  # (B,E,C,D)
    # combine: token (b, s) finds its slot in each chosen expert
    slot = ranks.transpose(1, 2).gather(2, top_i)             # (B,S,k)
    valid = slot < cap
    if n_local == e:
        idx = top_i * cap + torch.clamp(slot, max=cap - 1)
    else:
        valid = valid & (top_i >= e_lo) & (top_i < e_lo + n_local)
        idx = (torch.clamp(top_i - e_lo, 0, n_local - 1) * cap
               + torch.clamp(slot, max=cap - 1))
    yi = ye.reshape(b * n_local * cap, d)[rows * (n_local * cap) + idx]
    w = (top_w * valid.to(torch.float32))[..., None]
    return torch.sum(w.to(yi.dtype) * yi, dim=2)              # (B,S,D)


def _moe_flat(p, x, cfg: ModelConfig, e_lo: int = 0):
    """The flat dispatch's routed output (B, S, D): tokens of the whole
    batch flattened, a global capacity, each expert its top-``cap``
    gates, combined with a scatter-add.  ``e_lo`` as in
    :func:`_moe_grouped`."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.n_experts_active
    n_local = p["we1"].shape[0]
    t = b * s
    xt = x.reshape(t, d)
    top_w, top_i = _route(p, xt, k)                           # (T,k)
    gates = torch.zeros((t, e), dtype=torch.float32,
                        device=x.device).scatter(-1, top_i, top_w)
    cap = max(1, min(t, int(k * t / e * cfg.capacity_factor)))
    # each expert's top-cap gates; where fewer than cap tokens chose it,
    # it also takes tokens at gate 0 (which ones is unspecified, in either
    # package), whose outputs are weighted by 0
    sel_w, sel_i = torch.topk(gates.T, cap, dim=-1)           # (E,C)
    sel_w, sel_i = sel_w[e_lo:e_lo + n_local], sel_i[e_lo:e_lo + n_local]
    ye = _experts(p, xt[sel_i], "ecd")                        # (E,C,D)
    ye = ye * sel_w[..., None].to(ye.dtype)
    out = torch.zeros((t, d), dtype=ye.dtype, device=x.device).index_add(
        0, sel_i.reshape(-1), ye.reshape(-1, d))
    return out.reshape(b, s, d)


def _moe_sharded(p, x, cfg: ModelConfig, grouped: bool):
    """The routed experts, under a mesh on each rank's local shards.  The
    experts split over ``model`` where their count divides by it (each
    rank computes its own; the output is a partial sum, all-reduced over
    ``model``), else every model rank computes all of them.  The grouped
    dispatch routes each rank's own batch rows (routing is per sequence,
    so this is exact); the flat one routes the gathered batch, as its
    capacity is global over the batch."""
    mesh = A.current_mesh()
    e, m = cfg.n_experts, A.axis_size("model")
    split = e % m == 0
    A.note_layout("moe", "experts_split" if split else "experts_gathered",
                  n_experts=e, model=m)
    es = "model" if split else None
    rank = mesh.get_local_rank("model") if m > 1 else 0
    core = _moe_grouped if grouped else _moe_flat

    def fn(xl, router, we1, we3, we2):
        q = {"router": router, "we1": we1, "we3": we3, "we2": we2}
        return core(q, xl, cfg, rank * we1.shape[0] if split else 0)

    bx = "batch" if grouped else None
    rows = A.batch_split_axes() if grouped else ()
    mp = ("model",) if split else ()
    out = A.local_call(
        fn, (x, p["router"], p["we1"], p["we3"], p["we2"]),
        ((bx, None, None), (None, None), (es, None, None), (es, None, None),
         (es, None, None)),
        (bx, None, None), (mp, rows + mp, rows, rows, rows),
        out_partial=mp)
    return shard(out, "batch", None, None)


def moe_apply(p, x, cfg: ModelConfig):
    """Top-k routed experts with capacity-based dispatch; tokens beyond an
    expert's capacity drop to the shared experts (or to nothing).

    Two dispatch paths, as the reference's (both plain torch there and
    here, no kernel): grouped (``cfg.moe_grouped`` and S > 1,
    :func:`_moe_grouped`) and flat (otherwise, every decode step,
    :func:`_moe_flat`).  Gathers index the flattened tokens, so their
    backward is an ``index_add`` into (tokens, D), not a (B, E, S, D)
    buffer.  Under a mesh, on local shards (:func:`_moe_sharded`)."""
    grouped = cfg.moe_grouped and x.shape[1] > 1
    out = _moe_sharded(p, x, cfg, grouped)
    if cfg.n_shared_experts:
        out = out + swiglu_apply(p["shared"], x)
    return out.to(x.dtype)


def moe_aux_loss(p, x, cfg: ModelConfig):
    """Switch-style load-balance loss (importance x load) of the tokens
    ``x`` (B, S, D), in f32."""
    xt = x.reshape(-1, x.shape[-1])
    probs = torch.softmax(xt.to(torch.float32) @ p["router"], dim=-1)
    importance = probs.mean(dim=0)
    top1 = probs.argmax(dim=-1)
    load = F.one_hot(top1, cfg.n_experts).to(torch.float32).mean(dim=0)
    return cfg.n_experts * torch.sum(importance * load)


# ---------------------------------------------------------------------------
# Mamba -----------------------------------------------------------------------
# ---------------------------------------------------------------------------
def mamba_init(cfg: ModelConfig, init: Init):
    d = cfg.d_model
    di = cfg.expand * d
    st, ck = cfg.d_state, cfg.d_conv
    dt = param_dtype(cfg)
    dt_rank = max(1, d // 16)
    a_log = torch.log(torch.arange(1, st + 1, dtype=torch.float32,
                                   device=init.device))
    return {
        "in_proj": init.normal((d, 2 * di), d, dt),
        "conv_w": init.normal((ck, di), ck, torch.float32),
        "conv_b": init.full((di,), 0.0),
        "x_proj": init.normal((di, dt_rank + 2 * st), di, dt),
        "dt_proj": init.normal((dt_rank, di), dt_rank, torch.float32),
        "dt_bias": init.full((di,), -4.6),  # softplus^-1(0.01)
        "a_log": a_log.repeat(di, 1),
        "d_skip": init.full((di,), 1.0),
        "out_proj": init.normal((di, d), di, dt),
    }


def _scan_steps(h, u, dt, b_t, c_t, a):
    """The recurrence h <- exp(dt a) h + (dt u) b, y = h . c, one step at
    a time over the leading (time) axis of u, dt: (T, B, di) and b_t,
    c_t: (T, B, st), from the state h (B, di, st).  Returns (the last
    state, y (T, B, di)).  Every factor is a single step's decay
    exp(dt a) <= 1, so the result is right at any decay."""
    da = torch.exp(dt[..., None] * a)                     # (T,B,di,st)
    dbu = (dt * u)[..., None] * b_t[:, :, None, :]
    hs = []
    for da_t, dbu_t in zip(da.unbind(0), dbu.unbind(0)):
        h = torch.addcmul(dbu_t, da_t, h)
        hs.append(h)
    ys = torch.einsum("tbdn,tbn->tbd", torch.stack(hs), c_t)
    return h, ys


def _mamba_ssm_scan(u, dt, b_t, c_t, a, chunk: int = 0):
    """Selective-state-space scan, in f32.

    u, dt: (B, S, di); b_t, c_t: (B, S, st); a: (di, st).  Returns
    y (B, S, di).

    ``chunk`` = 0 is one per-step scan over the sequence (the oracle).
    ``chunk`` > 0 runs the same per-step recurrence chunk by chunk, each
    chunk checkpointed while grad is on (the reference's
    ``jax.checkpoint(chunk_body)``): backward keeps only the (B, di, st)
    state at chunk boundaries and recomputes the steps inside.  Both
    forms multiply by one step's decay at a time and never divide by a
    product of decays, so they agree at any decay; the reference's
    chunked form divides by a cumulative product and departs from its
    own per-step form once decays are strong.  S <= chunk or S not a
    multiple of it falls back to the per-step form, as the reference's.
    """
    b, s, di = u.shape
    h = torch.zeros((b, di, a.shape[1]), dtype=torch.float32,
                    device=u.device)
    # time-major, as the reference's transposes
    u, dt, b_t, c_t = (t.transpose(0, 1).contiguous()
                       for t in (u, dt, b_t, c_t))
    if not chunk or s <= chunk or s % chunk:
        return _scan_steps(h, u, dt, b_t, c_t, a)[1].transpose(0, 1)
    ys = []
    for i in range(0, s, chunk):
        part = (h, u[i:i + chunk], dt[i:i + chunk], b_t[i:i + chunk],
                c_t[i:i + chunk], a)
        if torch.is_grad_enabled():
            h, y = checkpoint(_scan_steps, *part, use_reentrant=False)
        else:
            h, y = _scan_steps(*part)
        ys.append(y)
    return torch.cat(ys).transpose(0, 1)


def _mamba_dt_bc(p, xi, x_dtype, st: int):
    """dt = softplus(dt_proj(...) + dt_bias), B and C of the conv's output
    ``xi`` (f32), as the reference: x_proj in the model's type, the rest
    in f32."""
    dt_rank = p["dt_proj"].shape[0]
    # under a mesh ``xi``'s channels split over ``model``: the partial
    # sums are all-reduced here
    proj = shard((xi.to(x_dtype) @ p["x_proj"]).to(torch.float32),
                 "batch", *(None,) * (xi.ndim - 1))
    dt = F.softplus(proj[..., :dt_rank] @ p["dt_proj"] + p["dt_bias"])
    return (dt, proj[..., dt_rank:dt_rank + st],
            proj[..., dt_rank + st:])


def _causal_conv(x, w, b):
    """The depthwise causal conv over the sequence: x (B, S, C) with
    ``w``'s taps (K, C) and bias ``b`` (C,)."""
    s, k = x.shape[1], w.shape[0]
    xpad = F.pad(x, (0, 0, k - 1, 0))
    return sum(xpad[:, i:i + s] * w[i] for i in range(k)) + b


def mamba_apply(p, x, cfg: ModelConfig):
    """The Mamba mixer over a full sequence (prefill), plain torch as in
    the reference: in_proj, the depthwise causal conv over ``d_conv``
    taps (f32), SiLU, the selective scan, the skip term, the SiLU(z)
    gate, out_proj."""
    di = cfg.expand * x.shape[-1]
    xz = shard(x @ p["in_proj"], "batch", None, "model")
    xi = shard(xz[..., :di], "batch", None, "model")
    z = shard(xz[..., di:], "batch", None, "model")
    # channel-wise too, so each rank convolves its own shards (DTensor's
    # rule for the pad fails on a split batch under torch 2.11)
    batch = A.batch_split_axes()
    xi = F.silu(A.local_call(
        _causal_conv, (xi.to(torch.float32), p["conv_w"], p["conv_b"]),
        (("batch", None, "model"), (None, "model"), ("model",)),
        ("batch", None, "model"), ((), batch, batch)))
    dt, b_t, c_t = _mamba_dt_bc(p, xi, x.dtype, cfg.d_state)
    a = -torch.exp(p["a_log"])
    # channel-wise: under a mesh each rank scans its own channels of di
    y = A.local_call(
        lambda *t: _mamba_ssm_scan(*t, chunk=cfg.mamba_scan_chunk),
        (xi, dt, b_t, c_t, a),
        (("batch", None, "model"), ("batch", None, "model"),
         ("batch", None, None), ("batch", None, None), ("model", None)),
        ("batch", None, "model"),
        ((), (), ("model",), ("model",), A.batch_split_axes()))
    y = y + xi * p["d_skip"]
    y = y * F.silu(z.to(torch.float32))
    return y.to(x.dtype) @ p["out_proj"]


def mamba_init_cache(cfg: ModelConfig, batch: int, dtype, device):
    di = cfg.expand * cfg.d_model
    return {
        "h": torch.zeros((batch, di, cfg.d_state), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((batch, cfg.d_conv - 1, di), dtype=dtype,
                            device=device),
    }


def mamba_decode(p, x, cache, cfg: ModelConfig):
    """One-token decode. x: (B, 1, D); cache h: (B, di, st) f32, conv:
    (B, d_conv - 1, di), the last inputs of the conv.  Returns
    (out (B, 1, D), new cache)."""
    di = cfg.expand * cfg.d_model
    xz = x[:, 0] @ p["in_proj"]
    xi = shard(xz[..., :di], "batch", "model")
    z = shard(xz[..., di:], "batch", "model")
    hist = torch.cat([cache["conv"].to(torch.float32),
                      xi.to(torch.float32)[:, None]], dim=1)
    conv = torch.einsum("bkd,kd->bd", hist, p["conv_w"])
    xi_c = F.silu(conv + p["conv_b"])
    dt, b_t, c_t = _mamba_dt_bc(p, xi_c, x.dtype, cfg.d_state)
    a = -torch.exp(p["a_log"])
    h = torch.addcmul((dt * xi_c)[..., None] * b_t[:, None, :],
                      torch.exp(dt[..., None] * a), cache["h"])
    y = torch.einsum("bdn,bn->bd", h, c_t)
    y = y + xi_c * p["d_skip"]
    y = y * F.silu(z.to(torch.float32))
    out = y.to(x.dtype) @ p["out_proj"]
    return out[:, None], {"h": h,
                          "conv": hist[:, 1:].to(cache["conv"].dtype)}


# ---------------------------------------------------------------------------
# RWKV6 -----------------------------------------------------------------------
# ---------------------------------------------------------------------------
def _rwkv_heads(cfg: ModelConfig):
    h = max(1, cfg.d_model // 64)
    return h, cfg.d_model // h


def rwkv6_init(cfg: ModelConfig, init: Init):
    d = cfg.d_model
    h, hd = _rwkv_heads(cfg)
    dt = param_dtype(cfg)
    return {
        "time": {
            "mix_r": init.full((d,), 0.5),
            "mix_k": init.full((d,), 0.5),
            "mix_v": init.full((d,), 0.5),
            "mix_w": init.full((d,), 0.5),
            "mix_g": init.full((d,), 0.5),
            "wr": init.normal((d, d), d, dt),
            "wk": init.normal((d, d), d, dt),
            "wv": init.normal((d, d), d, dt),
            "ww": init.normal((d, d), d, dt),      # data-dependent decay
            "wg": init.normal((d, d), d, dt),
            "w_bias": init.full((d,), -2.0),
            "u": init.normal((h, hd), hd, torch.float32),
            "wo": init.normal((d, d), d, dt),
            "ln_scale": init.full((hd,), 1.0),
        },
        "channel": {
            "mix_k": init.full((d,), 0.5),
            "mix_r": init.full((d,), 0.5),
            "wck": init.normal((d, cfg.d_ff), d, dt),
            "wcv": init.normal((cfg.d_ff, d), cfg.d_ff, dt),
            "wcr": init.normal((d, d), d, dt),
        },
    }


def _token_shift(x, prev=None):
    """Shift the sequence right by one; prev: (B, D) last token of the
    prior chunk (zeros when None)."""
    prev = torch.zeros_like(x[:, :1]) if prev is None else prev[:, None]
    return torch.cat([prev, x[:, :-1]], dim=1)


def rwkv6_time_mix(p, x, cfg: ModelConfig, shift_prev=None):
    """RWKV6 time-mix over a full sequence (prefill), with the WKV
    recurrence through the kernel on a CUDA tensor.

    Returns (out, last x)."""
    b, s, d = x.shape
    h, hd = _rwkv_heads(cfg)
    xs = _token_shift(x, shift_prev)

    def mix(m):
        return x * m.to(x.dtype) + xs * (1.0 - m).to(x.dtype)

    hs = heads_spec(h, "wkv6")
    r = shard(mix(p["mix_r"]) @ p["wr"], "batch", None, hs)
    k = shard(mix(p["mix_k"]) @ p["wk"], "batch", None, hs)
    v = shard(mix(p["mix_v"]) @ p["wv"], "batch", None, hs)
    g = shard(mix(p["mix_g"]) @ p["wg"], "batch", None, hs)
    w_raw = shard(mix(p["mix_w"]) @ p["ww"], "batch", None, hs)
    w = torch.exp(-torch.exp(w_raw.to(torch.float32) + p["w_bias"]))

    def heads(t):
        t = shard(t, "batch", None, hs)
        return shard(t.reshape(b, s, h, hd).transpose(1, 2),
                     "batch", hs, None, None).contiguous()

    args = (heads(r), heads(k), heads(v), heads(w.to(x.dtype)),
            shard(p["u"], hs, None).to(x.dtype).contiguous())
    spec = ("batch", hs, None, None)
    o = A.local_call(wkv_ops.wkv, args, (spec,) * 4 + ((hs, None),), spec,
                     ((),) * 4 + (A.batch_split_axes(),))
    # group-norm over each head, then the gate
    o = head_rmsnorm(o, p["ln_scale"])
    o = _merged(o.transpose(1, 2).reshape(b, s, d), hs)
    o = o * F.silu(shard(g, "batch", None, "model").to(torch.float32)
                   ).to(o.dtype)
    return o @ p["wo"], x[:, -1]


def rwkv6_channel_mix(p, x, shift_prev=None):
    xs = _token_shift(x, shift_prev)
    # the f32 mix params promote x (as in the reference); cast back
    # before the matmuls
    xk = x * p["mix_k"] + xs * (1.0 - p["mix_k"])
    xr = x * p["mix_r"] + xs * (1.0 - p["mix_r"])
    k = torch.square(torch.relu(xk.to(x.dtype) @ p["wck"]))
    kv = shard(k, "batch", None, "model") @ p["wcv"]
    gate = torch.sigmoid((xr.to(x.dtype) @ p["wcr"]).to(torch.float32))
    return gate.to(x.dtype) * kv, x[:, -1]


def rwkv6_init_cache(cfg: ModelConfig, batch: int, dtype, device):
    d = cfg.d_model
    h, hd = _rwkv_heads(cfg)
    return {
        "wkv": torch.zeros((batch, h, hd, hd), dtype=torch.float32,
                           device=device),
        "shift_t": torch.zeros((batch, d), dtype=dtype, device=device),
        "shift_c": torch.zeros((batch, d), dtype=dtype, device=device),
    }


def rwkv6_time_mix_decode(p, x, cache_wkv, shift_prev, cfg: ModelConfig):
    """One-token time-mix. x: (B, 1, D). Returns (out, new state, x_t)."""
    b, _, d = x.shape
    h, hd = _rwkv_heads(cfg)
    xt = x[:, 0]
    xs = shift_prev

    def mix(m):
        return xt * m + xs * (1.0 - m)

    r = mix(p["mix_r"]).to(x.dtype) @ p["wr"]
    k = mix(p["mix_k"]).to(x.dtype) @ p["wk"]
    v = mix(p["mix_v"]).to(x.dtype) @ p["wv"]
    g = mix(p["mix_g"]).to(x.dtype) @ p["wg"]
    w_raw = mix(p["mix_w"]).to(x.dtype) @ p["ww"]
    w = torch.exp(-torch.exp(w_raw.to(torch.float32) + p["w_bias"]))

    hs = heads_spec(h, "wkv6")

    def hsplit(t):
        return shard(t, "batch", hs).reshape(b, h, hd)

    args = (cache_wkv, hsplit(r), hsplit(k), hsplit(v),
            hsplit(w.to(x.dtype)), p["u"].to(x.dtype))
    spec = ("batch", hs, None)
    s_new, o = A.local_call(
        wkv_ops.wkv_step, args,
        (("batch", hs, None, None),) + (spec,) * 4 + ((hs, None),),
        (("batch", hs, None, None), spec))
    o = head_rmsnorm(o, p["ln_scale"])
    o = o.reshape(b, d)
    o = o * F.silu(g.to(torch.float32)).to(o.dtype)
    return (o @ p["wo"])[:, None], s_new, xt


def rwkv6_channel_mix_decode(p, x, shift_prev):
    xt = x[:, 0]
    xk = xt * p["mix_k"] + shift_prev * (1.0 - p["mix_k"])
    xr = xt * p["mix_r"] + shift_prev * (1.0 - p["mix_r"])
    k = torch.square(torch.relu(xk.to(x.dtype) @ p["wck"]))
    kv = k @ p["wcv"]
    gate = torch.sigmoid((xr.to(x.dtype) @ p["wcr"]).to(torch.float32))
    return (gate.to(x.dtype) * kv)[:, None], xt
