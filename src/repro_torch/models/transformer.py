"""Decoder-only transformer composed from ``ModelConfig``.

The counterpart of the reference's ``models/transformer.py``: block
templates, ``init_params``, ``forward`` (with per-block activation
checkpointing when ``cfg.remat``), ``logits_fn``, the chunked
cross-entropy, ``loss_fn`` and ``make_train_step``, the decode cache and
``serve_step``.  The reference stacks every block's params along a
leading layer axis and scans over it; here ``params["blocks"]`` is a list
with one dict per block, and the layer loop is a Python loop.  Gradients
come from autograd; on the card, attention's and the RWKV6 recurrence's
from their backward kernels.  MLA, the MoE FFN (with its Switch aux
loss, summed over the blocks) and the Mamba block are plain torch, as in
the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..device import resolve_device
from ..sharding import activations as A
from ..sharding.activations import gather_fsdp, shard
from ..tree import tree_leaves, tree_map
from . import layers as L

LOSS_CHUNK = 512


# ---------------------------------------------------------------------------
# Block templates -------------------------------------------------------------
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Sublayer:
    mixer: str       # gqa|mla|mamba|rwkv6
    ffn: str         # swiglu|moe|rwkv_channel


def block_template(cfg: ModelConfig) -> List[Sublayer]:
    """The repeating unit of the layer stack. Length = block size."""
    size = cfg.attn_every if cfg.attn_every else 1
    subs = []
    for j in range(size):
        if cfg.arch_type == "ssm" and cfg.ssm_type == "rwkv6":
            mixer = "rwkv6"
        elif cfg.attn_every:
            mixer = "gqa" if j == 0 else "mamba"
        elif cfg.attention == "mla":
            mixer = "mla"
        else:
            mixer = "gqa"
        if mixer == "rwkv6":
            ffn = "rwkv_channel"
        elif cfg.n_experts and (j % cfg.moe_every) == cfg.moe_every - 1:
            ffn = "moe"
        else:
            ffn = "swiglu"
        subs.append(Sublayer(mixer, ffn))
    return subs


def n_blocks(cfg: ModelConfig) -> int:
    size = cfg.attn_every if cfg.attn_every else 1
    if cfg.n_layers % size:
        raise ValueError(f"n_layers {cfg.n_layers} is not a multiple of the "
                         f"block size {size}")
    return cfg.n_layers // size


# ---------------------------------------------------------------------------
# Init ------------------------------------------------------------------------
# ---------------------------------------------------------------------------
def _init_sublayer(cfg: ModelConfig, init: L.Init, sub: Sublayer) -> Dict:
    p: Dict[str, Any] = {"norm1": L.rmsnorm_init(cfg, init), "norm2": {}}
    if sub.mixer == "gqa":
        p["mixer"] = L.gqa_init(cfg, init)
    elif sub.mixer == "mla":
        p["mixer"] = L.mla_init(cfg, init)
    elif sub.mixer == "mamba":
        p["mixer"] = L.mamba_init(cfg, init)
    elif sub.mixer == "rwkv6":
        p["mixer"] = L.rwkv6_init(cfg, init)
    if sub.ffn == "swiglu":
        p["norm2"] = L.rmsnorm_init(cfg, init)
        p["ffn"] = L.swiglu_init(cfg, init)
    elif sub.ffn == "moe":
        p["norm2"] = L.rmsnorm_init(cfg, init)
        p["ffn"] = L.moe_init(cfg, init)
    elif sub.ffn == "rwkv_channel":
        p["norm2"] = L.rmsnorm_init(cfg, init)
        # channel-mix params live inside rwkv6_init's "channel" entry
    return p


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> Dict:
    """Random params from ``seed``, with the reference's tree, shapes,
    dtypes and ``1/sqrt(fan_in)`` normal scale (not its numbers: a
    ``torch.Generator`` draws them).  On ``device="meta"`` the tree holds
    shapes and dtypes only.  ``params["blocks"]`` is a list of
    ``n_blocks(cfg)`` dicts ``{"sub0": ..., ...}``."""
    dev = resolve_device(device)
    init = L.Init(seed, dev)
    subs = block_template(cfg)
    blocks = [{f"sub{j}": _init_sublayer(cfg, init, sub)
               for j, sub in enumerate(subs)} for _ in range(n_blocks(cfg))]
    dt = L.param_dtype(cfg)
    params: Dict[str, Any] = {"blocks": blocks,
                              "final_norm": L.rmsnorm_init(cfg, init)}
    if cfg.input_mode == "tokens":
        params["embed"] = {"w": init.normal((cfg.padded_vocab, cfg.d_model),
                                            cfg.d_model, dt)}
    else:
        # modality-frontend stub: inputs arrive as embeddings; a light
        # input projection stands in for the (stubbed) projector
        params["in_proj"] = {"w": init.normal((cfg.d_model, cfg.d_model),
                                              cfg.d_model, dt)}
    if not (cfg.tie_embeddings and cfg.input_mode == "tokens"):
        params["lm_head"] = {"w": init.normal((cfg.d_model,
                                               cfg.padded_vocab),
                                              cfg.d_model, dt)}
    return params


# ---------------------------------------------------------------------------
# Forward (prefill) -----------------------------------------------------------
# ---------------------------------------------------------------------------
def _apply_sublayer(sp, x, cfg: ModelConfig, sub: Sublayer, positions):
    """One sublayer over ``x``: returns (x, its MoE aux loss), the aux
    ``None`` where the FFN is not MoE (the reference's zeros, without a
    kernel launch for them)."""
    aux = None
    h = L.norm_apply(sp["norm1"], x, cfg)
    if sub.mixer == "gqa":
        y = L.gqa_apply(sp["mixer"], h, cfg, positions)
    elif sub.mixer == "mla":
        y = L.mla_apply(sp["mixer"], h, cfg, positions)
    elif sub.mixer == "mamba":
        y = L.mamba_apply(sp["mixer"], h, cfg)
    elif sub.mixer == "rwkv6":
        y, _ = L.rwkv6_time_mix(sp["mixer"]["time"], h, cfg)
    # under a mesh each residual branch is reduced over ``model`` before
    # it joins the (batch-split, model-replicated) stream
    x = x + shard(y, "batch", None, None)
    h = L.norm_apply(sp["norm2"], x, cfg)
    if sub.ffn == "swiglu":
        y = L.swiglu_apply(sp["ffn"], h)
    elif sub.ffn == "moe":
        y = L.moe_apply(sp["ffn"], h, cfg)
        aux = L.moe_aux_loss(sp["ffn"], h, cfg)
    elif sub.ffn == "rwkv_channel":
        y, _ = L.rwkv6_channel_mix(sp["mixer"]["channel"], h)
    return x + shard(y, "batch", None, None), aux


def _apply_block(block, x, cfg: ModelConfig, subs, positions):
    """Every sublayer of one block: (x, the block's aux loss or None).
    Under a mesh the block's weights are all-gathered over the FSDP axes
    first (inside the remat, so its recompute gathers them again)."""
    aux = None
    block = gather_fsdp(block)
    x = shard(x, "batch", None, None)
    for j, sub in enumerate(subs):
        x, a = _apply_sublayer(block[f"sub{j}"], x, cfg, sub, positions)
        if a is not None:
            aux = a if aux is None else aux + a
    return shard(x, "batch", None, None), aux


def apply_blocks(params, x, cfg: ModelConfig, positions):
    """Every block over ``x``; returns (x, the MoE aux loss summed over
    the blocks, a 0-d f32 tensor).  With ``cfg.remat`` and grad enabled
    each block is checkpointed, as the reference's ``jax.checkpoint(body)``:
    backward keeps only every block's input and recomputes the block,
    aux loss included."""
    subs = block_template(cfg)
    remat = cfg.remat and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for block in params["blocks"]:
        if remat:
            x, a = checkpoint(_apply_block, block, x, cfg, subs, positions,
                              use_reentrant=False)
        else:
            x, a = _apply_block(block, x, cfg, subs, positions)
        if a is not None:
            aux = aux + a
    return x, aux


def _embed_sharded(w, tokens):
    """The token lookup, under a mesh on each rank's local rows of the
    vocab-split table: a rank gives the rows of its vocab range and zeros
    elsewhere, and the partial sums are reduced over ``model`` (exactly
    one term is not zero).  A rank that holds the whole table looks up
    plainly."""
    split = w.shape[0] % A.axis_size("model") == 0
    mesh = A.current_mesh()
    rank = mesh.get_local_rank("model") if split and A.axis_size(
        "model") > 1 else 0

    def fn(wl, tok):
        if wl.shape[0] == w.shape[0]:
            return F.embedding(tok, wl)
        local = tok - rank * wl.shape[0]
        mine = (local >= 0) & (local < wl.shape[0])
        out = F.embedding(torch.clamp(local, 0, wl.shape[0] - 1), wl)
        return out * mine[..., None].to(out.dtype)

    vs = "model" if split else None
    return A.local_call(fn, (w, tokens), ((vs, None), ("batch", None)),
                        ("batch", None, None), (A.batch_split_axes(), ()),
                        out_partial=("model",) if split else ())


def embed_inputs(params, cfg: ModelConfig, inputs):
    if cfg.input_mode == "tokens":
        return _embed_sharded(gather_fsdp(params["embed"]["w"]), inputs)
    return inputs.to(L.param_dtype(cfg)) @ gather_fsdp(
        params["in_proj"]["w"])


def unembed(params, cfg: ModelConfig, h):
    # h made contiguous (the prefill's last position is a strided slice):
    # a strided (B, S, D) by (D, V) matmul broadcasts the weight to a
    # batched product, and DTensor materializes that, B copies of the
    # weight's shard; contiguous, it is one mm (which rounds in its own
    # last bits)
    h = h.contiguous()
    if "lm_head" in params:
        return h @ gather_fsdp(params["lm_head"]["w"])
    return h @ gather_fsdp(params["embed"]["w"]).T


def forward(params, cfg: ModelConfig, inputs,
            positions: Optional[torch.Tensor] = None):
    """Final hidden states (B, S, D) and the MoE aux loss (0 without an
    MoE FFN).  inputs: (B, S) int tokens or (B, S, D) embeddings."""
    s = inputs.shape[1]
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=inputs.device)
    x = shard(embed_inputs(params, cfg, inputs), "batch", None, None)
    x, aux = apply_blocks(params, x, cfg, positions)
    return L.norm_apply(params["final_norm"], x, cfg), aux


def logits_fn(params, cfg: ModelConfig, inputs, positions=None):
    h, aux = forward(params, cfg, inputs, positions)
    return unembed(params, cfg, h), aux


# ---------------------------------------------------------------------------
# Loss + train step -----------------------------------------------------------
# ---------------------------------------------------------------------------
def chunked_ce_loss(params, cfg: ModelConfig, h, labels):
    """Mean cross-entropy over (B, S) labels without materializing
    (B, S, V) logits: the sequence goes in ``LOSS_CHUNK`` slices, each
    slice's logits (B, C, V) in f32, the sum carried in f32."""
    b, s, _ = h.shape
    chunk = min(LOSS_CHUNK, s)
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of the loss chunk "
                         f"{chunk}")
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(s // chunk):
        sl = slice(i * chunk, (i + 1) * chunk)
        logits = shard(unembed(params, cfg, h[:, sl]).to(torch.float32),
                       "batch", None, "model")
        logz = torch.logsumexp(logits, dim=-1)
        # under a mesh the gather from vocab-split logits is a masked
        # partial sum, reduced over ``model`` before the trailing dim goes
        gold = shard(torch.gather(logits, -1, labels[:, sl, None].long()),
                     "batch", None, None)[..., 0]
        total = total + torch.sum(logz - gold)
    return total / (b * s)


def loss_fn(params, cfg: ModelConfig, batch):
    """(ce + 0.01 aux, (ce, aux)) of ``batch`` (``inputs``, ``labels``)."""
    h, aux = forward(params, cfg, batch["inputs"])
    ce = chunked_ce_loss(params, cfg, h, batch["labels"])
    return ce + 0.01 * aux, (ce, aux)


def loss_and_grads(params, cfg: ModelConfig, batch):
    """The gradient of :func:`loss_fn` with respect to every leaf of
    ``params`` (a tree of the same nesting; zeros for a leaf the loss does
    not reach), and the metrics ``loss``, ``ce``, ``aux`` (detached 0-d
    f32 tensors)."""
    leaves = tree_leaves(params)
    tracked = [p.detach().requires_grad_() for p in leaves]
    it = iter(tracked)
    loss, (ce, aux) = loss_fn(tree_map(lambda _: next(it), params), cfg,
                              batch)
    grads = torch.autograd.grad(loss, tracked, allow_unused=True)
    it = iter(torch.zeros_like(p) if g is None else g
              for p, g in zip(leaves, grads))
    return tree_map(lambda _: next(it), params), {
        "loss": loss.detach(), "ce": ce.detach(), "aux": aux.detach()}


def sgd_leaf(p, g, lr: float):
    """One SGD update of a leaf in the reference's arithmetic: f32, then
    back to the leaf's type."""
    return (p.to(torch.float32) - lr * g.to(torch.float32)).to(p.dtype)


def batch_to(batch, device):
    return {key: batch[key].to(device) for key in ("inputs", "labels")}


def make_train_step(cfg: ModelConfig, lr: float = 1e-3,
                    optimizer: str = "sgd", device="cuda"):
    """Returns train_step(params, batch) -> (params, metrics) on
    ``device``.

    Plain SGD (paper eqs. 3-6), as the reference's: ``optimizer`` is
    accepted and, as there, not read.  ``batch`` has ``inputs`` (tokens
    (B, S) int or embeddings (B, S, D)) and ``labels`` (B, S) int, moved
    to ``device``.  Functional: new params, the given ones untouched.
    """
    dev = resolve_device(device)

    def train_step(params, batch):
        grads, metrics = loss_and_grads(params, cfg, batch_to(batch, dev))
        with torch.no_grad():
            new = tree_map(lambda p, g: sgd_leaf(p, g, lr), params, grads)
        return new, metrics

    return train_step


# ---------------------------------------------------------------------------
# Decode (serve_step) --------------------------------------------------------
# ---------------------------------------------------------------------------
def init_sublayer_cache(cfg: ModelConfig, sub: Sublayer, batch: int,
                        cache_len: int, dtype, device):
    if sub.mixer == "gqa":
        return L.gqa_init_cache(cfg, batch, cache_len, dtype, device)
    if sub.mixer == "rwkv6":
        return L.rwkv6_init_cache(cfg, batch, dtype, device)
    if sub.mixer == "mla":
        return L.mla_init_cache(cfg, batch, cache_len, dtype, device)
    if sub.mixer == "mamba":
        return L.mamba_init_cache(cfg, batch, dtype, device)
    raise ValueError(sub.mixer)


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype=None,
               device="cuda") -> List[Dict]:
    """Decode cache: one dict ``{"sub0": ..., ...}`` per block.  For
    sliding-window configs the attention cache holds
    min(cache_len, window) positions — the point of SWA."""
    dev = resolve_device(device)
    dtype = dtype or L.param_dtype(cfg)
    subs = block_template(cfg)
    out = []
    for _ in range(n_blocks(cfg)):
        block = {}
        for j, sub in enumerate(subs):
            clen = cache_len
            if sub.mixer == "gqa" and cfg.sliding_window is not None:
                clen = min(cache_len, cfg.sliding_window)
            block[f"sub{j}"] = init_sublayer_cache(cfg, sub, batch, clen,
                                                   dtype, dev)
        out.append(block)
    return out


def _decode_sublayer(sp, cache, x, pos: int, cfg: ModelConfig,
                     sub: Sublayer):
    h = L.norm_apply(sp["norm1"], x, cfg)
    if sub.mixer == "gqa":
        y, cache = L.gqa_decode(sp["mixer"], h, cache, pos, cfg)
    elif sub.mixer == "mla":
        y, cache = L.mla_decode(sp["mixer"], h, cache, pos, cfg)
    elif sub.mixer == "mamba":
        y, cache = L.mamba_decode(sp["mixer"], h, cache, cfg)
    elif sub.mixer == "rwkv6":
        y, s_new, xt = L.rwkv6_time_mix_decode(
            sp["mixer"]["time"], h, cache["wkv"], cache["shift_t"], cfg)
        cache = dict(cache, wkv=s_new, shift_t=xt)
    x = x + shard(y, "batch", None, None)
    h = L.norm_apply(sp["norm2"], x, cfg)
    if sub.ffn == "swiglu":
        y = L.swiglu_apply(sp["ffn"], h)
    elif sub.ffn == "moe":
        y = L.moe_apply(sp["ffn"], h, cfg)
    elif sub.ffn == "rwkv_channel":
        y, xc = L.rwkv6_channel_mix_decode(sp["mixer"]["channel"], h,
                                           cache["shift_c"])
        cache = dict(cache, shift_c=xc)
    return x + shard(y, "batch", None, None), cache


def serve_step(params, cfg: ModelConfig, cache, inputs, pos: int):
    """Decode ONE token for the whole batch.

    inputs: (B, 1) int tokens or (B, 1, D) embeddings; ``pos`` the
    absolute position of the token.  Returns (logits (B, V) f32,
    new_cache).  The attention caches' K/V tensors are written in place,
    so ``cache`` is spent: use the returned one.
    """
    subs = block_template(cfg)
    x = shard(embed_inputs(params, cfg, inputs), "batch", None, None)
    new_cache = []
    for block, block_cache in zip(params["blocks"], cache):
        block = gather_fsdp(block)
        new_block = {}
        for j, sub in enumerate(subs):
            x, new_block[f"sub{j}"] = _decode_sublayer(
                block[f"sub{j}"], block_cache[f"sub{j}"], x, pos, cfg, sub)
        new_cache.append(new_block)
    x = L.norm_apply(params["final_norm"], x, cfg)
    logits = unembed(params, cfg, x)[:, 0]
    return logits.to(torch.float32), new_cache
