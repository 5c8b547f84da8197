"""Architecture configuration schema for the model zoo.

Every assigned architecture is a ``ModelConfig`` instance; the decoder-only
transformer in ``repro.models.transformer`` composes layers from it. Reduced
variants (for CPU smoke tests) come from ``reduced()``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                 # dense|ssm|moe|hybrid|audio|vlm
    n_layers: int
    d_model: int
    n_heads: int                   # query heads (0 for attention-free)
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0                # 0 -> d_model // n_heads

    # attention flavor
    attention: str = "gqa"         # gqa|mla|none
    qk_norm: bool = False
    rope_theta: float = 1e6
    sliding_window: Optional[int] = None   # enables long_500k for dense archs

    # MLA (deepseek-v2)
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    # MoE
    n_experts: int = 0
    n_experts_active: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0              # per-expert hidden dim
    capacity_factor: float = 1.25
    moe_every: int = 1             # MoE FFN every k-th layer (jamba: 2)

    # hybrid (jamba): one attention layer per ``attn_every`` layers
    attn_every: int = 0            # 0 -> pure attention stack
    # ssm
    ssm_type: str = ""             # rwkv6|mamba
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2                # mamba inner expansion

    norm_type: str = "rmsnorm"     # rmsnorm|nonparametric_ln
    input_mode: str = "tokens"     # tokens|embeddings (audio/vlm stubs)
    tie_embeddings: bool = False

    # numerics
    param_dtype: str = "bfloat16"
    remat: bool = True             # activation checkpointing over layers

    # implementation strategy knobs (EXPERIMENTS.md §Perf iterates these)
    moe_grouped: bool = True       # per-sequence dispatch (data-sharded);
                                   # False: global-token dispatch (naive)
    mamba_scan_chunk: int = 64     # ssm scan in checkpointed chunks of
                                   # this many steps; 0 = one per-step
                                   # scan over the sequence

    # citation for the config values
    source: str = ""

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256 so the vocab dim shards
        evenly on the model mesh axis (affects internvl2's 151655)."""
        return ((self.vocab_size + 255) // 256) * 256

    @property
    def head_dim(self) -> int:
        if self.d_head:
            return self.d_head
        if self.n_heads:
            return self.d_model // self.n_heads
        return 64

    @property
    def is_subquadratic(self) -> bool:
        """Eligible for the long_500k decode shape."""
        return (self.arch_type in ("ssm", "hybrid")
                or self.sliding_window is not None
                or self.attention == "mla")

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks + head)."""
        d, v = self.d_model, self.vocab_size
        total = v * d                     # embed
        if not self.tie_embeddings:
            total += v * d                # lm head
        per_layer = 0
        hd = self.head_dim
        for li in range(self.n_layers):
            is_attn = self._layer_is_attention(li)
            if is_attn and self.attention == "gqa":
                per = (d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
                       + self.n_heads * hd * d)
            elif is_attn and self.attention == "mla":
                r = self.kv_lora_rank
                qd = self.qk_nope_head_dim + self.qk_rope_head_dim
                per = (d * self.n_heads * qd
                       + d * (r + self.qk_rope_head_dim)
                       + r * self.n_heads * (self.qk_nope_head_dim
                                             + self.v_head_dim)
                       + self.n_heads * self.v_head_dim * d)
            elif self.ssm_type == "mamba":
                di = self.expand * d
                per = (d * 2 * di + di * self.d_conv
                       + di * (self.d_state * 2 + 1 + d)  # dt,B,C + out? approx
                       + di * self.d_state + di * d)
            elif self.ssm_type == "rwkv6":
                per = 6 * d * d + 2 * d   # r,k,v,w,g,out (+ u, mix params)
            else:
                per = 0
            # ffn
            if self.n_experts and ((li % self.moe_every) == self.moe_every - 1):
                f = self.moe_d_ff or self.d_ff
                per += self.n_experts * 3 * d * f
                per += self.n_shared_experts * 3 * d * f
                per += d * self.n_experts  # router
            elif self.ssm_type != "rwkv6":
                per += 3 * d * self.d_ff
            else:
                per += 2 * d * int(3.5 * d)  # rwkv channel-mix
            per_layer += per
        return total + per_layer

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only active experts)."""
        if not self.n_experts:
            return self.param_count()
        d = self.d_model
        f = self.moe_d_ff or self.d_ff
        n_moe_layers = len([li for li in range(self.n_layers)
                            if (li % self.moe_every) == self.moe_every - 1])
        inactive = (self.n_experts - self.n_experts_active)
        return self.param_count() - n_moe_layers * inactive * 3 * d * f

    def _layer_is_attention(self, li: int) -> bool:
        if self.arch_type == "ssm":
            return False
        if self.attn_every:
            return (li % self.attn_every) == 0
        return True

    def reduced(self, n_layers: int = 2, d_model: int = 256,
                n_experts: int = 4) -> "ModelConfig":
        """Tiny same-family variant for CPU smoke tests."""
        heads = max(1, min(self.n_heads, 4))
        kv = max(1, min(self.n_kv_heads, heads))
        while heads % kv:
            kv -= 1
        changes = dict(
            name=self.name + "-reduced",
            n_layers=n_layers,
            d_model=d_model,
            n_heads=heads if self.n_heads else 0,
            n_kv_heads=kv if self.n_kv_heads else 0,
            d_head=(d_model // heads) if self.n_heads else 0,
            d_ff=2 * d_model,
            vocab_size=min(self.vocab_size, 512),
            kv_lora_rank=min(self.kv_lora_rank, 64),
            qk_nope_head_dim=32 if self.attention == "mla" else self.qk_nope_head_dim,
            qk_rope_head_dim=16 if self.attention == "mla" else self.qk_rope_head_dim,
            v_head_dim=32 if self.attention == "mla" else self.v_head_dim,
            n_experts=min(self.n_experts, n_experts),
            n_experts_active=min(self.n_experts_active,
                                 min(self.n_experts, n_experts)),
            n_shared_experts=min(self.n_shared_experts, 1),
            moe_d_ff=d_model if self.moe_d_ff else 0,
            attn_every=min(self.attn_every, n_layers) if self.attn_every else 0,
            sliding_window=(64 if self.sliding_window is not None else None),
            param_dtype="float32",
            remat=False,
        )
        if self.attn_every:
            changes["n_layers"] = max(n_layers, self.attn_every)
            changes["attn_every"] = changes["n_layers"]
        return dataclasses.replace(self, **changes)
