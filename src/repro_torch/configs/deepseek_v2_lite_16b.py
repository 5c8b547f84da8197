"""deepseek-v2-lite-16b [moe]: 27L d_model=2048 16H (kv=16) per-expert
d_ff=1408 vocab=102400, MLA kv_lora=512, MoE 64 routed experts top-6
+ 2 shared. [arXiv:2405.04434]

Note: the assignment line reads "MoE 64e top-6 ... 2 shared+160 routed
top-6"; we follow the explicit ``MoE 64e top-6`` spec (see DESIGN.md §5).
MLA's rank-512 latent KV cache makes the full 500k-token decode cache
small (~0.6 GB bf16 at B=1 across layers), so long_500k runs natively.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    arch_type="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    moe_d_ff=1408,
    vocab_size=102400,
    attention="mla",
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    n_experts=64,
    n_experts_active=6,
    n_shared_experts=2,
    source="arXiv:2405.04434",
)
