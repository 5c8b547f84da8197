"""qwen3-moe-235b-a22b [moe]: 94L d_model=4096 64H (GQA kv=4)
per-expert d_ff=1536, vocab=151936, 128 experts top-8, qk-norm.
[hf:Qwen/Qwen3-30B-A3B scaled per assignment]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    arch_type="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_head=128,
    d_ff=1536,             # per-expert hidden dim (assignment value)
    moe_d_ff=1536,
    vocab_size=151936,
    qk_norm=True,
    n_experts=128,
    n_experts_active=8,
    sliding_window=8192,   # long_500k variant
    source="hf:Qwen/Qwen3-30B-A3B",
)
