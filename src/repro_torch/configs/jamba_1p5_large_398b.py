"""jamba-1.5-large-398b [hybrid]: 72L d_model=8192 64H (GQA kv=8)
d_ff=24576 vocab=65536, Mamba+attention 1:7 interleave, MoE 16 experts
top-2 applied every other layer (as in the Jamba paper). [arXiv:2403.19887]

Scan unit: one 8-layer block (1 attention + 7 Mamba layers; FFNs alternate
dense / 16-expert MoE). Sub-quadratic (Mamba-majority + the attention
layers' sliding window) => runs long_500k.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    arch_type="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=24576,
    moe_d_ff=24576,
    vocab_size=65536,
    attn_every=8,
    n_experts=16,
    n_experts_active=2,
    moe_every=2,
    d_state=16,
    expand=2,
    sliding_window=8192,   # bounds the attention cache for long_500k
    source="arXiv:2403.19887",
)
