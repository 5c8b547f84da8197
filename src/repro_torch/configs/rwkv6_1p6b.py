"""rwkv6-1.6b [ssm]: 24L d_model=2048 attention-free, d_ff=7168
vocab=65536 — Finch, data-dependent decay. [arXiv:2404.05892]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    arch_type="ssm",
    ssm_type="rwkv6",
    n_layers=24,
    d_model=2048,
    n_heads=0,
    n_kv_heads=0,
    d_ff=7168,
    vocab_size=65536,
    attention="none",
    source="arXiv:2404.05892",
)
