"""internvl2-1b [vlm]: 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151655 — InternViT + Qwen2-0.5B language decoder. [arXiv:2404.16821]

The InternViT vision encoder + MLP projector are a STUB per the
assignment: ``input_specs`` provides pre-projected patch embeddings
(B, S, d_model); this config implements the language decoder that
consumes them.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    arch_type="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab_size=151655,
    input_mode="embeddings",
    sliding_window=8192,   # long_500k variant
    source="arXiv:2404.16821",
)
