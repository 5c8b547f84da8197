"""musicgen-medium [audio]: 48L d_model=1536 24H (kv=24, i.e. MHA)
d_ff=6144 vocab=2048 — decoder-only over EnCodec tokens. [arXiv:2306.05284]

The EnCodec tokenizer/frontend is a STUB per the assignment:
``input_specs`` provides precomputed frame embeddings (B, S, d_model);
the decoder transformer here is the real implementation.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    arch_type="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    input_mode="embeddings",
    sliding_window=8192,   # long_500k variant
    source="arXiv:2306.05284",
)
