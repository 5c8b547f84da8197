"""olmo-1b [dense]: 16L d_model=2048 16H (kv=16) d_ff=8192 vocab=50304 —
non-parametric LayerNorm. [arXiv:2402.00838]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    arch_type="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=50304,
    norm_type="nonparametric_ln",
    sliding_window=8192,   # long_500k variant
    source="arXiv:2402.00838",
)
