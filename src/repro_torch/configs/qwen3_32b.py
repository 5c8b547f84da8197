"""qwen3-32b [dense]: 64L d_model=5120 64H (GQA kv=8) d_ff=25600
vocab=151936, qk-norm. [hf:Qwen/Qwen3-8B family scaling; head_dim=128 as in
all Qwen3 models]. Sliding-window variant (8192) enables long_500k decode."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b",
    arch_type="dense",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=25600,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1e6,
    sliding_window=8192,   # only used by the long_500k decode shape
    source="hf:Qwen/Qwen3-8B",
)
