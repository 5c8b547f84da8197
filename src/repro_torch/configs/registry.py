"""Architecture registry: ``get_config(arch_id)`` for --arch selection."""
from __future__ import annotations

from typing import Dict

from .base import ModelConfig
from .qwen3_32b import CONFIG as QWEN3_32B
from .rwkv6_1p6b import CONFIG as RWKV6_1P6B
from .qwen3_moe_235b_a22b import CONFIG as QWEN3_MOE
from .llama3p2_3b import CONFIG as LLAMA3P2_3B
from .musicgen_medium import CONFIG as MUSICGEN_MEDIUM
from .olmo_1b import CONFIG as OLMO_1B
from .internvl2_1b import CONFIG as INTERNVL2_1B
from .deepseek_v2_lite_16b import CONFIG as DEEPSEEK_V2_LITE
from .deepseek_coder_33b import CONFIG as DEEPSEEK_CODER_33B
from .jamba_1p5_large_398b import CONFIG as JAMBA_1P5_LARGE

REGISTRY: Dict[str, ModelConfig] = {
    "qwen3-32b": QWEN3_32B,
    "rwkv6-1.6b": RWKV6_1P6B,
    "qwen3-moe-235b-a22b": QWEN3_MOE,
    "llama3.2-3b": LLAMA3P2_3B,
    "musicgen-medium": MUSICGEN_MEDIUM,
    "olmo-1b": OLMO_1B,
    "internvl2-1b": INTERNVL2_1B,
    "deepseek-v2-lite-16b": DEEPSEEK_V2_LITE,
    "deepseek-coder-33b": DEEPSEEK_CODER_33B,
    "jamba-1.5-large-398b": JAMBA_1P5_LARGE,
}

ARCH_IDS = list(REGISTRY)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    return REGISTRY[arch_id]
