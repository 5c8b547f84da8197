"""Architecture configurations: copies of the reference's ``configs``
(``ModelConfig``, the registry and its ten configs, ``paper_cnn`` are
data only), and the shapes' stand-in inputs and caches on ``meta``."""
from .base import ModelConfig
from .registry import ARCH_IDS, REGISTRY, get_config
from .shapes import (SHAPES, InputShape, cache_specs, input_specs,
                     supports)

__all__ = ["ModelConfig", "ARCH_IDS", "REGISTRY", "get_config", "SHAPES",
           "InputShape", "cache_specs", "input_specs", "supports"]
