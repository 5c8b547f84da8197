"""Architecture configurations: copies of the reference's ``configs``
(``ModelConfig``, the registry and its ten configs are data only)."""
from .base import ModelConfig
from .registry import ARCH_IDS, REGISTRY, get_config
from .shapes import SHAPES, InputShape, supports

__all__ = ["ModelConfig", "ARCH_IDS", "REGISTRY", "get_config", "SHAPES",
           "InputShape", "supports"]
