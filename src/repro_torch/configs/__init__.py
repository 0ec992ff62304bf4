from .base import SHAPES, ModelConfig, ShapeConfig
from .registry import ARCH_IDS, get_config, get_smoke_config

__all__ = ["ModelConfig", "SHAPES", "ShapeConfig", "ARCH_IDS",
           "get_config", "get_smoke_config"]
