from .base import SHAPES, ModelConfig, ShapeConfig
from .registry import (ARCH_IDS, all_cells, get_config, get_smoke_config,
                       shape_cells, skipped_cells)

__all__ = ["ModelConfig", "SHAPES", "ShapeConfig", "ARCH_IDS", "all_cells",
           "get_config", "get_smoke_config", "shape_cells", "skipped_cells"]
