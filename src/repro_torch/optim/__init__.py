from . import adamw
from .adamw import OptConfig

__all__ = ["adamw", "OptConfig"]
