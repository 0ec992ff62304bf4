"""Architecture registry of the port: the configs it can serve (the dense
family, the Mamba-1 SSM family, the Mamba-2 hybrid with its shared
attention block, the MoE family, MLA (deepseek-v2), the encoder-decoder
(whisper) and the VLM (internvl2)).

Each entry provides the FULL config and a ``smoke()`` reduction of the
same family (small depth/width/vocab) for CPU tests.  ``shape_cells``,
``skipped_cells`` and ``all_cells`` are ``repro``'s (arch x shape) suite
that the dry run (``launch.dryrun``) walks.
"""
from __future__ import annotations

import importlib
from typing import List

from .base import SHAPES, ModelConfig, ShapeConfig

# ``repro``'s order, so that ``all_cells`` lists the cells as its does
ARCH_IDS = ["whisper-small", "qwen3-moe-235b-a22b", "deepseek-v2-236b",
            "nemotron-4-15b", "internlm2-20b", "qwen2.5-3b", "command-r-35b",
            "falcon-mamba-7b", "zamba2-7b", "internvl2-2b"]

_MODULES = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def get_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.smoke()


def shape_cells(arch: str) -> List[ShapeConfig]:
    """The shape suite for an arch, with the mandated skips applied."""
    cfg = get_config(arch)
    return [s for s in SHAPES.values()
            if s.name != "long_500k" or cfg.supports_long_context]


def skipped_cells(arch: str) -> List[str]:
    """The shapes an arch skips: long_500k for a pure full-attention
    arch."""
    return [] if get_config(arch).supports_long_context else ["long_500k"]


def all_cells() -> List[tuple]:
    """(arch, shape name) of every cell, in ``ARCH_IDS``' order."""
    return [(a, s.name) for a in ARCH_IDS for s in shape_cells(a)]
