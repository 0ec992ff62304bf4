"""Architecture registry of the port: the configs it can serve (the dense
and the Mamba-1 SSM families).

Each entry provides the FULL config and a ``smoke()`` reduction of the
same family (small depth/width/vocab) for CPU tests.
"""
from __future__ import annotations

import importlib

from .base import ModelConfig

ARCH_IDS = ["qwen2.5-3b", "falcon-mamba-7b"]

_MODULES = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def get_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.smoke()
