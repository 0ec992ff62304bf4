"""Architecture registry of the port: the configs it can serve (the dense
family, the Mamba-1 SSM family, the Mamba-2 hybrid with its shared
attention block, the MoE family, MLA (deepseek-v2), the encoder-decoder
(whisper) and the VLM (internvl2)).

Each entry provides the FULL config and a ``smoke()`` reduction of the
same family (small depth/width/vocab) for CPU tests.
"""
from __future__ import annotations

import importlib

from .base import ModelConfig

ARCH_IDS = ["qwen2.5-3b", "internlm2-20b", "nemotron-4-15b", "command-r-35b",
            "falcon-mamba-7b", "zamba2-7b", "qwen3-moe-235b-a22b",
            "deepseek-v2-236b", "whisper-small", "internvl2-2b"]

_MODULES = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def get_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.smoke()
