"""Weights for the port: from ``repro``'s parameter tree, or drawn anew.

``params_from_jax`` takes ``jax.device_get(repro Model(cfg).init(key))``
as a tree of numpy arrays and returns the port's parameters.  The port
keeps ``repro``'s names, its ``(in, out)`` matrices and its stacked
``layers`` axis (``repro/models/transformer.py`` for the dense, MoE, MLA
and VLM families, ``repro/models/hybrid.py`` for the SSM and hybrid
families, the shared block under ``shared``, and
``repro/models/encdec.py``'s stacked ``encoder`` and ``decoder``), so the
mapping is the identity on names and shapes; this is the one place that
checks it.  ``Model.init`` draws
random weights on the device instead.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..configs.base import ModelConfig
from . import encdec, hybrid, transformer
from . import layers as L

__all__ = ["params_from_jax"]


def params_from_jax(tree: Dict[str, Any], cfg: ModelConfig,
                    device) -> Dict[str, Any]:
    """numpy tree with ``repro``'s names -> torch tensors on ``device``
    in ``cfg.dtype`` (bf16 arrays widen to f32 on the host first, which
    is exact, since numpy has no bfloat16 that torch reads); int8 expert
    weights stay int8 and their scales f32."""
    dtype = L.dt(cfg)

    def walk(src, shapes, dtypes, path):
        if isinstance(shapes, dict):
            if not isinstance(src, dict) or set(src) != set(shapes):
                got = sorted(src) if isinstance(src, dict) else type(src)
                raise ValueError(f"{path or 'params'}: expected keys "
                                 f"{sorted(shapes)}, got {got}")
            return {k: walk(src[k], shapes[k], dtypes.get(k, {}),
                            f"{path}/{k}") for k in shapes}
        arr = np.asarray(src)
        if tuple(arr.shape) != tuple(shapes):
            raise ValueError(f"{path}: shape {arr.shape} != {shapes}")
        if dtypes == torch.int8:
            if arr.dtype != np.int8:
                raise ValueError(f"{path}: int8 expert weights expected, "
                                 f"got {arr.dtype}")
            return torch.from_numpy(np.array(arr, np.int8)).to(device)
        return torch.from_numpy(np.ascontiguousarray(
            arr.astype(np.float32))).to(device=device, dtype=dtypes or dtype)

    if cfg.family in ("ssm", "hybrid"):
        return walk(tree, hybrid.param_shapes(cfg), {}, "")
    if cfg.family == "encdec":
        return walk(tree, encdec.param_shapes(cfg), {}, "")
    return walk(tree, transformer.param_shapes(cfg),
                transformer.param_dtypes(cfg), "")
