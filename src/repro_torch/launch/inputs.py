"""Input shapes and dummy batches for every (arch x shape) cell (the port's
``repro.launch.inputs``).

``input_specs`` names each input's shape and torch dtype, allocating
nothing; ``dummy_batch`` draws a batch from the same numpy draws as
``repro``'s (same seed, same order, the floats scaled by 0.02 in f32 and
cast to the working dtype) and puts it on a device.

Modality frontends are stubs, as in ``repro``: whisper gets precomputed
frame embeddings, internvl2 precomputed patch embeddings.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..kernels.backend import resolve_device

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}
Spec = Tuple[Tuple[int, ...], torch.dtype]


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Spec]:
    """name -> (shape, dtype) of each input of the cell."""
    b, s = shape.global_batch, shape.seq_len
    d = cfg.d_model
    dtype = _DTYPES[cfg.dtype]
    tok = lambda n: ((b, n), torch.int32)  # noqa: E731
    if shape.mode == "train":
        if cfg.family == "encdec":
            return {"frames": ((b, cfg.audio_frames, d), dtype),
                    "tokens": tok(s), "labels": tok(s)}
        if cfg.family == "vlm":
            st = s - cfg.vision_tokens
            return {"image_embeds": ((b, cfg.vision_tokens, d), dtype),
                    "tokens": tok(st), "labels": tok(st)}
        return {"tokens": tok(s), "labels": tok(s)}
    if shape.mode == "prefill":
        if cfg.family == "encdec":
            return {"frames": ((b, cfg.audio_frames, d), dtype),
                    "tokens": tok(s)}
        if cfg.family == "vlm":
            return {"image_embeds": ((b, cfg.vision_tokens, d), dtype),
                    "tokens": tok(s - cfg.vision_tokens)}
        return {"tokens": tok(s)}
    # decode: one new token against a cache of length seq_len
    return {"tokens": tok(1)}


def batch_pspecs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, tuple]:
    """Logical axes of each input: the batch axis first."""
    return {k: ("batch",) + (None,) * (len(sh) - 1)
            for k, (sh, _) in input_specs(cfg, shape).items()}


def dummy_batch(cfg: ModelConfig, shape: ShapeConfig, seed: int = 0, *,
                device=None) -> Dict[str, torch.Tensor]:
    """A batch of the cell's inputs on ``device`` (default: the card):
    token ids uniform in [0, vocab), floats N(0, 0.02^2)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    out = {}
    for k, (sh, dtype) in input_specs(cfg, shape).items():
        if dtype == torch.int32:
            arr = rng.integers(0, cfg.vocab, size=sh, dtype=np.int32)
            out[k] = torch.from_numpy(arr).to(dev)
        else:
            arr = rng.standard_normal(sh, dtype=np.float32) * 0.02
            out[k] = torch.from_numpy(arr).to(dev, dtype)
    return out
