"""SSM backbone of the port (``repro.models.hybrid``), Mamba-1 layers only.

Parameters keep ``repro``'s tree: ``embed``, the layer weights
``layers/{ln, mamba/...}`` stacked on a leading ``layers`` axis, and
``ln_f``; the forward pass walks that axis in a Python loop (``repro``
scans it).  The zamba2-style shared attention block
(``shared_attn_every > 0``) comes with the hybrid slice.

The cache is flat, ``{"h": (L, B, din, N) f32, "conv": (L, B, K-1, din)}``,
with the batch on axis 1 like the dense KV cache, so ``Replica`` writes,
gathers and scatters slots of either family the same way.  ``repro``
keeps the same two arrays under ``{"state": {"h": ..., "conv": ...}}``.
The cache is updated in place and returned.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..configs.base import ModelConfig
from . import layers as L
from . import ssm as S

Params = Dict[str, Any]


def require_ported(cfg: ModelConfig) -> None:
    S.require_mamba1(cfg)
    if cfg.shared_attn_every > 0:
        raise NotImplementedError(
            "the shared attention block (shared_attn_every > 0) is not "
            "ported yet: ROADMAP queue 1, item 5 (hybrid)")


def param_shapes(cfg: ModelConfig) -> Params:
    """Shape tree of ``init_params``."""
    d, n = cfg.d_model, cfg.num_layers
    emb = {"embedding": (cfg.vocab, d)}
    if not cfg.tie_embeddings:
        emb["lm_head"] = (d, cfg.vocab)
    return {
        "embed": emb,
        "layers": {"ln": (n, d),
                   "mamba": {k: (n,) + s
                             for k, s in S.mamba_shapes(cfg).items()}},
        "ln_f": (d,),
    }


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device) -> Params:
    """Random weights drawn on ``device`` from ``generator`` (which must
    live on that device), one layer at a time, with ``repro``'s
    distributions (``ssm.mamba_params``; N(0, 0.02^2) embedding and head;
    unit norms)."""
    dtype = L.dt(cfg)
    shapes = param_shapes(cfg)
    mamba = {k: torch.empty(s, dtype=dtype, device=device)
             for k, s in shapes["layers"]["mamba"].items()}
    for i in range(cfg.num_layers):
        for k, t in S.mamba_params(cfg, generator, device).items():
            mamba[k][i] = t
    embed = {k: (torch.randn(s, generator=generator, dtype=torch.float32,
                             device=device) * 0.02).to(dtype)
             for k, s in sorted(shapes["embed"].items())}
    return {
        "embed": embed,
        "layers": {"ln": torch.ones(shapes["layers"]["ln"], dtype=dtype,
                                    device=device),
                   "mamba": mamba},
        "ln_f": torch.ones(shapes["ln_f"], dtype=dtype, device=device),
    }


def cache_shapes(cfg: ModelConfig, batch: int,
                 max_len: int) -> Dict[str, Tuple]:
    """The recurrent state; without attention its size does not depend
    on ``max_len`` (kept for the dense family's signature)."""
    del max_len
    st = S.mamba_state_shapes(cfg, batch)
    return {"h": (cfg.num_layers,) + st["h"],
            "conv": (cfg.num_layers,) + st["conv"]}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device) -> Dict[str, torch.Tensor]:
    shapes = cache_shapes(cfg, batch, max_len)
    return {"h": torch.zeros(shapes["h"], dtype=torch.float32, device=device),
            "conv": torch.zeros(shapes["conv"], dtype=L.dt(cfg),
                                device=device)}


def backbone(params: Params, x: torch.Tensor, cfg: ModelConfig,
             cache: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The Mamba layers and the final norm; each layer's state in
    ``cache`` is read and replaced in place."""
    lay = params["layers"]
    for i in range(cfg.num_layers):
        lp = {k: t[i] for k, t in lay["mamba"].items()}
        h = L.rms_norm(x, lay["ln"][i], cfg.norm_eps)
        out, st = S.mamba1_forward(lp, h, cfg, {"h": cache["h"][i],
                                                "conv": cache["conv"][i]})
        cache["h"][i] = st["h"]
        cache["conv"][i] = st["conv"]
        x = x + out
    return L.rms_norm(x, params["ln_f"], cfg.norm_eps)


def forward_with_cache(params: Params, tokens: torch.Tensor, cache: Dict,
                       cfg: ModelConfig, cache_index=0
                       ) -> Tuple[torch.Tensor, Dict]:
    """Prefill (S > 1, from the cache's state) or a lockstep decode step
    (S == 1): returns (last-position f32 logits (B, V), cache).  Without
    attention there are no positions, so ``cache_index`` is not read."""
    del cache_index
    x = L.embed(params["embed"], tokens, cfg)
    h = backbone(params, x, cfg, cache)
    return L.logits_fn(params["embed"], h[:, -1:], cfg)[:, 0], cache
