"""SSM backbone of the port (``repro.models.hybrid``): Mamba-1 or Mamba-2
layers, and for the hybrid family (zamba2) ONE shared transformer block
(attention + MLP, one set of weights) after every ``shared_attn_every``
Mamba layers, the last partial group included.

Parameters keep ``repro``'s tree: ``embed``, the layer weights
``layers/{ln, mamba/...}`` stacked on a leading ``layers`` axis, ``ln_f``,
and ``shared/{ln1, attn, ln2, mlp}`` where the config has the shared
block; the forward pass walks the groups in a Python loop (``repro``
scans each group's layers).

The cache is flat, ``{"h": (L, B, ...) f32, "conv": (L, B, K-1, C)}`` and
for the shared block's attention ``{"k", "v"}`` of (G, B, max_len, Hkv,
hd), one site a group, all with the batch on axis 1 like the dense KV
cache, so ``Replica`` writes, gathers and scatters slots of every family
the same way.  ``repro`` keeps the same arrays under ``{"state": {"h",
"conv"}, "attn": {"k", "v"}}``.  The cache is updated in place and
returned.

The shared block's prefill attention runs on K5 and its decode on K3.
The family decodes in lockstep: every row writes its K/V at the same
position and attends over [0, index], as in ``repro``, so a row shorter
than the longest also attends over the zero rows it never wrote.

Training (``train_loss``) runs ``train_backbone``, ``repro``'s
``backbone`` on its ``state is None`` path: each Mamba layer from a zero state
(Mamba-1's scan on K6 and K6b) under ``cfg.remat``, and the shared block
at each site causal on ``layers.flash_attention`` (K5 and K5b), recomputed
whole in the backward whenever ``cfg.remat`` is not ``"none"`` (``repro``
checkpoints it with nothing saved: the block runs at ~N/k sites).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from . import layers as L
from . import ssm as S
from .remat import layer_slices, remat
from .transformer import _map

Params = Dict[str, Any]


def num_shared_sites(cfg: ModelConfig) -> int:
    k = cfg.shared_attn_every
    return (cfg.num_layers + k - 1) // k if k else 0


def _group_bounds(cfg: ModelConfig) -> List[Tuple[int, int]]:
    """[lo, hi) of each group of at most ``shared_attn_every`` layers (one
    group of all of them without the shared block)."""
    k = cfg.shared_attn_every or cfg.num_layers
    return [(i, min(i + k, cfg.num_layers))
            for i in range(0, cfg.num_layers, k)]


def param_shapes(cfg: ModelConfig) -> Params:
    """Shape tree of ``init_params``."""
    d, n = cfg.d_model, cfg.num_layers
    emb = {"embedding": (cfg.vocab, d)}
    if not cfg.tie_embeddings:
        emb["lm_head"] = (d, cfg.vocab)
    out = {
        "embed": emb,
        "layers": {"ln": (n, d),
                   "mamba": {k: (n,) + s
                             for k, s in S.mamba_shapes(cfg).items()}},
        "ln_f": (d,),
    }
    if cfg.shared_attn_every > 0:
        out["shared"] = {"ln1": (d,), "attn": L.attention_shapes(cfg),
                         "ln2": (d,), "mlp": L.mlp_shapes(cfg, cfg.d_ff)}
    return out


def param_pspecs(cfg: ModelConfig) -> Params:
    """Logical-axis tuples of ``param_shapes``'s tree (``repro``'s
    ``param_pspecs``)."""
    layer = {"ln": (None,), "mamba": S.mamba_specs(cfg)}
    out = {"embed": L.embed_specs(cfg),
           "layers": _map(lambda sp: ("layers",) + tuple(sp), layer),
           "ln_f": (None,)}
    if cfg.shared_attn_every > 0:
        out["shared"] = {"ln1": (None,), "attn": L.attention_specs(cfg),
                         "ln2": (None,), "mlp": L.mlp_specs(cfg)}
    return out


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device) -> Params:
    """Random weights drawn on ``device`` from ``generator`` (which must
    live on that device), one layer at a time, with ``repro``'s
    distributions (``ssm.mamba_params``; N(0, 1/d_model) matrices and
    zero biases in the shared block; N(0, 0.02^2) embedding and head;
    unit norms)."""
    dtype = L.dt(cfg)
    shapes = param_shapes(cfg)
    mamba = {k: torch.empty(s, dtype=dtype, device=device)
             for k, s in shapes["layers"]["mamba"].items()}
    for i in range(cfg.num_layers):
        for k, t in S.mamba_params(cfg, generator, device).items():
            mamba[k][i] = t

    def leaf(name, shape, std=None):
        return L.init_leaf(name, shape, False, std, generator=generator,
                           dtype=dtype, device=device)

    out = {
        "embed": {k: leaf(k, s, 0.02)
                  for k, s in sorted(shapes["embed"].items())},
        "layers": {"ln": leaf("ln", shapes["layers"]["ln"]), "mamba": mamba},
        "ln_f": leaf("ln_f", shapes["ln_f"]),
    }
    if "shared" in shapes:
        std = cfg.d_model ** -0.5
        out["shared"] = {k: leaf(k, v) if k.startswith("ln") else
                         {name: leaf(name, s, std)
                          for name, s in sorted(v.items())}
                         for k, v in shapes["shared"].items()}
    return out


def cache_shapes(cfg: ModelConfig, batch: int,
                 max_len: int) -> Dict[str, Tuple]:
    """The recurrent state, and the shared sites' KV cache where the
    config has the shared block (without it the size does not depend on
    ``max_len``)."""
    st = S.mamba_state_shapes(cfg, batch)
    out = {"h": (cfg.num_layers,) + st["h"],
           "conv": (cfg.num_layers,) + st["conv"]}
    g = num_shared_sites(cfg)
    if g:
        out["k"] = out["v"] = (g, batch, max_len, cfg.num_kv_heads,
                               cfg.resolved_head_dim)
    return out


def cache_pspecs(cfg: ModelConfig) -> Dict[str, Tuple]:
    """Logical axes of the flat cache: ``repro``'s ``cache_pspecs`` with
    ``state/h``, ``state/conv``, ``attn/k`` and ``attn/v`` as ``h``,
    ``conv``, ``k`` and ``v``."""
    out = {"h": ("layers", "batch", "heads", None, None)
           if cfg.mamba_version == 2 else ("layers", "batch", "ff", None),
           "conv": ("layers", "batch", None, "ff")}
    if num_shared_sites(cfg):
        out["k"] = out["v"] = (None, "batch", "kv_seq", "kv_heads", None)
    return out


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device) -> Dict[str, torch.Tensor]:
    return {name: torch.zeros(shape, device=device, dtype=torch.float32
                              if name == "h" else L.dt(cfg))
            for name, shape in cache_shapes(cfg, batch, max_len).items()}


def _shared_block(cfg: ModelConfig, sp: Params, x: torch.Tensor, *,
                  positions: torch.Tensor, cache: Optional[Tuple] = None,
                  cache_index: Optional[int] = None) -> torch.Tensor:
    """The shared transformer block at one site: attention (over the
    site's KV cache, or causal over the fresh segment without one), then
    the MLP, each with its residual."""
    h = L.rms_norm(x, sp["ln1"], cfg.norm_eps)
    a, _ = L.attention(sp["attn"], h, cfg, positions=positions, cache=cache,
                       cache_index=cache_index)
    x = x + a
    h = L.rms_norm(x, sp["ln2"], cfg.norm_eps)
    return x + L.mlp(sp["mlp"], h, cfg)


def backbone(params: Params, x: torch.Tensor, cfg: ModelConfig,
             cache: Dict[str, torch.Tensor], *, positions: torch.Tensor,
             cache_index: int) -> torch.Tensor:
    """The groups of Mamba layers, each followed by the shared block where
    the config has it, then the final norm; each layer's state and each
    site's KV in ``cache`` are read and replaced in place (training, with
    no cache: ``train_backbone``)."""
    lay = params["layers"]
    for g, (lo, hi) in enumerate(_group_bounds(cfg)):
        for i in range(lo, hi):
            lp = {k: t[i] for k, t in lay["mamba"].items()}
            h = L.rms_norm(x, lay["ln"][i], cfg.norm_eps)
            out, st = S.mamba_forward(lp, h, cfg, {"h": cache["h"][i],
                                                   "conv": cache["conv"][i]})
            cache["h"][i] = st["h"]
            cache["conv"][i] = st["conv"]
            x = x + out
        if cfg.shared_attn_every > 0:
            x = _shared_block(cfg, params["shared"], x, positions=positions,
                              cache=(cache["k"][g], cache["v"][g]),
                              cache_index=cache_index)
    return L.rms_norm(x, params["ln_f"], cfg.norm_eps)


def train_backbone(params: Params, x: torch.Tensor, cfg: ModelConfig, *,
                   positions: torch.Tensor) -> torch.Tensor:
    """``repro``'s ``backbone`` with ``state=None``: the Mamba layers from
    a zero state, each under ``cfg.remat``, and the shared block at each
    site on the fresh segment, recomputed whole unless ``cfg.remat`` is
    ``"none"``."""
    def mamba_layer(lp, h):
        out, _ = S.mamba_forward(lp["mamba"],
                                 L.rms_norm(h, lp["ln"], cfg.norm_eps), cfg)
        return h + out

    def shared(sp, h):
        return _shared_block(cfg, sp, h, positions=positions)

    layer = remat(cfg, mamba_layer)
    block = remat(cfg, shared, "none" if cfg.remat == "none" else "full")
    lps = layer_slices(params["layers"], cfg.num_layers)
    for lo, hi in _group_bounds(cfg):
        for i in range(lo, hi):
            x = layer(lps[i], x)
        if cfg.shared_attn_every > 0:
            x = block(params["shared"], x)
    return L.rms_norm(x, params["ln_f"], cfg.norm_eps)


def train_loss(params: Params, batch: Dict[str, torch.Tensor],
               cfg: ModelConfig) -> torch.Tensor:
    """Mean next-token cross entropy of ``batch["tokens"]`` against
    ``batch["labels"]`` (``repro``'s ``train_loss``): embed, the backbone
    without a cache, ``layers.chunked_ce_loss``."""
    tokens, labels = batch["tokens"], batch["labels"]
    x = L.embed(params["embed"], tokens, cfg)
    positions = torch.arange(x.shape[1], device=x.device).expand(
        x.shape[:2])
    h = train_backbone(params, x, cfg, positions=positions)
    return L.chunked_ce_loss(params["embed"], h, labels, cfg)


def forward_with_cache(params: Params, tokens: torch.Tensor, cache: Dict,
                       cfg: ModelConfig, cache_index=0
                       ) -> Tuple[torch.Tensor, Dict]:
    """Prefill (S > 1, from the cache's state and position 0) or a
    lockstep decode step (S == 1, every row at position ``cache_index``):
    returns (last-position f32 logits (B, V), cache).  Positions are
    ``cache_index + arange(S)``, as in ``repro``; only the shared block
    reads them."""
    cache_index = int(cache_index)
    x = L.embed(params["embed"], tokens, cfg)
    b, s = x.shape[:2]
    positions = (cache_index + torch.arange(s, device=x.device)).expand(b, s)
    h = backbone(params, x, cfg, cache, positions=positions,
                 cache_index=cache_index)
    return L.logits_fn(params["embed"], h[:, -1:], cfg)[:, 0], cache
