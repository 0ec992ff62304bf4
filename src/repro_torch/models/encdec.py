"""Encoder-decoder transformer of the port (``repro.models.encdec``):
whisper's backbone with the conv audio frontend stubbed, so the prefill
takes precomputed frame embeddings (B, T, d).  Positions are sinusoidal
in the encoder and the decoder, as in ``repro``.

Parameters keep ``repro``'s tree: ``embed``, the stacked ``encoder``
layers (``ln1, attn, ln2, mlp``), the stacked ``decoder`` layers (``ln1,
attn, ln_x, xattn, ln2, mlp``), ``ln_enc`` and ``ln_f``; the forward pass
walks the stacks in Python loops.  The cache is ``{"k", "v"}`` (the
decoder's self attention, (layers, batch, max_len, kv_heads, hd)) and
``{"xk", "xv"}`` (the cross attention's encoder K/V, (layers, batch, T,
kv_heads, hd)), which the prefill fills from the frames.  Every leaf is
written in place, so the frames must number the config's ``audio_frames``
(``repro`` replaces ``xk`` and ``xv`` and takes any T).

The encoder attends without a mask or rope on K5; the decoder's self
attention runs K5 in the prefill and K3 in decode (lockstep: every row at
the same position); its cross attention runs K5 (without a mask, Sq = the
prompt over Sk = T) in the prefill and K3 (every row's length T) in
decode (``layers.cross_attention``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from . import layers as L
from .transformer import _map

Params = Dict[str, Any]


def _sinusoid(positions: torch.Tensor, d: int,
              dtype: torch.dtype) -> torch.Tensor:
    half = d // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def param_shapes(cfg: ModelConfig) -> Params:
    """Shape tree of ``init_params``."""
    d = cfg.d_model
    emb = {"embedding": (cfg.vocab, d)}
    if not cfg.tie_embeddings:
        emb["lm_head"] = (d, cfg.vocab)
    attn, mlp = L.attention_shapes(cfg), L.mlp_shapes(cfg, cfg.d_ff)
    enc = {"ln1": (d,), "attn": attn, "ln2": (d,), "mlp": mlp}
    dec = {"ln1": (d,), "attn": attn, "ln_x": (d,), "xattn": attn,
           "ln2": (d,), "mlp": mlp}
    return {"embed": emb,
            "encoder": _map(lambda s: (cfg.encoder_layers,) + s, enc),
            "decoder": _map(lambda s: (cfg.num_layers,) + s, dec),
            "ln_enc": (d,), "ln_f": (d,)}


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device) -> Params:
    """Random weights drawn on ``device`` from ``generator`` (which must
    live on that device), one layer at a time, with ``repro``'s
    distributions: N(0, 1/d_model) matrices, zero biases, unit norms,
    N(0, 0.02^2) embedding and head."""
    inv = 1.0 / math.sqrt(cfg.d_model)

    def leaf(name, shape, stacked):
        std = 0.02 if name in ("embedding", "lm_head") else inv
        return L.init_leaf(name, shape, stacked, std, generator=generator,
                           dtype=L.dt(cfg), device=device)

    def walk(tree, stacked):
        return {k: walk(v, stacked) if isinstance(v, dict)
                else leaf(k, v, stacked) for k, v in sorted(tree.items())}

    shapes = param_shapes(cfg)
    return {k: walk(v, k in ("encoder", "decoder")) if isinstance(v, dict)
            else leaf(k, v, False) for k, v in shapes.items()}


def encode(params: Params, frames: torch.Tensor,
           cfg: ModelConfig) -> torch.Tensor:
    """frames: the stub conv frontend's output (B, T, d) -> the encoder's
    normed output (B, T, d)."""
    b, t, d = frames.shape
    pos = torch.arange(t, device=frames.device)
    x = frames.to(L.dt(cfg)) + _sinusoid(pos, d, L.dt(cfg))[None]
    positions = pos.expand(b, t)
    for i in range(cfg.encoder_layers):
        lp = _map(lambda t: t[i], params["encoder"])
        h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
        a, _ = L.attention(lp["attn"], h, cfg, positions=positions,
                           causal=False, use_rope=False)
        x = x + a
        h = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + L.mlp(lp["mlp"], h, cfg)
    return L.rms_norm(x, params["ln_enc"], cfg.norm_eps)


def _dec_body(cfg: ModelConfig, lp: Params, x: torch.Tensor, *,
              positions: torch.Tensor, self_cache: Tuple, cache_index: int,
              cross_kv: Tuple) -> torch.Tensor:
    h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    a, _ = L.attention(lp["attn"], h, cfg, positions=positions,
                       cache=self_cache, cache_index=cache_index)
    x = x + a
    h = L.rms_norm(x, lp["ln_x"], cfg.norm_eps)
    x = x + L.cross_attention(lp["xattn"], h, *cross_kv, cfg)
    h = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + L.mlp(lp["mlp"], h, cfg)


def cache_shapes(cfg: ModelConfig, batch: int,
                 max_len: int) -> Dict[str, Tuple]:
    hkv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    self_kv = (cfg.num_layers, batch, max_len, hkv, hd)
    cross = (cfg.num_layers, batch, cfg.audio_frames, hkv, hd)
    return {"k": self_kv, "v": self_kv, "xk": cross, "xv": cross}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device) -> Dict[str, torch.Tensor]:
    return {name: torch.zeros(shape, dtype=L.dt(cfg), device=device)
            for name, shape in cache_shapes(cfg, batch, max_len).items()}


def forward_with_cache(params: Params, tokens: torch.Tensor, cache: Dict,
                       cfg: ModelConfig, cache_index, *,
                       frames: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, Dict]:
    """A lockstep decode step, or the prefill when ``frames`` is given
    (which first encodes the frames and fills ``xk`` / ``xv`` from the
    encoder output, without bias, as ``repro``): returns (last-position
    f32 logits (B, V), cache)."""
    cache_index = int(cache_index)
    b, s = tokens.shape
    dtype = L.dt(cfg)
    positions = (cache_index + torch.arange(s, device=tokens.device)) \
        .expand(b, s)
    x = L.embed(params["embed"], tokens, cfg) \
        + _sinusoid(positions, cfg.d_model, dtype)
    if frames is not None:
        t = frames.shape[1]
        if t != cache["xk"].shape[2]:
            raise ValueError(f"{t} frames, but the cache holds "
                             f"{cache['xk'].shape[2]} encoder positions")
        enc_out = encode(params, frames, cfg)
        hkv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
        xa = params["decoder"]["xattn"]
        for i in range(cfg.num_layers):
            cache["xk"][i] = (enc_out @ xa["wk"][i]).reshape(b, t, hkv, hd)
            cache["xv"][i] = (enc_out @ xa["wv"][i]).reshape(b, t, hkv, hd)
    for i in range(cfg.num_layers):
        x = _dec_body(cfg, _map(lambda t: t[i], params["decoder"]), x,
                      positions=positions,
                      self_cache=(cache["k"][i], cache["v"][i]),
                      cache_index=cache_index,
                      cross_kv=(cache["xk"][i], cache["xv"][i]))
    h = L.rms_norm(x[:, -1:], params["ln_f"], cfg.norm_eps)
    return L.logits_fn(params["embed"], h, cfg)[:, 0], cache
