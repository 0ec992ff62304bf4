"""Decoder-only transformer of the port (``repro.models.transformer``):
the dense family; the MoE family, whose layers take the MoE block
(``layers.moe_block``) in place of the MLP; MLA (deepseek-v2), whose
layers take ``layers.mla_attention``; and the VLM (internvl2), the dense
model with stub image embeddings prepended to the prompt.

Parameters keep ``repro``'s tree: names, ``(in, out)`` matrices, and the
layer weights stacked on a leading ``layers`` axis; the forward pass
walks that axis in a Python loop.  The KV cache is ``{"k", "v"}`` of
(layers, batch, max_len, kv_heads, head_dim), and for MLA the latent
``{"c": (layers, batch, max_len, kv_lora), "r": (..., qk_rope)}``,
written in place.  KV blocks (the data plane's wire format) are host
slabs of (2, chunk, layers, kv_heads, head_dim), k and v stacked; a
bfloat16 slab leaves the card as its raw words (``dht.data.Bf16Words``)
and comes back bit for bit.

With ``moe_impl="ep"`` a MoE layer runs ``moe_ep.moe_block_ep`` under an
installed mesh (``sharding.specs.mesh_context``), and ``layers.moe_block``
where that returns None, as ``repro``'s layer does.

Training (``train_loss``) walks the layers as the forward does, each layer
under ``torch.utils.checkpoint`` where ``cfg.remat`` asks for it
(``remat.remat``).  Each stacked leaf is split into its layers by one
``unbind`` (``remat.layer_slices``), whose backward
stacks the layers' gradients into one gradient of the stacked leaf (an
indexing ``t[i]`` a layer would write a zero-filled gradient of the whole
stack in every layer's backward).
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..dht.data import Bf16Words
from . import layers as L
from . import moe_ep
from .remat import layer_slices, remat

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def param_shapes(cfg: ModelConfig) -> Params:
    """Shape tree of ``init_params``: ``mlp`` in a dense layer, ``moe``
    where the config has experts."""
    d, n = cfg.d_model, cfg.num_layers
    emb = {"embedding": (cfg.vocab, d)}
    if not cfg.tie_embeddings:
        emb["lm_head"] = (d, cfg.vocab)
    stack = {"ln1": (d,), "ln2": (d,),
             "attn": L.mla_shapes(cfg) if cfg.mla_kv_lora
             else L.attention_shapes(cfg)}
    if cfg.moe_experts:
        stack["moe"] = L.moe_shapes(cfg)
    else:
        stack["mlp"] = L.mlp_shapes(cfg, cfg.d_ff)
    return {
        "embed": emb,
        "layers": _map(lambda s: (n,) + s, stack),
        "ln_f": (d,),
    }


def param_pspecs(cfg: ModelConfig) -> Params:
    """Logical-axis tuples of ``param_shapes``'s tree (``repro``'s
    ``param_pspecs``): what a tensor-parallel group splits each leaf on."""
    layer = {"ln1": (None,), "ln2": (None,),
             "attn": L.mla_specs(cfg) if cfg.mla_kv_lora
             else L.attention_specs(cfg)}
    if cfg.moe_experts:
        layer["moe"] = L.moe_specs(cfg)
    else:
        layer["mlp"] = L.mlp_specs(cfg)
    return {"embed": L.embed_specs(cfg),
            "layers": _map(lambda sp: ("layers",) + tuple(sp), layer),
            "ln_f": (None,)}


def param_dtypes(cfg: ModelConfig) -> Dict[str, Any]:
    """The leaves not held in the working dtype, at their place in
    ``param_shapes``'s tree: the MoE block's int8 experts and f32 scales
    (``layers.moe_dtypes``)."""
    special = L.moe_dtypes(cfg) if cfg.moe_experts else {}
    return {"layers": {"moe": special}} if special else {}


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device) -> Params:
    """Random weights drawn on ``device`` from ``generator`` (which must
    live on that device), with ``repro.models.layers._make``'s
    distributions: N(0, 1/fan_in) matrices (fan_in = d_model, the
    router and the experts too), N(0, 0.02^2) embedding and head, zero
    biases, unit norms; int8 expert weights quantized per expert from
    such a draw, as ``repro``'s ``moe_params``.  Stacked weights are
    drawn one layer at a time to bound the f32 temporary."""
    dtype = L.dt(cfg)
    shapes = param_shapes(cfg)
    leaf = functools.partial(L.init_leaf, generator=generator, dtype=dtype,
                             device=device)

    def quantized(shape, std):
        """int8 experts (n, e, in, out) and their (n, e) scales."""
        w = torch.empty(shape, dtype=torch.int8, device=device)
        scale = torch.empty(shape[:2], dtype=torch.float32, device=device)
        for i in range(shape[0]):
            draw_i = (torch.randn(shape[1:], generator=generator,
                                  dtype=torch.float32, device=device)
                      * std).to(dtype)
            w[i], scale[i] = L.quantize_experts(draw_i)
        return w, scale

    inv = 1.0 / math.sqrt(cfg.d_model)
    lay = shapes["layers"]
    embed = {k: leaf(k, s, False, 0.02)
             for k, s in sorted(shapes["embed"].items())}
    layers = {"ln1": leaf("ln1", lay["ln1"], True, inv),
              "ln2": leaf("ln2", lay["ln2"], True, inv),
              "attn": {k: leaf(k, s, True, inv)
                       for k, s in sorted(lay["attn"].items())}}
    ff = "moe" if cfg.moe_experts else "mlp"
    special = param_dtypes(cfg).get("layers", {}).get(ff, {})
    layers[ff] = {}
    for k, s in sorted(lay[ff].items()):
        if special.get(k) == torch.int8:
            layers[ff][k], layers[ff][k + "_scale"] = quantized(s, inv)
        elif k not in special:
            layers[ff][k] = leaf(k, s, True, inv)
    return {
        "embed": embed,
        "layers": layers,
        "ln_f": leaf("ln_f", shapes["ln_f"], False, inv),
    }


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------

def cache_shapes(cfg: ModelConfig, batch: int, max_len: int) -> Dict[str, Tuple]:
    if cfg.mla_kv_lora:
        lead = (cfg.num_layers, batch, max_len)
        return {"c": lead + (cfg.mla_kv_lora,),
                "r": lead + (cfg.mla_qk_rope_dim,)}
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    return {"k": shape, "v": shape}


def cache_pspecs(cfg: ModelConfig) -> Dict[str, Tuple]:
    """Logical axes of the cache: k/v split on kv_heads; MLA's latent
    ``c``/``r`` replicate."""
    if cfg.mla_kv_lora:
        return {"c": ("layers", "batch", "kv_seq", None),
                "r": ("layers", "batch", "kv_seq", None)}
    return {"k": ("layers", "batch", "kv_seq", "kv_heads", None),
            "v": ("layers", "batch", "kv_seq", "kv_heads", None)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device) -> Dict[str, torch.Tensor]:
    return {name: torch.zeros(shape, dtype=L.dt(cfg), device=device)
            for name, shape in cache_shapes(cfg, batch, max_len).items()}


def kv_block_shape(cfg: ModelConfig, chunk: int) -> Tuple[int, ...]:
    """Fixed block shape for ``chunk`` cache positions: (2, chunk,
    layers, kv_heads, head_dim) — k and v stacked on the leading axis so
    one DHT block carries a whole chunk's cache state."""
    return (2, chunk, cfg.num_layers, cfg.num_kv_heads,
            cfg.resolved_head_dim)


def _host(t: torch.Tensor) -> np.ndarray:
    """One device->host copy of a contiguous tensor; bfloat16 leaves as
    its raw words."""
    if t.dtype == torch.bfloat16:
        return Bf16Words.of(t.view(torch.int16).cpu().numpy())
    return t.cpu().numpy()


def _check_blocks(cfg: ModelConfig, cache: Dict, blocks) -> None:
    """A block must have the wire shape and the cache's dtype: a torn or
    foreign slab is refused before anything is written."""
    bf16 = cache["k"].dtype == torch.bfloat16
    want = np.dtype(np.uint16) if bf16 \
        else torch.empty(0, dtype=cache["k"].dtype).numpy().dtype
    for b in blocks:
        if b.ndim != 5 or b.shape != kv_block_shape(cfg, b.shape[1]) \
                or b.dtype != want or isinstance(b, Bf16Words) != bf16:
            raise ValueError(f"KV block of shape {b.shape} and type "
                             f"{type(b).__name__}[{b.dtype}] does not fit a "
                             f"{cache['k'].dtype} cache of {cfg.name}")


def _device_run(blocks, dtype: torch.dtype,
                device: torch.device) -> torch.Tensor:
    """Concatenate a slab run on the host and move it in one copy:
    (2, positions, layers, kv_heads, head_dim) on ``device``."""
    run = np.ascontiguousarray(np.concatenate([np.asarray(b) for b in blocks],
                                              axis=1))
    if dtype == torch.bfloat16:
        return torch.from_numpy(run.view(np.int16)).to(device).view(dtype)
    return torch.from_numpy(run).to(device)


def export_kv_block(cfg: ModelConfig, cache: Dict, row: int, off: int,
                    chunk: int) -> np.ndarray:
    """Cache positions [off, off+chunk) of one batch row as a host
    (2, chunk, layers, kv_heads, head_dim) slab: stacked on the device,
    then one device->host copy."""
    sl = slice(off, off + chunk)
    slab = torch.stack([cache["k"][:, row, sl], cache["v"][:, row, sl]])
    return _host(slab.transpose(1, 2).contiguous())


def export_kv_block_shards(cfg: ModelConfig, cache: Dict, row: int, off: int,
                           chunk: int, shards: int) -> list:
    """Per-shard slabs of one chunk: shard ``s`` carries kv_heads
    [s*H/shards, (s+1)*H/shards) in the (2, chunk, layers, heads,
    head_dim) wire format, so ``concat_kv_heads`` of the slabs is the
    full slab (``repro``'s slicing)."""
    hkv = cfg.num_kv_heads
    if shards < 1 or hkv % shards:
        raise ValueError(f"shards={shards} must divide kv_heads={hkv}")
    hl = hkv // shards
    sl = slice(off, off + chunk)
    out = []
    for s_i in range(shards):
        heads = slice(s_i * hl, (s_i + 1) * hl)
        slab = torch.stack([cache["k"][:, row, sl, heads],
                            cache["v"][:, row, sl, heads]])
        out.append(_host(slab.transpose(1, 2).contiguous()))
    return out


def concat_kv_heads(slabs) -> np.ndarray:
    """Join per-shard slabs on the kv-head axis (axis 3), keeping a
    bfloat16 slab's ``Bf16Words`` tag."""
    if len(slabs) == 1:
        return slabs[0]
    out = np.concatenate([np.asarray(b) for b in slabs], axis=3)
    return Bf16Words.of(out) if isinstance(slabs[0], Bf16Words) else out


def cache_with_blocks(cfg: ModelConfig, max_len: int, blocks,
                      device) -> Dict[str, torch.Tensor]:
    """Fresh single-row cache with a contiguous run of exported slabs
    already written at positions [0, len(blocks)*chunk): the run is
    assembled on the host and moved in one host->device copy (a write per
    block would cost a copy per block), the rest of the cache is zero."""
    cache = init_cache(cfg, 1, max_len, device)
    if blocks:
        _check_blocks(cfg, cache, blocks)
        run = _device_run(blocks, cache["k"].dtype, cache["k"].device)
        covered = run.shape[1]
        cache["k"][:, 0, :covered] = run[0].transpose(0, 1)
        cache["v"][:, 0, :covered] = run[1].transpose(0, 1)
    return cache


def import_kv_block(cfg: ModelConfig, cache: Dict, row: int, off: int,
                    block) -> Dict[str, torch.Tensor]:
    """Write an exported slab back into cache positions [off, off+chunk)
    of one batch row, in place.  Bit-faithful: the imported KV is
    byte-identical to what the exporting replica computed."""
    _check_blocks(cfg, cache, [block])
    run = _device_run([block], cache["k"].dtype, cache["k"].device)
    sl = slice(off, off + block.shape[1])
    cache["k"][:, row, sl] = run[0].transpose(0, 1)
    cache["v"][:, row, sl] = run[1].transpose(0, 1)
    return cache


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _layer(params: Params, i: int) -> Params:
    return _map(lambda t: t[i], params["layers"])


def _layer_body(cfg: ModelConfig, lp: Params, x: torch.Tensor, *,
                positions: torch.Tensor, cache: Optional[Tuple],
                cache_index, chunk: bool) -> torch.Tensor:
    h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    if cfg.mla_kv_lora:
        a, _ = L.mla_attention(lp["attn"], h, cfg, positions=positions,
                               cache=cache, cache_index=cache_index)
    else:
        a, _ = L.attention(lp["attn"], h, cfg, positions=positions,
                           cache=cache, cache_index=cache_index, chunk=chunk)
    x = x + a
    h = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
    if cfg.moe_experts:
        m = moe_ep.moe_block_ep(lp["moe"], h, cfg) \
            if cfg.moe_impl == "ep" else None
        return x + (L.moe_block(lp["moe"], h, cfg) if m is None else m)
    return x + L.mlp(lp["mlp"], h, cfg)


def backbone(params: Params, x: torch.Tensor, cfg: ModelConfig, *,
             positions: torch.Tensor) -> torch.Tensor:
    """Embedded input (B, S, d) -> final hidden states, no cache
    (``repro``'s ``backbone``): every layer on the fresh segment, causal,
    under ``cfg.remat``."""
    def body(lp, h):
        return _layer_body(cfg, lp, h, positions=positions, cache=None,
                           cache_index=None, chunk=False)

    layer = remat(cfg, body)
    for lp in layer_slices(params["layers"], cfg.num_layers):
        x = layer(lp, x)
    return L.rms_norm(x, params["ln_f"], cfg.norm_eps)


def train_loss(params: Params, batch: Dict[str, torch.Tensor],
               cfg: ModelConfig) -> torch.Tensor:
    """Mean next-token cross entropy (``repro``'s ``train_loss``): the
    VLM's ``image_embeds`` (B, vision_tokens, d) go before the embedded
    tokens, and their positions are cut before the loss, so only the
    text positions' labels count."""
    tokens, labels = batch["tokens"], batch["labels"]
    x = L.embed(params["embed"], tokens, cfg)
    mask_img = 0
    if "image_embeds" in batch:
        img = batch["image_embeds"].to(x.dtype)
        x = torch.cat([img, x], dim=1)
        mask_img = img.shape[1]
    positions = torch.arange(x.shape[1], device=x.device).expand(
        x.shape[:2])
    h = backbone(params, x, cfg, positions=positions)
    return L.chunked_ce_loss(params["embed"], h[:, mask_img:], labels, cfg)


def forward_with_cache(params: Params, tokens: torch.Tensor, cache: Dict,
                       cfg: ModelConfig, cache_index, *, chunk: bool = False,
                       image_embeds: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, Dict]:
    """Prefill (S>1) or decode (S==1): returns (last-position logits, cache).

    ``cache_index`` is an int (prefill / lockstep decode) or a (B,)
    tensor of per-slot cache positions (continuous-batching decode:
    every row writes and attends at its own length).  ``chunk=True``
    marks a fixed-shape continuation prefill segment (int index,
    possibly > 0): attention spans the whole cache under the absolute
    causal mask, and ALL-position logits (B, S, V) come back so the
    caller can pick the true last prompt position of a right-padded
    segment.  ``image_embeds`` (B, vision_tokens, d), the VLM's stub
    vision output, is prepended to the embedded tokens, as ``repro``
    does.  The cache is updated in place and returned."""
    x = L.embed(params["embed"], tokens, cfg)
    if image_embeds is not None:
        x = torch.cat([image_embeds.to(x.dtype), x], dim=1)
    b, s = x.shape[:2]
    steps = torch.arange(s, device=x.device)
    if isinstance(cache_index, torch.Tensor) and cache_index.dim():
        positions = cache_index.to(x.device, torch.int64)[:, None] + steps
    else:
        cache_index = int(cache_index)
        positions = (cache_index + steps).expand(b, s)
    pair = ("c", "r") if cfg.mla_kv_lora else ("k", "v")
    for i in range(cfg.num_layers):
        x = _layer_body(cfg, _layer(params, i), x, positions=positions,
                        cache=(cache[pair[0]][i], cache[pair[1]][i]),
                        cache_index=cache_index, chunk=chunk)
    if chunk:
        h = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
        return L.logits_fn(params["embed"], h, cfg), cache
    h = L.rms_norm(x[:, -1:], params["ln_f"], cfg.norm_eps)
    return L.logits_fn(params["embed"], h, cfg)[:, 0], cache
