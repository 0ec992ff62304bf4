"""Model building blocks of the port: ``repro.models.layers`` on torch
tensors (GQA attention, the encoder-decoder's cross attention, MLA
attention, the MLPs, the MoE block, embedding and head).

Dtypes follow ``repro``: ``rms_norm`` and ``rope`` compute in f32 and
cast back; attention scores are f32 from the working-dtype operands; the
logits are f32.  Where XLA takes ``preferred_element_type=f32`` with
bf16 operands, the port upcasts the operands to f32 (exact) and runs an
f32 product, with TF32 off on the card (``kernels.backend.strict_fp32``).
Whole-prompt prefill attention goes through the K5 wrapper and decode
attention through the K3 wrapper (CUDA kernels on the card, their plain
versions on the CPU); a continuation prefill chunk attends at a query
offset that K5 does not take, so it stays plain torch, as ``repro``
leaves it to XLA.  MLA's prefill runs K5 with a q . k head dim of
qk_nope + qk_rope and a v head dim of its own; its absorbed decode over
the latent cache is plain torch products, as in ``repro`` (no TPU kernel
computes it).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels.decode_attention.ops import decode_attention as _decode_op
from ..kernels.flash_attention.ops import flash_attention as _flash_op

Params = Dict[str, Any]
NEG = -1e30
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def dt(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def init_leaf(name: str, shape: Tuple[int, ...], stacked: bool, std: float,
              *, generator: torch.Generator, dtype: torch.dtype,
              device) -> torch.Tensor:
    """One leaf of a random init with ``repro``'s conventions: unit norms
    (``ln*``), zero biases (one dimension past the stacked layer one), and
    N(0, std^2) matrices drawn in f32 from ``generator``, a layer at a
    time where ``stacked``."""
    if name.startswith("ln"):
        return torch.ones(shape, dtype=dtype, device=device)
    if len(shape) == (2 if stacked else 1):
        return torch.zeros(shape, dtype=dtype, device=device)
    out = torch.empty(shape, dtype=dtype, device=device)
    for sl in (range(shape[0]) if stacked else [slice(None)]):
        # scaled in place and cast by the copy: one f32 temporary of a
        # layer's leaf at a time, which sets the init's peak
        out[sl] = torch.randn(out[sl].shape, generator=generator,
                              dtype=torch.float32, device=device).mul_(std)
    return out


# ---------------------------------------------------------------------------
# Norms and RoPE
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    orig = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * scale.float()).to(orig)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., :, None].float() * freqs          # (..., S, half)
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def _repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    if groups == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, groups, d) \
        .reshape(b, s, h * groups, d)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool) -> torch.Tensor:
    """Attention over a fresh segment (kernel K5), for a prefill from
    cache position 0.  q: (B,Sq,H,hd), k/v: (B,Sk,Hkv,hd) -> (B,Sq,H,hd).
    Unlike ``repro``'s jnp path, p stays f32 for p . v, as in the TPU
    kernel."""
    return _flash_op(q.contiguous(), k.contiguous(), v.contiguous(),
                     causal=causal)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    """Single-position attention over a KV cache (kernel K3).

    q: (B,1,H,hd); caches: (B,S,Hkv,hd); ``length`` (B,) masks valid
    positions per row, so every slot of a continuous-batching replica
    attends at its own cache position.  K3 takes any S."""
    out = _decode_op(q[:, 0].contiguous(), k_cache.contiguous(),
                     v_cache.contiguous(), length.to(torch.int32))
    return out[:, None]


def attention(params: Params, x: torch.Tensor, cfg: ModelConfig, *,
              positions: torch.Tensor,
              cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              cache_index=None, chunk: bool = False, causal: bool = True,
              use_rope: bool = True) -> Tuple[torch.Tensor, Optional[Tuple]]:
    """GQA attention with QKV bias.  Returns (out, cache).

    ``causal=False, use_rope=False`` is the encoder-decoder's encoder
    (no cache: K5 without a mask).

    ``cache`` is a (k, v) pair of (B,S,Hkv,hd) tensors, written IN PLACE
    (``repro`` returns fresh arrays; the port saves the copy).
    ``cache_index`` is an int (prefill / lockstep decode: every row
    writes at the same position) or a (B,) tensor of per-slot positions
    (continuous-batching decode; s == 1, every position < S).
    ``chunk`` marks a continuation prefill segment: the fresh queries
    attend over the whole cache under the absolute causal mask."""
    b, s, _ = x.shape
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if "bq" in params:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, s, hkv, hd)
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    v = v.reshape(b, s, hkv, hd)
    if cache is None:
        out = flash_attention(q, k, v, causal=causal)
    else:
        k_cache, v_cache = cache
        if isinstance(cache_index, torch.Tensor) and cache_index.dim():
            rows = torch.arange(b, device=x.device)
            idx = cache_index.to(torch.int64)
            k_cache[rows, idx] = k[:, 0].to(k_cache.dtype)
            v_cache[rows, idx] = v[:, 0].to(v_cache.dtype)
            lengths = (idx + 1).to(torch.int32)
        else:
            idx = int(cache_index)
            if idx + s > k_cache.shape[1]:
                raise ValueError(f"segment [{idx}, {idx + s}) exceeds the "
                                 f"cache length {k_cache.shape[1]}")
            k_cache[:, idx:idx + s] = k.to(k_cache.dtype)
            v_cache[:, idx:idx + s] = v.to(v_cache.dtype)
            lengths = torch.full((b,), idx + s, dtype=torch.int32,
                                 device=x.device)
        if s == 1:
            out = decode_attention(q, k_cache, v_cache, lengths)
        elif chunk:
            # continuation chunk: attend over the full cache (earlier
            # chunks live below ``idx``) with the absolute causal mask;
            # garbage rows at positions >= idx + s are masked out
            kc = _repeat_kv(k_cache, h // hkv)
            vc = _repeat_kv(v_cache, h // hkv)
            sc = torch.einsum("bqhd,bkhd->bhqk", q.float(), kc.float())
            sc = sc * (1.0 / math.sqrt(hd))
            q_pos = idx + torch.arange(s, device=x.device)
            k_pos = torch.arange(kc.shape[1], device=x.device)
            sc = torch.where((k_pos[None, :] <= q_pos[:, None])[None, None],
                             sc, NEG)
            p = torch.softmax(sc, dim=-1).to(vc.dtype)
            out = torch.einsum("bhqk,bkhd->bqhd", p, vc).to(q.dtype)
        else:
            # prefill from position 0: attend over the fresh segment
            out = flash_attention(q, k, v, causal=causal)
        cache = (k_cache, v_cache)
    out = out.reshape(b, s, h * hd) @ params["wo"]
    return out, cache


def cross_attention(params: Params, x: torch.Tensor, k_enc: torch.Tensor,
                    v_enc: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The decoder's attention over precomputed encoder K/V (B,T,Hkv,hd),
    every position unmasked: what ``repro``'s jnp ``decode_attention``
    without lengths computes (``repro/models/encdec.py:135``; no bias,
    no rope).  A decode step (s == 1) runs K3 with every row's length
    T; a prefill (s > 1) runs K5 without a mask, Sq = s over Sk = T
    (``repro`` runs an unmasked einsum there, and rounds p to v's dtype
    before p . v, where K5 keeps it in f32)."""
    b, s, _ = x.shape
    h, hd = cfg.num_heads, cfg.resolved_head_dim
    q = (x @ params["wq"]).reshape(b, s, h, hd)
    if s == 1:
        length = torch.full((b,), k_enc.shape[1], dtype=torch.int32,
                            device=x.device)
        out = decode_attention(q, k_enc, v_enc, length)
    else:
        out = flash_attention(q, k_enc, v_enc, causal=False)
    return out.reshape(b, s, h * hd) @ params["wo"]


def attention_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """``repro``'s ``attention_params`` tree: (in, out) matrices, the QKV
    bias where the config has one."""
    d, h, hkv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd = cfg.resolved_head_dim
    shapes = {"wq": (d, h * hd), "wk": (d, hkv * hd), "wv": (d, hkv * hd),
              "wo": (h * hd, d)}
    if cfg.qkv_bias:
        shapes.update({"bq": (h * hd,), "bk": (hkv * hd,),
                       "bv": (hkv * hd,)})
    return shapes


# ---------------------------------------------------------------------------
# MLA attention (deepseek-v2): compressed KV, shared rope key
# ---------------------------------------------------------------------------

def mla_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """``repro``'s ``mla_params`` tree: the kv compression (with the
    shared rope key), its decompression to k_nope and v, the output, and
    q through a low-rank pair where ``mla_q_lora`` > 0, else ``wq``."""
    d, h = cfg.d_model, cfg.num_heads
    qk_n, qk_r = cfg.mla_qk_nope_dim, cfg.mla_qk_rope_dim
    v_hd, r_kv, r_q = cfg.mla_v_head_dim, cfg.mla_kv_lora, cfg.mla_q_lora
    shapes = {"w_dkv": (d, r_kv + qk_r), "w_ukv": (r_kv, h * (qk_n + v_hd)),
              "wo": (h * v_hd, d)}
    if r_q:
        shapes.update({"w_dq": (d, r_q), "w_uq": (r_q, h * (qk_n + qk_r))})
    else:
        shapes["wq"] = (d, h * (qk_n + qk_r))
    return shapes


def _mla_absorbed(w_ukv: torch.Tensor, q_nope: torch.Tensor,
                  q_rope: torch.Tensor, c_cache: torch.Tensor,
                  r_cache: torch.Tensor, lim, cfg: ModelConfig) -> torch.Tensor:
    """MLA's absorbed decode step over the latent cache: q_nope (B,1,H,
    qk_nope) and q_rope (B,1,H,qk_rope) against c (B,T,r_kv) and r
    (B,T,qk_rope), positions >= ``lim`` (an int, or (B,1,1,1)) masked;
    returns (B,1,H,v_head_dim)."""
    h, r_kv = cfg.num_heads, cfg.mla_kv_lora
    qk_n, qk_r = cfg.mla_qk_nope_dim, cfg.mla_qk_rope_dim
    w_ukv = w_ukv.reshape(r_kv, h, qk_n + cfg.mla_v_head_dim)
    w_uk, w_uv = w_ukv[..., :qk_n], w_ukv[..., qk_n:]
    q_c = torch.einsum("bshn,rhn->bshr", q_nope, w_uk)       # (B,1,H,r_kv)
    s_c = torch.einsum("bshr,bTr->bhsT", q_c.float(), c_cache.float())
    s_r = torch.einsum("bshr,bTr->bhsT", q_rope.float(), r_cache.float())
    scores = (s_c + s_r) * (1.0 / math.sqrt(qk_n + qk_r))
    pos = torch.arange(c_cache.shape[1], device=c_cache.device)
    scores = torch.where(pos[None, None, None, :] < lim, scores, NEG)
    p = torch.softmax(scores, dim=-1).to(c_cache.dtype)
    out_c = torch.einsum("bhsT,bTr->bshr", p, c_cache)       # (B,1,H,r_kv)
    return torch.einsum("bshr,rhv->bshv", out_c, w_uv)


def mla_attention(params: Params, x: torch.Tensor, cfg: ModelConfig, *,
                  positions: torch.Tensor,
                  cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                  cache_index=None) -> Tuple[torch.Tensor, Optional[Tuple]]:
    """``repro``'s ``mla_attention``.  Returns (out, cache).

    ``cache`` is the latent pair (c (B,S,r_kv), r (B,S,qk_rope)), written
    IN PLACE at ``cache_index`` (an int, or a (B,) tensor of per-slot
    positions with s == 1).  A prefill expands K/V for the segment and
    runs K5 with q . k over qk_nope + qk_rope columns (the rope key
    shared by every head) and v at v_head_dim.  A decode step (s == 1
    with a cache) is absorbed: q_nope . w_uk gives q in the latent space,
    f32 scores against ``c`` and ``r`` (the operands upcast exactly, where
    XLA takes ``preferred_element_type=f32``) masked with -1e30 past each
    row's length, p in the cache's dtype, and (p . c) . w_uv; no kernel
    runs there, as no TPU kernel does in ``repro``."""
    b, s, _ = x.shape
    h = cfg.num_heads
    qk_n, qk_r = cfg.mla_qk_nope_dim, cfg.mla_qk_rope_dim
    v_hd, r_kv = cfg.mla_v_head_dim, cfg.mla_kv_lora
    if "w_dq" in params:
        q = (x @ params["w_dq"]) @ params["w_uq"]
    else:
        q = x @ params["wq"]
    q = q.reshape(b, s, h, qk_n + qk_r)
    q_nope, q_rope = q[..., :qk_n], q[..., qk_n:]
    q_rope = rope(q_rope, positions, cfg.rope_theta)
    ckv = x @ params["w_dkv"]                          # (B, S, r_kv + qk_r)
    c_kv, k_rope = ckv[..., :r_kv], ckv[..., r_kv:]
    k_rope = rope(k_rope[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]

    per_slot = isinstance(cache_index, torch.Tensor) and cache_index.dim()
    if cache is not None:
        c_cache, r_cache = cache
        if per_slot:
            rows = torch.arange(b, device=x.device)
            idx = cache_index.to(torch.int64)
            c_cache[rows, idx] = c_kv[:, 0].to(c_cache.dtype)
            r_cache[rows, idx] = k_rope[:, 0].to(r_cache.dtype)
        else:
            idx = int(cache_index)
            if idx + s > c_cache.shape[1]:
                raise ValueError(f"segment [{idx}, {idx + s}) exceeds the "
                                 f"cache length {c_cache.shape[1]}")
            c_cache[:, idx:idx + s] = c_kv.to(c_cache.dtype)
            r_cache[:, idx:idx + s] = k_rope.to(r_cache.dtype)

    if cache is not None and s == 1:
        lim = (idx + 1)[:, None, None, None] if per_slot else idx + 1
        out = _mla_absorbed(params["w_ukv"], q_nope, q_rope, c_cache, r_cache,
                            lim, cfg)
    else:
        kv = (c_kv @ params["w_ukv"]).reshape(b, s, h, qk_n + v_hd)
        k_nope, v = kv[..., :qk_n], kv[..., qk_n:]
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, h, qk_r)],
                      dim=-1)
        out = flash_attention(torch.cat([q_nope, q_rope], dim=-1), k, v,
                              causal=True)
    out = out.reshape(b, s, h * v_hd) @ params["wo"]
    return out, cache


# ---------------------------------------------------------------------------
# MLP, embedding, head
# ---------------------------------------------------------------------------

def mlp_shapes(cfg: ModelConfig, d_ff: int) -> Dict[str, Tuple[int, ...]]:
    """``repro``'s ``mlp_params`` tree: ``w3`` only for the silu-gated MLP."""
    shapes = {"w1": (cfg.d_model, d_ff), "w2": (d_ff, cfg.d_model)}
    if cfg.act == "silu":
        shapes["w3"] = (cfg.d_model, d_ff)
    return shapes


_ACTS = {
    "silu": F.silu,
    "relu2": lambda x: torch.square(F.relu(x)),
    # jax.nn.gelu's default is the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
}


def mlp(params: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """``act(x @ w1) @ w2``, gated by ``x @ w3`` where the tree has it (the
    silu MLPs: ``transformer.param_shapes`` gives ``w3`` only there)."""
    if cfg.act not in _ACTS:
        raise NotImplementedError(f"activation {cfg.act}")
    h = _ACTS[cfg.act](x @ params["w1"])
    if "w3" in params:
        h = h * (x @ params["w3"])
    return h @ params["w2"]


# ---------------------------------------------------------------------------
# MoE block: sort-based dropping dispatch with per-row expert capacity
# ---------------------------------------------------------------------------

MOE_QUANTIZED = ("w1", "w2", "w3")       # int8 leaves under moe_weight_dtype


def moe_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """``repro``'s ``moe_params`` tree: the router, the experts' stacked
    FFNs (e, in, out), their per-expert scales where the expert weights
    are int8, and the shared experts' FFN where the config has them."""
    d, e, f = cfg.d_model, cfg.moe_experts, cfg.moe_d_ff
    shapes = {"router": (d, e), "w1": (e, d, f), "w2": (e, f, d)}
    if cfg.act == "silu":
        shapes["w3"] = (e, d, f)
    if cfg.moe_weight_dtype == "int8":
        shapes.update({name + "_scale": (e,) for name in MOE_QUANTIZED
                       if name in shapes})
    if cfg.moe_shared_experts:
        fs = cfg.moe_shared_experts * f
        shapes.update({"sw1": (d, fs), "sw2": (fs, d)})
        if cfg.act == "silu":
            shapes["sw3"] = (d, fs)
    return shapes


def moe_dtypes(cfg: ModelConfig) -> Dict[str, torch.dtype]:
    """The MoE leaves not held in the working dtype: int8 expert weights
    and their f32 scales (``moe_weight_dtype == "int8"``)."""
    if cfg.moe_weight_dtype != "int8":
        return {}
    out = {}
    for name in moe_shapes(cfg):
        if name in MOE_QUANTIZED:
            out[name] = torch.int8
        elif name.endswith("_scale"):
            out[name] = torch.float32
    return out


def quantize_experts(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(e, in, out) weights -> int8 weights and (e,) f32 scales, as
    ``repro``'s ``moe_params``: scale = max |w| / 127 + 1e-12 per expert,
    round half to even, clip to +-127."""
    w = w.float()
    scale = w.abs().amax(dim=(1, 2)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(w / scale[:, None, None]), -127, 127)
    return q.to(torch.int8), scale


def _top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` on the last axis: the k largest in descending
    order, the lower index first among equal values (a stable sort)."""
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], ids[..., :k]


def _expert_weight(params: Params, name: str, dtype: torch.dtype):
    w = params[name]
    if w.dtype == torch.int8:        # serving quantization: dequant here
        w = w.to(dtype) * params[name + "_scale"].to(dtype)[:, None, None]
    return w


def _expert_ffn(params: Params, xin: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    """Every expert's FFN on its slots: xin (B, E, C, d) -> (B, E, C, d),
    one batched product over the experts a matrix (``torch.bmm`` of
    (E, B*C, in) by the stacked (E, in, out) weights, which are read as
    they are, never broadcast over B)."""
    b, e, c, d = xin.shape
    act = _ACTS[cfg.act]
    xe = xin.transpose(0, 1).reshape(e, b * c, d)
    h = act(torch.bmm(xe, _expert_weight(params, "w1", xin.dtype)))
    if "w3" in params:
        h = h * torch.bmm(xe, _expert_weight(params, "w3", xin.dtype))
    out = torch.bmm(h, _expert_weight(params, "w2", xin.dtype))
    return out.reshape(e, b, c, d).transpose(0, 1)


def moe_block(params: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x: (B,S,d).  ``repro``'s ``moe_block``: per batch row, the router's
    softmax, its top k renormalised, the (token, choice) slots sorted by
    expert (stably), each expert's first ``cap = ceil(S k 1.25 / E)``
    slots kept and the rest dropped, one gather of the kept tokens, the
    expert FFNs, the gate weights, the combine back to the tokens, and
    the shared experts.  The combine adds each token's k expert outputs
    in choice order by gathering them (``repro`` scatter-adds them): the
    same sums, and on the card a deterministic order, where an atomic
    scatter-add is not."""
    if cfg.act not in _ACTS:
        raise NotImplementedError(f"activation {cfg.act}")
    b, s, d = x.shape
    e, k = cfg.moe_experts, cfg.moe_top_k
    cap = max(1, int(math.ceil(s * k * cfg.moe_capacity_factor / e)))
    dev = x.device

    gate_logits = torch.matmul(x.float(), params["router"].float())
    weights, ids = _top_k(torch.softmax(gate_logits, dim=-1), k)
    weights = weights / weights.sum(-1, keepdim=True).clamp_min(1e-9)

    flat_ids = ids.reshape(b, s * k)                       # (B, S*k)
    flat_w = weights.reshape(b, s * k).to(x.dtype)
    token_of_slot = torch.arange(s, device=dev).repeat_interleave(k)
    order = torch.argsort(flat_ids, dim=-1, stable=True)   # per-row sort
    sorted_ids = flat_ids.gather(1, order)
    sorted_tok = token_of_slot[order]                      # (B, S*k)
    sorted_w = flat_w.gather(1, order)
    # within-expert rank of each sorted slot; overflow goes to column
    # e * cap, which is cut off (repro's out-of-bounds drop)
    starts = torch.searchsorted(
        sorted_ids, torch.arange(e, device=dev).expand(b, e).contiguous())
    rank = torch.arange(s * k, device=dev)[None, :] \
        - starts.gather(1, sorted_ids)
    slot = torch.where(rank < cap, sorted_ids * cap + rank,
                       torch.full_like(rank, e * cap))
    tok_for_slot = torch.full((b, e * cap + 1), s, dtype=torch.int64,
                              device=dev).scatter_(1, slot, sorted_tok)
    w_for_slot = torch.zeros((b, e * cap + 1), dtype=x.dtype,
                             device=dev).scatter_(1, slot, sorted_w)

    # one gather fills the expert slots (token s: the zero row)
    rows = torch.arange(b, device=dev)[:, None]
    xpad = torch.cat([x, x.new_zeros((b, 1, d))], dim=1)
    xin = xpad[rows, tok_for_slot[:, :e * cap]].reshape(b, e, cap, d)
    eout = _expert_ffn(params, xin, cfg) \
        * w_for_slot[:, :e * cap].reshape(b, e, cap)[..., None]

    # combine: token t's choice j reads its slot (column e * cap: zeros)
    slot_of_choice = torch.empty_like(slot).scatter_(1, order, slot) \
        .reshape(b, s, k)
    eflat = torch.cat([eout.reshape(b, e * cap, d), x.new_zeros((b, 1, d))],
                      dim=1)
    out = torch.zeros_like(x)
    for j in range(k):
        out = out + eflat[rows, slot_of_choice[:, :, j]]

    if cfg.moe_shared_experts:
        act = _ACTS[cfg.act]
        hs = act(x @ params["sw1"])
        if "sw3" in params:
            hs = hs * (x @ params["sw3"])
        out = out + hs @ params["sw2"]
    return out


def embed(params: Params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return params["embedding"][tokens.to(torch.int64)].to(dt(cfg))


def logits_fn(params: Params, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """f32 logits: an f32 product of the operands upcast exactly from the
    working dtype (a bf16 product would round the logits to bf16 and
    make argmax ties likely over a 151,936-token vocabulary)."""
    w = params["lm_head"] if "lm_head" in params else params["embedding"].T
    return torch.matmul(h.float(), w.float())
