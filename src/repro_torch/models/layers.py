"""Model building blocks of the port: ``repro.models.layers`` on torch
tensors (GQA attention, the MLPs, the MoE block, embedding and head;
MLA comes with its own slice).

Dtypes follow ``repro``: ``rms_norm`` and ``rope`` compute in f32 and
cast back; attention scores are f32 from the working-dtype operands; the
logits are f32.  Where XLA takes ``preferred_element_type=f32`` with
bf16 operands, the port upcasts the operands to f32 (exact) and runs an
f32 product, with TF32 off on the card (``kernels.backend.strict_fp32``).
Whole-prompt prefill attention goes through the K5 wrapper and decode
attention through the K3 wrapper (CUDA kernels on the card, their plain
versions on the CPU); a continuation prefill chunk attends at a query
offset that K5 does not take, so it stays plain torch, as ``repro``
leaves it to XLA.
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
              cache_index=None, chunk: bool = False
              ) -> Tuple[torch.Tensor, Optional[Tuple]]:
    """GQA attention with QKV bias.  Returns (out, cache).

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
    q = rope(q.reshape(b, s, h, hd), positions, cfg.rope_theta)
    k = rope(k.reshape(b, s, hkv, hd), positions, cfg.rope_theta)
    v = v.reshape(b, s, hkv, hd)
    if cache is None:
        out = flash_attention(q, k, v, causal=True)
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
            out = flash_attention(q, k, v, causal=True)
        cache = (k_cache, v_cache)
    out = out.reshape(b, s, h * hd) @ params["wo"]
    return out, cache


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
