"""Model building blocks of the port: the dense subset of
``repro.models.layers`` on torch tensors.

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


# ---------------------------------------------------------------------------
# MLP, embedding, head
# ---------------------------------------------------------------------------

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


def embed(params: Params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return params["embedding"][tokens.to(torch.int64)].to(dt(cfg))


def logits_fn(params: Params, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """f32 logits: an f32 product of the operands upcast exactly from the
    working dtype (a bf16 product would round the logits to bf16 and
    make argmax ties likely over a 151,936-token vocabulary)."""
    w = params["lm_head"] if "lm_head" in params else params["embedding"].T
    return torch.matmul(h.float(), w.float())
