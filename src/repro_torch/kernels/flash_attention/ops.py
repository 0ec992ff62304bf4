"""Public flash-attention wrappers: CPU tensors take the plain versions,
CUDA tensors launch a CUDA kernel (or raise), and ``meta`` tensors take
the meta route, which makes the outputs' shapes and dtypes and nothing
else.  On the card and on ``meta`` each call charges its work
(``flash_attention_work``, ``flash_attention_bwd_work``) to the active
cost counter (``backend.charged``) under "K5" or "K5b".

``flash_attention`` is the forward alone (K5, the serve path).
``flash_attention.launches`` counts its kernel launches, and
``flash_attention.tc_launches`` / ``.simt_launches`` those of each route
(``kernel.route``); the training forward below counts there too.

``FlashAttentionFn`` is the differentiable attention of the training
path: its forward runs K5 with the rows' logsumexp (or
``flash_attention_fwd_ref`` on the CPU) and saves q, k, v, o and lse; its
backward runs K5b (``flash_attention_bwd_cuda``, or
``flash_attention_bwd_ref`` on the CPU).  ``flash_attention.bwd_launches``
counts K5b's calls (each three kernel launches: D, dK/dV, dQ) and
``flash_attention.bwd_tc_launches`` those on the tensor-core route
(``kernel.bwd_route``).
"""
from __future__ import annotations

import torch

from ..backend import charged
from .kernel import (bwd_route, flash_attention_bwd_cuda, flash_attention_cuda,
                     route)
from .ref import flash_attention_bwd_ref, flash_attention_fwd_ref, \
    flash_attention_ref


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def attended_pairs(sq: int, sk: int, causal: bool) -> int:
    """The (query, key) pairs the mask lets through: all Sq Sk without
    one; with the top-left aligned causal mask query i sees keys 0..i (at
    most Sk of them)."""
    if not causal:
        return sq * sk
    m = min(sq, sk)
    return m * (m + 1) // 2 + (sq - m) * sk


def flash_attention_work(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool, with_lse: bool = False) -> dict:
    """K5's work on these inputs: q, k and v read once and the output
    (B, Sq, H, dv) written once (and the rows' f32 logsumexp, (B, H, Sq),
    ``with_lse``); q . k and p . v, 2 (hd + dv) FLOPs a head and attended
    pair, as matmul FLOPs in q's type, over only the pairs the mask lets
    through."""
    b, sq, h, hd = q.shape
    sk, dv = k.shape[1], v.shape[-1]
    size = q.element_size()
    nbytes = size * (q.numel() + k.numel() + v.numel() + b * sq * h * dv)
    return {"bytes": nbytes + (4 * b * h * sq if with_lse else 0),
            "matmul_flops": 2 * b * h * (hd + dv)
            * attended_pairs(sq, sk, causal),
            "ops": 0, "type": _dtype_name(q)}


def flash_attention_bwd_work(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, causal: bool) -> dict:
    """K5b's work on these inputs: q, k, v, o and dO read once (o and dO
    at v's head dim), the f32 logsumexp read once, dq, dk and dv written
    once; its five products (q K^T, dS^T q and dS K at q . k's width, dO
    V^T and P^T dO at v's), 2 (3 hd + 2 dv) FLOPs a head and attended
    pair, as matmul FLOPs in q's type."""
    b, sq, h, hd = q.shape
    sk, dv = k.shape[1], v.shape[-1]
    size = q.element_size()
    o = b * sq * h * dv
    return {"bytes": size * 2 * (q.numel() + k.numel() + v.numel() + o)
            + 4 * b * h * sq,
            "matmul_flops": 2 * b * h * (3 * hd + 2 * dv)
            * attended_pairs(sq, sk, causal),
            "ops": 0, "type": _dtype_name(q)}


def _meta_forward(q: torch.Tensor, v: torch.Tensor):
    """The meta route of K5: the output and the rows' logsumexp, empty."""
    b, sq, h = q.shape[:3]
    return (q.new_empty((b, sq, h, v.shape[-1])),
            torch.empty((b, h, sq), dtype=torch.float32, device=q.device))


def _meta_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """The meta route of K5b: dq, dk, dv, empty."""
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _count_forward(q: torch.Tensor, v: torch.Tensor) -> None:
    flash_attention.launches += 1
    if route(q.dtype, q.shape[-1], v.shape[-1]) == "tc":
        flash_attention.tc_launches += 1
    else:
        flash_attention.simt_launches += 1


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool) -> torch.Tensor:
    """q: (B,Sq,H,dqk); k: (B,Sk,Hkv,dqk); v: (B,Sk,Hkv,dv) -> (B,Sq,H,dv)
    (K5; dv == dqk but for MLA's prefill).  Causal masks top-left aligned
    (query i sees keys 0..i), as the TPU kernel."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal)
    with charged("K5", flash_attention_work(q, k, v, causal=causal)):
        if q.device.type == "meta":
            return _meta_forward(q, v)[0]
        out = flash_attention_cuda(q, k, v, causal=causal)
    _count_forward(q, v)
    return out


flash_attention.launches = 0
flash_attention.tc_launches = 0
flash_attention.simt_launches = 0
flash_attention.bwd_launches = 0
flash_attention.bwd_tc_launches = 0


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte-aligned address (what the
    tensor-core routes load from); a copy only where it is not."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


class FlashAttentionFn(torch.autograd.Function):
    """``flash_attention`` with a gradient: ``FlashAttentionFn.apply(q, k,
    v, causal)``."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        if q.device.type == "cpu":
            q, k, v = (_aligned(t) for t in (q, k, v))
            o, lse = flash_attention_fwd_ref(q, k, v, causal=causal)
        else:
            with charged("K5", flash_attention_work(q, k, v, causal=causal,
                                                    with_lse=True)):
                q, k, v = (_aligned(t) for t in (q, k, v))
                if q.device.type == "meta":
                    o, lse = _meta_forward(q, v)
                else:
                    o, lse = flash_attention_cuda(q, k, v, causal=causal,
                                                  with_lse=True)
            if q.device.type != "meta":
                _count_forward(q, v)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if q.device.type == "cpu":
            dq, dk, dv = flash_attention_bwd_ref(q, k, v, o, lse, do,
                                                 causal=ctx.causal)
            return dq, dk, dv, None
        with charged("K5b", flash_attention_bwd_work(q, k, v,
                                                     causal=ctx.causal)):
            if q.device.type == "meta":
                return _meta_backward(q, k, v) + (None,)
            dq, dk, dv = flash_attention_bwd_cuda(q, k, v, o, lse,
                                                  _aligned(do),
                                                  causal=ctx.causal)
        flash_attention.bwd_launches += 1
        if bwd_route(q.dtype, q.shape[-1], v.shape[-1]) == "tc":
            flash_attention.bwd_tc_launches += 1
        return dq, dk, dv, None
