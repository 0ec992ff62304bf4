"""Public flash-attention wrappers: CPU tensors take the plain versions,
CUDA tensors launch a CUDA kernel (or raise).

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

from .kernel import (bwd_route, flash_attention_bwd_cuda, flash_attention_cuda,
                     route)
from .ref import flash_attention_bwd_ref, flash_attention_fwd_ref, \
    flash_attention_ref


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
        q, k, v = (_aligned(t) for t in (q, k, v))
        if q.device.type == "cpu":
            o, lse = flash_attention_fwd_ref(q, k, v, causal=causal)
        else:
            o, lse = flash_attention_cuda(q, k, v, causal=causal,
                                          with_lse=True)
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
        else:
            dq, dk, dv = flash_attention_bwd_cuda(q, k, v, o, lse,
                                                  _aligned(do),
                                                  causal=ctx.causal)
            flash_attention.bwd_launches += 1
            if bwd_route(q.dtype, q.shape[-1], v.shape[-1]) == "tc":
                flash_attention.bwd_tc_launches += 1
        return dq, dk, dv, None
