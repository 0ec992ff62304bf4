"""Launcher of the CUDA flash-attention kernel (``csrc/flash_attention.cu``).

K5 ``flash_attention_cuda`` replaces ``flash_attention_pallas``
(``repro/kernels/flash_attention/kernel.py``); the design notes sit in
the CUDA source.  The output is allocated here with ``torch.empty``;
the kernel launches on the current stream and does not synchronise.
"""
from __future__ import annotations

import math

import torch

from .. import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
HEAD_DIMS = (16, 32, 64, 128)       # the kernel's instantiations
BQ = 64                             # query rows per block (csrc kBQ)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool) -> torch.Tensor:
    """q: (B,Sq,H,hd); k/v: (B,Sk,Hkv,hd) -> (B,Sq,H,hd) in q's dtype."""
    dev = q.device
    for t in (q, k, v):
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError("flash_attention: expects tensors on one CUDA "
                             "device")
        if not t.is_contiguous():
            raise ValueError("flash_attention: expects contiguous tensors")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: q/k/v must share one of "
                         f"{list(_DTYPES)}, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("flash_attention: expects (B, S, heads, hd) tensors")
    b, sq, h, hd = q.shape
    _, sk, hkv, _ = k.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd \
            or hkv < 1 or h % hkv:
        raise ValueError(f"flash_attention: mismatched shapes {q.shape}, "
                         f"{k.shape}, {v.shape}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd} not in {HEAD_DIMS}")
    if not (q.numel() and k.numel()) or -(-sq // BQ) > 65535:
        raise ValueError(f"flash_attention: takes 1 <= Sq <= {65535 * BQ} "
                         f"and Sk >= 1, got {q.shape}, {k.shape}")
    out = torch.empty_like(q)
    build.launch("flash_attention_launch", q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), out.data_ptr(), b, sq, sk, h, hkv, hd,
                 int(causal), _DTYPES[q.dtype], 1.0 / math.sqrt(hd),
                 torch.cuda.current_stream(dev).cuda_stream)
    return out
