"""Launcher of the CUDA flash-attention kernels (``csrc/flash_attention.cu``
and ``csrc/flash_attention_tc.cu``).

K5 ``flash_attention_cuda`` replaces ``flash_attention_pallas``
(``repro/kernels/flash_attention/kernel.py``) on two routes, picked from
q's dtype and the (q . k, v) head dims alone before any launch
(``route``): bf16 and fp16 at hd 64, 112 and 128, and at MLA's q . k
width 192 with v at 128, run on the tensor cores (wgmma, TMA; hd 112 on
the hd-128 tiles, whose last 16 columns the TMA fills with zeros),
everything else (f32, hd 16 and 32) on the f32 SIMT kernel, whose 2e-5
tolerance the tensor cores cannot meet.  The design notes sit in the CUDA
sources.  The output is allocated here with ``torch.empty``; the kernels
launch on the current stream and do not synchronise.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .. import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# (q . k head dim, v head dim) of each instantiation
HEAD_DIMS = ((16, 16), (32, 32), (64, 64), (112, 112), (128, 128),
             (192, 128))                          # the SIMT kernel's
TC_DTYPES = (torch.bfloat16, torch.float16)
TC_HEAD_DIMS = ((64, 64), (112, 112), (128, 128), (192, 128))  # tensor cores'
BQ = 64                             # query rows per block (both kernels)


def route(dtype: torch.dtype, dqk: int, dv: Optional[int] = None) -> str:
    """``"tc"`` (tensor cores) for bf16/fp16 at (dqk, dv) in
    ``TC_HEAD_DIMS`` (dv defaults to dqk), else ``"simt"``."""
    dv = dqk if dv is None else dv
    return "tc" if dtype in TC_DTYPES and (dqk, dv) in TC_HEAD_DIMS \
        else "simt"


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool) -> torch.Tensor:
    """q: (B,Sq,H,dqk); k: (B,Sk,Hkv,dqk); v: (B,Sk,Hkv,dv) ->
    (B,Sq,H,dv) in q's dtype, scaled by 1/sqrt(dqk)."""
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
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: expects (B, S, heads, hd) tensors")
    b, sq, h, hd = q.shape
    _, sk, hkv, _ = k.shape
    hdv = v.shape[3]
    if k.shape[:3] != v.shape[:3] or k.shape[0] != b or k.shape[3] != hd \
            or hkv < 1 or h % hkv:
        raise ValueError(f"flash_attention: mismatched shapes {q.shape}, "
                         f"{k.shape}, {v.shape}")
    if (hd, hdv) not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dims (q.k {hd}, v {hdv}) "
                         f"not in {HEAD_DIMS}")
    if not (q.numel() and k.numel()) or -(-sq // BQ) > 65535:
        raise ValueError(f"flash_attention: takes 1 <= Sq <= {65535 * BQ} "
                         f"and Sk >= 1, got {q.shape}, {k.shape}")
    entry = "flash_attention_launch"
    if route(q.dtype, hd, hdv) == "tc":
        entry = "flash_attention_tc_launch"
        if any(t.data_ptr() % 16 for t in (q, k, v)):   # TMA's base address
            raise ValueError("flash_attention: the tensor-core route needs "
                             "16-byte-aligned q, k and v")
    out = torch.empty((b, sq, h, hdv), dtype=q.dtype, device=dev)
    build.launch(entry, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 out.data_ptr(), b, sq, sk, h, hkv, hd, hdv, int(causal),
                 _DTYPES[q.dtype], 1.0 / math.sqrt(hd),
                 torch.cuda.current_stream(dev).cuda_stream)
    return out
