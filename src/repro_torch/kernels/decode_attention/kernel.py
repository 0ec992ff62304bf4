"""Launcher of the CUDA decode-attention kernel (``csrc/decode_attention.cu``).

K3 ``decode_attention_cuda`` replaces ``decode_attention_pallas``
(``repro/kernels/decode_attention/kernel.py``); the design notes sit in
the CUDA source.  The split-KV partials and the output are allocated
here with ``torch.empty``; the kernels launch on the current stream.
"""
from __future__ import annotations

import math

import torch

from .. import build

SM_COUNT_TARGET = 2 * 132     # blocks to aim for: two waves of an H100's SMs
TILE = 32                     # positions per tile (csrc kTile)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_SMEM_LIMIT = 227 * 1024


def num_splits(b: int, hkv: int, s: int) -> int:
    """Splits of each row's valid range: enough blocks for the card at
    small batch, never more than the cache has tiles."""
    want = -(-SM_COUNT_TARGET // max(b * hkv, 1))
    return max(1, min(want, -(-s // TILE)))


def decode_attention_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor,
                          length: torch.Tensor) -> torch.Tensor:
    """q: (B,H,hd); caches: (B,S,Hkv,hd); length: (B,) int32 -> (B,H,hd)."""
    dev = q.device
    for t in (q, k_cache, v_cache, length):
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError("decode_attention: expects tensors on one CUDA "
                             "device")
        if not t.is_contiguous():
            raise ValueError("decode_attention: expects contiguous tensors")
    if q.dtype not in _DTYPES or k_cache.dtype != q.dtype \
            or v_cache.dtype != q.dtype:
        raise ValueError(f"decode_attention: q/k/v must share one of "
                         f"{list(_DTYPES)}, got {q.dtype}, {k_cache.dtype}, "
                         f"{v_cache.dtype}")
    if length.dtype != torch.int32:
        raise ValueError("decode_attention: length must be int32")
    b, h, hd = q.shape
    _, s, hkv, hd_k = k_cache.shape
    if k_cache.shape != v_cache.shape or k_cache.shape[0] != b \
            or hd_k != hd or h % hkv or length.shape != (b,):
        raise ValueError("decode_attention: mismatched shapes")
    g = h // hkv
    smem = 4 * (2 * g * hd + TILE * (hd + 1) + g * TILE + 3 * g)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"decode_attention: g={g}, hd={hd} needs {smem} "
                         "bytes of shared memory")
    out = torch.empty_like(q)
    if b == 0:
        return out
    splits = num_splits(b, hkv, s)
    m_part = torch.empty((b, hkv, splits, g), dtype=torch.float32, device=dev)
    l_part = torch.empty_like(m_part)
    acc_part = torch.empty((b, hkv, splits, g, hd), dtype=torch.float32,
                           device=dev)
    per_vec = 16 // q.element_size()
    vec = hd % per_vec == 0 and k_cache.data_ptr() % 16 == 0 \
        and v_cache.data_ptr() % 16 == 0
    build.launch("decode_attention_launch", q.data_ptr(), k_cache.data_ptr(),
                 v_cache.data_ptr(), length.data_ptr(), out.data_ptr(),
                 m_part.data_ptr(), l_part.data_ptr(), acc_part.data_ptr(),
                 b, s, h, hkv, hd, splits, _DTYPES[q.dtype], int(vec),
                 1.0 / math.sqrt(hd), torch.cuda.current_stream(dev).cuda_stream)
    return out
