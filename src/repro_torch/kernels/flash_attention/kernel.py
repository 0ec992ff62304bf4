# repro-lint: allow(RL004) -- one launch shape (BQ), compiled in
"""Launchers of the CUDA flash-attention kernels (``csrc/flash_attention.cu``
and ``csrc/flash_attention_tc.cu``, the forward, K5; and
``csrc/flash_attention_bwd.cu``, its gradient, K5b).

K5 ``flash_attention_cuda`` replaces ``flash_attention_pallas``
(``repro/kernels/flash_attention/kernel.py``) on two routes, picked from
q's dtype and the (q . k, v) head dims alone before any launch
(``route``): bf16 and fp16 at hd 64, 112 and 128, and at MLA's q . k
width 192 with v at 128, run on the tensor cores (wgmma, TMA; hd 112 on
the hd-128 tiles, whose last 16 columns the TMA fills with zeros),
everything else (f32, hd 16 and 32) on the f32 SIMT kernel, whose 2e-5
tolerance the tensor cores cannot meet.  ``with_lse=True`` (the training
forward) also returns each row's natural-log logsumexp of its scaled
scores, f32 (B, H, Sq), which K5b reads back.

K5b ``flash_attention_bwd_cuda`` has no TPU counterpart (``repro``
differentiates its jnp flash path with ``jax.grad``): it takes the
forward's q, k, v, o, lse and dO and returns dq, dk, dv in three
launches (D = rowsum(dO o), dK/dV, dQ), on the tensor cores (wgmma, TMA)
for bf16 and fp16 at (hd, v hd) in ``BWD_HEAD_DIMS`` (zamba2's hd 112
and MLA's (192, 128) among them) and on the CUDA cores for f32 at
``BWD_SIMT_HEAD_DIMS`` (``bwd_route``), causal only with Sq == Sk,
unmasked at any Sq and Sk (whisper's encoder and cross attention);
anything else raises
``ValueError`` before a launch.  The design notes sit in the
CUDA sources.  Outputs and scratch are allocated here with
``torch.empty``; the kernels launch on the current stream and do not
synchronise.  K5 has no run-time launch shape: the wgmma warpgroup and
the TMA boxes fix its block of query rows, ``BQ``, at 64 on both routes,
autotune's one ``flash_attention`` candidate, so there is nothing to
resolve through ``autotune.tiles_for`` (hence the RL004 pragma above).
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
BWD_HEAD_DIMS = ((64, 64), (112, 112), (128, 128), (192, 128))  # K5b's
# tensor cores' (hd 112 on the hd-128 tiles, as K5's forward)
BWD_SIMT_HEAD_DIMS = ((64, 64), (128, 128))          # K5b's f32 kernels'


def route(dtype: torch.dtype, dqk: int, dv: Optional[int] = None) -> str:
    """``"tc"`` (tensor cores) for bf16/fp16 at (dqk, dv) in
    ``TC_HEAD_DIMS`` (dv defaults to dqk), else ``"simt"``."""
    dv = dqk if dv is None else dv
    return "tc" if dtype in TC_DTYPES and (dqk, dv) in TC_HEAD_DIMS \
        else "simt"


def bwd_route(dtype: torch.dtype, dqk: int, dv: Optional[int] = None) -> str:
    """K5b's route: ``"tc"`` for bf16/fp16 at (dqk, dv) in
    ``BWD_HEAD_DIMS`` (zamba2's hd 112 among them), ``"simt"`` for f32 at
    ``BWD_SIMT_HEAD_DIMS`` (dv defaults to dqk); raises ``ValueError`` for
    any other type or head dims (hd 16 and 32, and f32 at hd 112 and at
    MLA's (192, 128))."""
    dv = dqk if dv is None else dv
    if dtype in TC_DTYPES and (dqk, dv) in BWD_HEAD_DIMS:
        return "tc"
    if dtype == torch.float32 and (dqk, dv) in BWD_SIMT_HEAD_DIMS:
        return "simt"
    raise ValueError(f"flash_attention backward: no kernel for {dtype} at "
                     f"head dims (q.k {dqk}, v {dv}); it takes {TC_DTYPES} "
                     f"at {BWD_HEAD_DIMS} and float32 at "
                     f"{BWD_SIMT_HEAD_DIMS}")


def _check(name: str, *ts: torch.Tensor) -> None:
    dev = ts[0].device
    for t in ts:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: expects tensors on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expects contiguous tensors")
    if ts[0].dtype not in _DTYPES or any(t.dtype != ts[0].dtype for t in ts):
        raise ValueError(f"{name}: tensors must share one of {list(_DTYPES)}, "
                         f"got {[t.dtype for t in ts]}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool, with_lse: bool = False):
    """q: (B,Sq,H,dqk); k: (B,Sk,Hkv,dqk); v: (B,Sk,Hkv,dv) ->
    (B,Sq,H,dv) in q's dtype, scaled by 1/sqrt(dqk); with ``with_lse``,
    (out, lse) with lse f32 (B, H, Sq)."""
    dev = q.device
    _check("flash_attention", q, k, v)
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
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=dev) \
        if with_lse else None
    build.launch(entry, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 out.data_ptr(), 0 if lse is None else lse.data_ptr(),
                 b, sq, sk, h, hkv, hd, hdv, int(causal),
                 _DTYPES[q.dtype], 1.0 / math.sqrt(hd),
                 torch.cuda.current_stream(dev).cuda_stream)
    return (out, lse) if with_lse else out


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             lse: torch.Tensor, do: torch.Tensor, *,
                             causal: bool):
    """K5b: the gradients (dq, dk, dv) of ``flash_attention_cuda`` at
    (q, k, v), from its output ``o``, its ``lse`` and the output gradient
    ``do`` (B,Sq,H,dv), each in q's dtype; dk and dv summed over each kv
    head's query heads."""
    dev = q.device
    _check("flash_attention backward", q, k, v, o, do)
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention backward: expects (B, S, heads, "
                         "hd) tensors")
    b, sq, h, hd = q.shape
    _, sk, hkv, _ = k.shape
    hdv = v.shape[3]
    route_ = bwd_route(q.dtype, hd, hdv)
    if k.shape[:3] != v.shape[:3] or k.shape[0] != b or k.shape[3] != hd \
            or hkv < 1 or h % hkv or o.shape != (b, sq, h, hdv) \
            or do.shape != o.shape:
        raise ValueError(f"flash_attention backward: mismatched shapes "
                         f"{q.shape}, {k.shape}, {v.shape}, {o.shape}, "
                         f"{do.shape}")
    if causal and sq != sk:
        raise ValueError(f"flash_attention backward: causal needs Sq == Sk, "
                         f"got {sq} and {sk}")
    if lse.shape != (b, h, sq) or lse.dtype != torch.float32 \
            or lse.device != dev or not lse.is_contiguous():
        raise ValueError(f"flash_attention backward: lse must be f32 "
                         f"{(b, h, sq)} on {dev}, got {lse.dtype} "
                         f"{tuple(lse.shape)}")
    if not (q.numel() and k.numel()) or -(-sq // BQ) > 65535:
        raise ValueError(f"flash_attention backward: takes 1 <= Sq <= "
                         f"{65535 * BQ} and Sk >= 1, got {q.shape}, {k.shape}")
    entry = "flash_attention_bwd_launch"
    if route_ == "tc":
        entry = "flash_attention_bwd_tc_launch"
        if any(t.data_ptr() % 16 for t in (q, k, v, o, do)):  # TMA, 16 B loads
            raise ValueError("flash_attention backward: the tensor-core "
                             "route needs 16-byte-aligned q, k, v, o, dO")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    # the f32 route's D (B, H, Sq); the tensor cores' lse * log2 e and D,
    # rows padded to a multiple of BQ for the TMA
    delta = torch.empty((2, b, h, -(-sq // BQ) * BQ) if route_ == "tc"
                        else (b, h, sq), dtype=torch.float32, device=dev)
    build.launch(entry, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 o.data_ptr(), do.data_ptr(), lse.data_ptr(), dq.data_ptr(),
                 dk.data_ptr(), dv.data_ptr(), delta.data_ptr(), b, sq, sk, h,
                 hkv, hd, hdv, int(causal), _DTYPES[q.dtype],
                 1.0 / math.sqrt(hd),
                 torch.cuda.current_stream(dev).cuda_stream)
    return dq, dk, dv
