"""Launchers of the CUDA decode-attention kernels
(``csrc/decode_attention_tc.cu`` and ``csrc/decode_attention.cu``).

K3 ``decode_attention_cuda`` replaces ``decode_attention_pallas``
(``repro/kernels/decode_attention/kernel.py``) on two routes, picked from
the dtype and the head layout alone before any launch (``route``): bf16
and fp16 at hd % 16 == 0 (hd <= 128) with g = H / Hkv <= 16 run on the
tensor cores in one launch, everything else (f32, other head layouts) on
the SIMT split and combine kernels, whose f32 arithmetic meets the 2e-5
tolerance.  The design notes sit in the CUDA sources.  Outputs are
allocated here with ``torch.empty``; the kernels launch on the current
stream and do not synchronise.
"""
from __future__ import annotations

import math

import torch

from .. import build
from ..backend import raw_stream

SM_COUNT_TARGET = 2 * 132     # SIMT: blocks to aim for, two waves of SMs
TILE = 32                     # SIMT: positions per tile (csrc kTile)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_SMEM_LIMIT = 227 * 1024

TC_DTYPES = (torch.bfloat16, torch.float16)
TC_MAX_HD = 128
TC_MAX_GROUP = 16             # query heads of a kv head: the MMA's 16 rows
CHUNKS = (512, 256, 128, 64)  # positions a tensor-core block owns: multiples
#                               of its 4 warps x 16-position tiles
TC_BLOCKS_TARGET = 128        # blocks over the whole cache, about one an SM:
#                               the fastest chunks of chip_kernel_steps.py's
#                               sweep at S 2048, B 8-32 (PERF.md)


def route(dtype: torch.dtype, hd: int, group: int) -> str:
    """``"tc"`` (tensor cores) for bf16/fp16 at hd % 16 == 0, hd <= 128
    and g <= 16 query heads a kv head, else ``"simt"``."""
    return "tc" if dtype in TC_DTYPES and hd % 16 == 0 and hd <= TC_MAX_HD \
        and group <= TC_MAX_GROUP else "simt"


def num_splits(b: int, hkv: int, s: int) -> int:
    """SIMT: splits of each row's valid range, enough blocks for the card
    at small batch, never more than the cache has tiles."""
    want = -(-SM_COUNT_TARGET // max(b * hkv, 1))
    return max(1, min(want, -(-s // TILE)))


def chunk_positions(b: int, hkv: int, s: int) -> int:
    """Tensor cores: the positions each block owns, the largest of
    ``CHUNKS`` that still gives ``TC_BLOCKS_TARGET`` blocks over the cache
    (so the grid grows with B and S), else the smallest."""
    for c in CHUNKS:
        if b * hkv * -(-s // c) >= TC_BLOCKS_TARGET:
            return c
    return CHUNKS[-1]


# per (device, stream): the merge's partials and its per-(row, kv head)
# arrival counters, which every call leaves at 0 for the next one
_scratch: dict = {}


def tc_scratch(dev: torch.device, stream: int, rows: int, floats: int):
    """(partials, counters) of at least ``floats`` f32 and ``rows`` words
    for calls on ``stream`` of ``dev``."""
    key = (dev, stream)
    have = _scratch.get(key)
    if have is None or have[0].numel() < floats or have[1].numel() < rows:
        if have is not None:
            floats = max(floats, have[0].numel())
            rows = max(rows, have[1].numel())
        have = _scratch[key] = (
            torch.empty(floats, dtype=torch.float32, device=dev),
            torch.zeros(rows, dtype=torch.int32, device=dev))
    return have


def _check(q, k_cache, v_cache, length):
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
    return b, s, h, hkv, hd


def decode_attention_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor,
                          length: torch.Tensor) -> torch.Tensor:
    """q: (B,H,hd); caches: (B,S,Hkv,hd); length: (B,) int32 -> (B,H,hd),
    on the route ``route`` picks."""
    dims = _check(q, k_cache, v_cache, length)
    b, s, h, hkv, hd = dims
    if route(q.dtype, hd, h // hkv) == "tc":
        return _launch_tc(q, k_cache, v_cache, length, dims,
                          chunk_positions(b, hkv, s))
    return _launch_simt(q, k_cache, v_cache, length, dims)


def _launch_tc(q, k_cache, v_cache, length, dims, chunk):
    b, s, h, hkv, hd = dims
    if any(t.data_ptr() % 16 for t in (q, k_cache, v_cache)):
        raise ValueError("decode_attention: the tensor-core route needs "
                         "16-byte-aligned q, k and v (cp.async)")
    out = torch.empty_like(q)
    if b == 0:
        return out
    dev = q.device
    stream = raw_stream(dev)
    part, count = tc_scratch(dev, stream, b * hkv,
                             b * -(-s // chunk) * h * (hd + 2))
    build.launch("decode_attention_tc_launch", q.data_ptr(),
                 k_cache.data_ptr(), v_cache.data_ptr(), length.data_ptr(),
                 out.data_ptr(), part.data_ptr(), count.data_ptr(), b, s, h,
                 hkv, hd, chunk, _DTYPES[q.dtype], 1.0 / math.sqrt(hd), stream)
    return out


def _launch_simt(q, k_cache, v_cache, length, dims):
    """The SIMT route: a split kernel and a combine kernel."""
    b, s, h, hkv, hd = dims
    g = h // hkv
    smem = 4 * (2 * g * hd + TILE * (hd + 1) + g * TILE + 3 * g)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"decode_attention: g={g}, hd={hd} needs {smem} "
                         "bytes of shared memory")
    out = torch.empty_like(q)
    if b == 0:
        return out
    dev = q.device
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
                 1.0 / math.sqrt(hd), raw_stream(dev))
    return out
