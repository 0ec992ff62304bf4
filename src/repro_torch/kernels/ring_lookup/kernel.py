"""Launchers of the CUDA ring-lookup kernels (``csrc/ring_lookup.cu``).

K1 ``ring_lookup64_cuda`` replaces ``ring_lookup64_pallas``, K2
``ring_lookup_bucketed_cuda`` replaces ``ring_lookup_bucketed_pallas``
and K7 ``ring_lookup_cuda`` replaces ``ring_lookup_pallas``
(``repro/kernels/ring_lookup/kernel.py``); the design notes sit in the
CUDA source.  Each launch shape (K1's grid cap, K2's and K7's route
switches) comes from ``autotune.tiles_for`` for the tensors' device and
shape, or from ``tiles=`` (a search's candidate).  Outputs are allocated
here with ``torch.empty``; the kernels launch on the current stream and
do not synchronise.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import build
from ..autotune import tiles_for
from ..backend import raw_stream


def _check(name: str, *tensors: torch.Tensor) -> torch.device:
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: expects tensors on one CUDA device, "
                             f"got {[str(x.device) for x in tensors]}")
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name}: expects contiguous int32 tensors")
    return dev


# K7's sample tree scratch: kK7Sample + 1 words of csrc/ring_lookup.cu, one
# buffer per (device, stream), which each call overwrites before it reads it
K7_TREE_WORDS = 32768
K7_SAMPLE_KEYS = 65536   # K7 takes one level up to this Q (measured on H100;
#                          autotune's default ``sample_keys``)
K7_ROUTES = ("one_level", "sampled")
_k7_scratch: dict = {}


def k7_route(q: int, sample_keys: int = K7_SAMPLE_KEYS) -> str:
    """The route K7 takes for ``q`` keys: ``"one_level"`` (a thread a key,
    one lower bound over the table) up to ``sample_keys``, else
    ``"sampled"`` (the shared-memory sample tree and the window)."""
    return "one_level" if q <= sample_keys else "sampled"


def k7_route_for(keys: torch.Tensor, table: torch.Tensor,
                 tiles: Optional[dict] = None) -> str:
    """The route of a K7 call on these tensors: ``k7_route`` at the
    ``sample_keys`` that ``tiles`` (default: ``tiles_for``) gives."""
    if tiles is None:
        tiles = tiles_for("ring_lookup", keys.device, q=keys.numel(),
                          n=table.numel(), words=1)
    return k7_route(keys.numel(), tiles["sample_keys"])


def ring_lookup_cuda(keys: torch.Tensor, table: torch.Tensor,
                     route: str | None = None,
                     tiles: Optional[dict] = None) -> torch.Tensor:
    """(Q,) key words, (N,) sorted table words (uint32 bit patterns in
    int32, 1 <= N < 2^31) -> (Q,) int32 ``bisect_left % N``, on ``route``
    (default ``k7_route_for(keys, table, tiles)``): the one launcher of
    that route is called."""
    dev = _check("ring_lookup", keys, table)
    q, n = keys.numel(), table.numel()
    if keys.dim() != 1 or table.dim() != 1 or not 0 < n < 2**31:
        raise ValueError(f"ring_lookup: expects (Q,) keys and an (N,) table "
                         f"with 1 <= N < 2^31, got {tuple(keys.shape)}, "
                         f"{tuple(table.shape)}")
    route = k7_route_for(keys, table, tiles) if route is None else route
    if route not in K7_ROUTES:
        raise ValueError(f"ring_lookup: route {route!r} not in {K7_ROUTES}")
    out = torch.empty(q, dtype=torch.int32, device=dev)
    if not q:
        return out
    stream = raw_stream(dev)
    if route == "one_level":
        build.launch("ring_lookup_launch", keys.data_ptr(), table.data_ptr(),
                     out.data_ptr(), q, n, stream)
        return out
    sample = _k7_scratch.get((dev, stream))
    if sample is None:
        sample = _k7_scratch[(dev, stream)] = torch.empty(
            K7_TREE_WORDS, dtype=torch.int32, device=dev)
    build.launch("ring_lookup_sampled_launch", keys.data_ptr(),
                 table.data_ptr(), sample.data_ptr(), out.data_ptr(), q, n,
                 stream)
    return out


def ring_lookup64_cuda(keys_hi: torch.Tensor, keys_lo: torch.Tensor,
                       table_hi: torch.Tensor, table_lo: torch.Tensor,
                       n: torch.Tensor,
                       tiles: Optional[dict] = None) -> torch.Tensor:
    """(Q,) key words, (CAP,) sorted table words, (1,) n -> (Q,) int32,
    the grid capped at ``tiles["blocks_per_sm"]`` blocks an SM."""
    dev = _check("ring_lookup64", keys_hi, keys_lo, table_hi, table_lo, n)
    q = keys_hi.numel()
    if keys_lo.numel() != q or table_lo.numel() != table_hi.numel() \
            or n.numel() != 1:
        raise ValueError("ring_lookup64: mismatched word shapes")
    out = torch.empty(q, dtype=torch.int32, device=dev)
    if q:
        if tiles is None:
            tiles = tiles_for("ring_lookup", dev, q=q, n=table_hi.numel(),
                              words=2)
        build.launch("ring_lookup64_launch", keys_hi.data_ptr(),
                     keys_lo.data_ptr(), table_hi.data_ptr(),
                     table_lo.data_ptr(), n.data_ptr(), out.data_ptr(), q,
                     tiles["blocks_per_sm"], raw_stream(dev))
    return out


def ring_lookup_bucketed_cuda(keys_hi: torch.Tensor, keys_lo: torch.Tensor,
                              bkt_hi: torch.Tensor, bkt_lo: torch.Tensor,
                              occ: torch.Tensor,
                              tiles: Optional[dict] = None):
    """(Q,) key words, (B, 128) bucket rows, (B,) occupancy -> owner
    words ((Q,) hi, (Q,) lo) int32; a warp a key up to
    ``tiles["warp_keys"]`` keys, else a thread a key."""
    dev = _check("ring_lookup_bucketed", keys_hi, keys_lo, bkt_hi, bkt_lo, occ)
    q = keys_hi.numel()
    nb = bkt_hi.shape[0]
    bits = nb.bit_length() - 1
    if nb != 1 << bits:
        raise ValueError(f"bucket count {nb} is not a power of two")
    if bkt_hi.shape != (nb, 128) or bkt_lo.shape != (nb, 128) \
            or occ.shape != (nb,) or keys_lo.numel() != q:
        raise ValueError("ring_lookup_bucketed: mismatched shapes")
    if bkt_hi.data_ptr() % 16 or bkt_lo.data_ptr() % 16:   # 16-byte reads
        raise ValueError("ring_lookup_bucketed: bucket rows must be "
                         "16-byte aligned")
    out_hi, out_lo = torch.empty((2, q), dtype=torch.int32,
                                 device=dev).unbind(0)
    if q:
        if tiles is None:
            tiles = tiles_for("ring_lookup_bucketed", dev, q=q, b=nb)
        build.launch("ring_lookup_bucketed_launch", keys_hi.data_ptr(),
                     keys_lo.data_ptr(), bkt_hi.data_ptr(), bkt_lo.data_ptr(),
                     occ.data_ptr(), out_hi.data_ptr(), out_lo.data_ptr(), q,
                     bits, tiles["warp_keys"], raw_stream(dev))
    return out_hi, out_lo
