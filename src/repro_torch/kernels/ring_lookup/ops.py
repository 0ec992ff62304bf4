"""Public ring-lookup wrappers: CPU tensors take the plain versions, CUDA
tensors launch the CUDA kernels (or raise).  ``<wrapper>.launches``
counts kernel launches, so a run can show its main path went through
the kernels."""
from __future__ import annotations

import torch

from .kernel import (k7_route_for, ring_lookup64_cuda,
                     ring_lookup_bucketed_cuda, ring_lookup_cuda)
from .ref import ring_lookup64_ref, ring_lookup_bucketed_ref, ring_lookup_ref


def ring_lookup(keys: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Single-word successor lookup (K7): (Q,) keys and a sorted (N,)
    table, uint32 bit patterns in int32 tensors, -> (Q,) int32
    ``bisect_left(table, key) % N``.  Raises ``LookupError`` on an empty
    table before any device work.  A signed int32 table is not a
    supported input: the words are compared as uint32.
    ``ring_lookup.one_level_launches`` / ``.sampled_launches`` count the
    launches of each route: ``kernel.k7_route_for`` picks it here, and the
    launcher is handed it."""
    if table.numel() == 0:
        raise LookupError("empty routing table")
    if keys.device.type == "cpu":
        return ring_lookup_ref(keys, table)
    route = k7_route_for(keys, table)
    out = ring_lookup_cuda(keys, table, route)
    if out.numel():
        ring_lookup.launches += 1
        if route == "sampled":
            ring_lookup.sampled_launches += 1
        else:
            ring_lookup.one_level_launches += 1
    return out


def ring_lookup64(keys_hi: torch.Tensor, keys_lo: torch.Tensor,
                  table_hi: torch.Tensor, table_lo: torch.Tensor,
                  n: torch.Tensor) -> torch.Tensor:
    """Full 64-bit successor lookup on a capacity-padded hi/lo table
    (K1): (Q,) int32 successor indices into the ``n`` live entries."""
    if keys_hi.device.type == "cpu":
        return ring_lookup64_ref(keys_hi, keys_lo, table_hi, table_lo, n)
    out = ring_lookup64_cuda(keys_hi, keys_lo, table_hi, table_lo, n)
    if out.numel():
        ring_lookup64.launches += 1
    return out


def ring_lookup_bucketed(keys_hi: torch.Tensor, keys_lo: torch.Tensor,
                         bkt_hi: torch.Tensor, bkt_lo: torch.Tensor,
                         occ: torch.Tensor):
    """Two-level successor lookup (K2): O(bucket row) work per key;
    returns the owner id words ((Q,) hi, (Q,) lo)."""
    if keys_hi.device.type == "cpu":
        return ring_lookup_bucketed_ref(keys_hi, keys_lo, bkt_hi, bkt_lo, occ)
    out = ring_lookup_bucketed_cuda(keys_hi, keys_lo, bkt_hi, bkt_lo, occ)
    if out[0].numel():
        ring_lookup_bucketed.launches += 1
    return out


ring_lookup.launches = 0
ring_lookup.one_level_launches = 0
ring_lookup.sampled_launches = 0
ring_lookup64.launches = 0
ring_lookup_bucketed.launches = 0
