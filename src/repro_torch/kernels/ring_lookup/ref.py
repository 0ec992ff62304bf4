"""Plain PyTorch versions of the ring lookups (K1, K2, K7).

successor index of key k in a sorted ring table = bisect_left(table, k)
mod n (the first peer clockwise from the key; wraps to index 0 past the
last peer).  Ids travel as int32 tensors carrying uint32 (hi, lo) words;
these versions widen each word to int64 with ``& 0xFFFFFFFF`` before
they compare, shift or combine it.
"""
from __future__ import annotations

import torch

BW = 128                 # bucket row width (= RingState._BUCKET_ROW)
_M32 = 0xFFFFFFFF


def _u32(words: torch.Tensor) -> torch.Tensor:
    return words.to(torch.int64) & _M32


def sortable_ids(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """(hi, lo) uint32 words -> int64 whose SIGNED order is the uint64
    order of the ids: flip the top bit, then two's-complement wrap."""
    return ((_u32(hi) ^ 0x80000000) << 32) | _u32(lo)


def ring_lookup_ref(keys: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """(Q,) key words, (N,) sorted table words, both uint32 bit patterns
    in int32 tensors -> (Q,) int32 ``bisect_left(table, key) % N``.  A
    table sorted as signed int32 is not a supported input."""
    count = torch.searchsorted(_u32(table), _u32(keys), side="left")
    return (count % table.shape[0]).to(torch.int32)


def ring_lookup64_ref(keys_hi: torch.Tensor, keys_lo: torch.Tensor,
                      table_hi: torch.Tensor, table_lo: torch.Tensor,
                      n: torch.Tensor) -> torch.Tensor:
    """(Q,) key words, (CAP,) table words sorted in the first n slots,
    (1,) int32 n -> (Q,) int32 successor indices into the live entries.
    A bisect over the table with its padding lifted to INT64_MAX, so n
    is never read on the host."""
    cap = table_hi.shape[0]
    live = torch.arange(cap, device=table_hi.device) < n[0]
    table = torch.where(live, sortable_ids(table_hi, table_lo),
                        torch.iinfo(torch.int64).max)
    count = torch.searchsorted(table, sortable_ids(keys_hi, keys_lo),
                               side="left")
    return (count % n[0]).to(torch.int32)


def ring_lookup_bucketed_ref(keys_hi: torch.Tensor, keys_lo: torch.Tensor,
                             bkt_hi: torch.Tensor, bkt_lo: torch.Tensor,
                             occ: torch.Tensor):
    """Row b of the (B, BW) bucket table holds the sorted active ids with
    top bits b in its first occ[b] slots and the bucket's successor id
    after them, so ``row[count_of_smaller]`` IS the owner.  Returns
    ((Q,) hi, (Q,) lo) int32 owner words."""
    nb, bw = bkt_hi.shape
    r = nb.bit_length() - 1
    qhi, qlo = _u32(keys_hi), _u32(keys_lo)
    b = qhi >> (32 - r) if r else torch.zeros_like(qhi)
    rhi_w, rlo_w = bkt_hi[b], bkt_lo[b]                  # (Q, BW)
    rhi, rlo = _u32(rhi_w), _u32(rlo_w)
    j = torch.arange(bw, device=bkt_hi.device)[None, :]
    lt = (rhi < qhi[:, None]) | ((rhi == qhi[:, None]) & (rlo < qlo[:, None]))
    cnt = (lt & (j < occ[b][:, None])).sum(dim=1).clamp(max=bw - 1)
    ohi = torch.gather(rhi_w, 1, cnt[:, None])[:, 0]
    olo = torch.gather(rlo_w, 1, cnt[:, None])[:, 0]
    return ohi, olo
