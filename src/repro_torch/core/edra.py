"""EDRA — Event Detection and Report Algorithm (paper §IV).

A copy of ``repro.core.edra``: the *pure* algorithmic pieces shared by
the routing table (``Event``), the vectorized churn plane (``core.sim``,
whose kernel K4 computes the same tree coordinates) and the analysis
(``core.analysis``):

  * the dissemination tree induced by Rules 1-8 over ring offsets,
  * per-peer acknowledge TTL / hop-depth / parent,
  * the per-interval message-emission logic (Rules 3-4) as a reusable
    ``EventBuffer`` state machine.

Tree structure
--------------
Let the *reporter* P (successor of the peer suffering the event, Rule 6)
sit at offset 0 and index every other peer by its clockwise offset i from
P.  The EDRA rules induce a binomial tree:

  * offset 0 acknowledges with TTL = rho (Rule 6);
  * offset i > 0 is reached exactly once, acknowledging with
    TTL = trailing_zeros(i)  (the lowest set bit of i);
  * its parent in the tree is offset i & (i-1) (clear lowest set bit);
  * its hop depth (number of Theta intervals after the reporter's) is
    popcount(i).

Rule 8 truncates the tree at the ring size: a peer at offset i forwards a
message with TTL = l to offset i + 2**l only if that offset is < n
(otherwise the target would wrap past the reporter and receive the event
twice).  Theorem 1 (exactly-once delivery, average ack time <= rho*Theta/2)
and Theorem 2 (|S| = 2**(rho-l)) are direct consequences.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

from .tuning import rho as _rho


# ---------------------------------------------------------------------------
# Dissemination tree (vectorized, numpy)
# ---------------------------------------------------------------------------

def ack_ttl(offsets: np.ndarray, n: int) -> np.ndarray:
    """TTL with which the peer at each ring offset acknowledges the event.

    offset 0 (the reporter) acknowledges with TTL = rho (Rule 6); offset
    i > 0 acknowledges with TTL = trailing_zeros(i) (Rules 3+7).
    """
    offsets = np.asarray(offsets, dtype=np.uint64)
    p = _rho(n)
    # trailing zeros via de Bruijn-free approach: popcount((i & -i) - 1)
    i = offsets.astype(np.int64)
    lsb = i & -i
    tz = popcount_np((lsb - 1).astype(np.uint64))
    return np.where(offsets == 0, p, tz).astype(np.int32)


def ack_depth(offsets: np.ndarray) -> np.ndarray:
    """Number of Theta-interval hops from the reporter (popcount)."""
    return popcount_np(np.asarray(offsets, dtype=np.uint64)).astype(np.int32)


def parent_offset(offsets: np.ndarray) -> np.ndarray:
    """Tree parent: clear the lowest set bit. Parent of 0 is 0."""
    i = np.asarray(offsets, dtype=np.int64)
    return (i & (i - 1)).astype(np.int64)


def popcount_np(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, dtype=np.uint64)
    c = np.zeros(x.shape, dtype=np.int64)
    while True:
        nz = x != 0
        if not nz.any():
            break
        c += (x & np.uint64(1)).astype(np.int64)
        x = x >> np.uint64(1)
    return c


def forward_targets(offset: int, ttl: int, n: int) -> List[Tuple[int, int]]:
    """(target_offset, message_ttl) pairs a peer emits for an event.

    A peer that acknowledged an event with TTL = ``ttl`` includes it in all
    messages with TTL < ttl (Rule 3); the message with TTL = l goes to
    succ(p, 2**l) (Rule 7); targets wrapping past the reporter are
    discharged (Rule 8).  Events acknowledged with TTL = 0 are not
    forwarded (Rule 3).
    """
    out = []
    for l in range(ttl - 1, -1, -1):
        tgt = offset + (1 << l)
        if tgt < n:  # Rule 8
            out.append((tgt, l))
    return out


def dissemination_tree(n: int) -> Dict[str, np.ndarray]:
    """Full tree for a ring of n peers: ttl, depth, parent per offset."""
    offs = np.arange(n, dtype=np.uint64)
    return {
        "offset": offs.astype(np.int64),
        "ttl": ack_ttl(offs, n),
        "depth": ack_depth(offs),
        "parent": parent_offset(offs),
    }


def acknowledged_exactly_once(n: int) -> bool:
    """Theorem 1 structural check: every offset reached exactly once."""
    tree = dissemination_tree(n)
    reached = np.zeros(n, dtype=np.int64)
    reached[0] = 1  # reporter
    for off, ttl in zip(tree["offset"], tree["ttl"]):
        if off == 0:
            ttl = tree["ttl"][0]
        for tgt, _l in forward_targets(int(off), int(ttl), n):
            reached[tgt] += 1
    return bool((reached == 1).all())


# ---------------------------------------------------------------------------
# Event buffering state machine (Rules 1-4, 6, 8) — used by protocol peers
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Event:
    """A membership event: a peer joined or left (paper footnote 3)."""

    subject_id: int          # ring ID of the peer that joined/left
    kind: str                # "join" | "leave"
    addr: Tuple[str, int] = ("0.0.0.0", 0)
    seq: int = 0             # tiebreaker for idempotence

    @property
    def wire_bits(self) -> int:
        """m in Eq IV.5: 32 bits for default-port peers, 48 otherwise."""
        return 32 if self.addr[1] in (0, 1117) else 48

    def dedup_key(self) -> Tuple[int, str, int]:
        return (self.subject_id, self.kind, self.seq)


@dataclass
class EventBuffer:
    """Per-peer EDRA buffer: events acknowledged during the current Theta
    interval, tagged with the TTL they were acknowledged with (Rule 2/6).

    At the end of the interval, ``flush`` emits the per-TTL message
    payloads per Rules 1-4 (message M(l) carries every event acknowledged
    with TTL > l; M(0) is always sent; M(l>0) only if non-empty).
    """

    rho: int
    acked: Dict[Tuple[int, str, int], Tuple[Event, int]] = field(default_factory=dict)

    def acknowledge(self, event: Event, ttl: int) -> bool:
        """Record an event acknowledged with ``ttl``. Returns False if the
        event was already acknowledged (duplicate suppression — under
        Theorem 1 duplicates only arise from retransmissions/stabilization).
        """
        k = event.dedup_key()
        if k in self.acked:
            return False
        self.acked[k] = (event, ttl)
        return True

    def __len__(self) -> int:
        return len(self.acked)

    def flush(self) -> Dict[int, List[Event]]:
        """Events to include per outgoing message TTL for this interval.

        Returns {l: [events]} for l in [0, rho): message M(l) carries all
        events acknowledged with TTL > l (Rule 3).  The caller applies
        Rule 8 (range discharge) because it owns the routing table, and
        Rule 4 (M(0) always sent; M(l>0) iff payload non-empty).
        """
        out: Dict[int, List[Event]] = {l: [] for l in range(self.rho)}
        for ev, ttl in self.acked.values():
            for l in range(min(ttl, self.rho)):
                out[l].append(ev)
        self.acked.clear()
        return out
