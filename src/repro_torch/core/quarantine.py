"""Quarantine mechanism (paper §V).

A joining peer is not immediately inserted into the ring: the peers it
contacted (the set S) wait for a Quarantine period T_q before transferring
keys + routing table.  While quarantined, the peer forwards lookups to
*gateway* peers chosen from S (nearest / best provisioned), paying one
extra (nearby) hop.  Volatile peers — sessions shorter than T_q — never
generate join/leave events, cutting maintenance traffic by the volatile
fraction (24% KAD / 31% Gnutella at T_q = 10 min, §VIII).

In the ML runtime this is the admission policy for preemptible/spot
nodes: a node is not handed shards / DP ranks / expert replicas until it
survives T_q (see repro_torch.runtime.membership).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

DEFAULT_T_Q = 600.0  # 10 minutes — the paper's "convenient value"

# Fractions of sessions shorter than 10 min, from the studies cited in
# §VIII: 31% of Gnutella sessions [12], 24% of KAD sessions [50].
VOLATILE_FRACTION = {"kad": 0.24, "gnutella": 0.31}


@dataclass
class QuarantineEntry:
    peer_id: int
    addr: Tuple[str, int]
    joined_at: float
    gateways: List[int] = field(default_factory=list)


@dataclass
class QuarantineManager:
    """Tracks quarantined peers and admission decisions.

    ``t_q`` may be fixed or adapted: the paper suggests raising T_q when
    the observed event rate exceeds what the system comfortably handles
    (flash-crowd damping) — implemented by ``on_event_rate``.
    """

    t_q: float = DEFAULT_T_Q
    max_event_rate: Optional[float] = None  # events/s that triggers damping
    damping: float = 2.0                    # T_q multiplier under overload
    base_t_q: float = field(init=False)
    pending: Dict[int, QuarantineEntry] = field(default_factory=dict)
    admitted: int = 0
    rejected_volatile: int = 0

    def __post_init__(self) -> None:
        self.base_t_q = self.t_q

    def enqueue(self, peer_id: int, addr: Tuple[str, int], now: float,
                gateways: List[int]) -> QuarantineEntry:
        e = QuarantineEntry(peer_id, addr, now, list(gateways))
        self.pending[peer_id] = e
        return e

    def withdraw(self, peer_id: int) -> bool:
        """Peer left before T_q elapsed: no event was ever reported."""
        if peer_id in self.pending:
            del self.pending[peer_id]
            self.rejected_volatile += 1
            return True
        return False

    def due(self, now: float) -> List[QuarantineEntry]:
        """Peers whose quarantine has elapsed; they join the ring now
        (their join event is reported from this moment, §V)."""
        out = [e for e in self.pending.values() if now - e.joined_at >= self.t_q]
        for e in out:
            del self.pending[e.peer_id]
            self.admitted += 1
        return out

    def gateway_for(self, peer_id: int) -> Optional[int]:
        e = self.pending.get(peer_id)
        return e.gateways[0] if e and e.gateways else None

    def on_event_rate(self, observed_rate: float) -> None:
        """Flash-crowd damping (§V last paragraph)."""
        if self.max_event_rate is None:
            return
        if observed_rate > self.max_event_rate:
            self.t_q = self.base_t_q * self.damping
        else:
            self.t_q = self.base_t_q


def survival_fraction_heavy_tailed(t_q: float, s_avg: float,
                                   shape: float = 1.5) -> float:
    """Fraction of sessions outliving T_q under a Pareto(shape) session
    distribution with mean s_avg (P2P session lengths are heavy-tailed,
    §V [12][49][50]).  Used when no measured volatile fraction is given.
    """
    if shape <= 1.0:
        raise ValueError("Pareto shape must exceed 1 for a finite mean")
    x_m = s_avg * (shape - 1.0) / shape
    if t_q <= x_m:
        return 1.0
    return (x_m / t_q) ** shape
