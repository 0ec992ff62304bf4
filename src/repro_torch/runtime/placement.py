"""Placement policies of the port (DESIGN.md §13): the ranking a key's
replica-set candidates go through.

A policy receives the ring's ``ReplicaView`` (the r-way successor list
plus candidate metadata) and returns a RANKING of the candidates: a
permutation of the view's ids, never a different set, computed as a pure
function of its inputs so two nodes with the same routing table agree
with zero coordination.  ``RingSuccessor`` ranks in ring order.  (The
latency-aware policy and its ``Topology`` come with a later slice.)
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from typing import List, Optional

from ..core.ringstate import ReplicaView, RingState


class PlacementPolicy(ABC):
    """Ranks a key's replica-set candidates for one placement decision.

    ``origin`` is where the request physically comes from (None = no
    locality information); ``prefer`` is the candidate currently holding
    the state, if any.
    """

    name: str = "abstract"

    @abstractmethod
    def rank(self, view: ReplicaView, *, origin=None,
             prefer: Optional[int] = None) -> List[int]:
        """Permutation of ``view.ids`` in descending placement priority."""

    def replica_group(self, state: RingState, key, r: int, *, origin=None,
                      prefer: Optional[int] = None) -> List[int]:
        """Ranked r-way replica group for ``key``."""
        return self.rank(state.replica_view(key, r), origin=origin,
                         prefer=prefer)

    def gateways(self, state: RingState, k: int, *, origin=None) -> List[int]:
        """§V quarantine gateways for a joining peer: the k active peers
        that proxy its lookups while it sits out T_q.  Base policy: the
        first k of the active view."""
        return [int(x) for x in state.active_ids()[:k]]


class RingSuccessor(PlacementPolicy):
    """Ring-successor order: the owner first, then its successors."""

    name = "ring_successor"

    def rank(self, view: ReplicaView, *, origin=None,
             prefer: Optional[int] = None) -> List[int]:
        return list(view.ids)
