"""Placement policies of the port (DESIGN.md §13): the ranking a key's
replica-set candidates go through.

A policy receives the ring's ``ReplicaView`` (the r-way successor list
plus candidate metadata) and returns a RANKING of the candidates: a
permutation of the view's ids, never a different set, computed as a pure
function of its inputs so two nodes with the same routing table agree
with zero coordination.  ``RingSuccessor`` ranks in ring order;
``LatencyAware`` ranks by the RTT a ``Topology`` estimates from the
request's origin, with an affinity hysteresis for the current holder.
(``repro``'s ``Placement`` comes with the ``dht_cluster`` slice.)
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.ringstate import ReplicaView, RingState


# ---------------------------------------------------------------------------
# Topology: per-node region placement + RTT estimation
# ---------------------------------------------------------------------------

_MIX = np.uint64(0x9E3779B97F4A7C15)    # splitmix64 odd constant


class Topology:
    """Where each ring node physically sits, and what talking to it
    costs.

    Regions live on an abstract 2-D "millisecond plane": the Euclidean
    distance between two regions' coordinates IS the estimated one-way
    inter-region delay in ms (PlanetLab-flavored: tens of ms between
    datacenters).  Within a region the one-way floor is
    ``intra_rtt_ms / 2`` — the LanDelay regime.

    Nodes are mapped to regions either explicitly (``place``) or, by
    default, via a deterministic splitmix64 hash of the node id — so a
    million-peer ring gets a uniform region mix with zero per-node
    state, and every host derives the SAME map from its routing table
    (the policy-determinism requirement).

    The estimator is deterministic (no jitter): it ranks placements.
    The stochastic twin — actual per-datagram delays — is
    ``repro_torch.dht.des.GeoDelay``, which samples around the same per-pair
    medians, so what the policy optimizes is what the DES measures.
    """

    def __init__(self, regions: Dict[str, Tuple[float, float]], *,
                 intra_rtt_ms: float = 0.2):
        if not regions:
            raise ValueError("topology needs at least one region")
        self.intra_rtt_ms = float(intra_rtt_ms)
        self.names: List[str] = list(regions)
        self._index = {nm: i for i, nm in enumerate(self.names)}
        coords = np.asarray([regions[nm] for nm in self.names], np.float64)
        d = coords[:, None, :] - coords[None, :, :]
        self._oneway_ms = np.sqrt((d * d).sum(-1))
        np.fill_diagonal(self._oneway_ms, self.intra_rtt_ms / 2.0)
        self._pinned: Dict[int, int] = {}
        # sorted pinned-id arrays, rebuilt lazily for vectorized overrides
        self._pin_keys: Optional[np.ndarray] = None
        self._pin_vals: Optional[np.ndarray] = None

    # -- construction helpers -------------------------------------------------
    @classmethod
    def single_region(cls, name: str = "dc0", *,
                      intra_rtt_ms: float = 0.14) -> "Topology":
        """One datacenter — the LAN environment (§VII-C/D: 0.14 ms RTT).
        Every pair is intra-region, so LatencyAware degenerates to ring
        order and the LAN leg of the tradeoff curve is the null test."""
        return cls({name: (0.0, 0.0)}, intra_rtt_ms=intra_rtt_ms)

    @classmethod
    def multi_dc(cls, k: int = 4, *, intra_rtt_ms: float = 0.2) -> "Topology":
        """PlanetLab-flavored WAN: up to 6 named DCs whose pairwise
        one-way delays span ~18–95 ms (the §VII-B regime the WanDelay
        lognormal models in aggregate)."""
        catalog: List[Tuple[str, Tuple[float, float]]] = [
            ("us-east", (0.0, 0.0)),
            ("us-west", (35.0, 0.0)),
            ("eu-west", (45.0, 38.0)),
            ("ap-south", (95.0, 20.0)),
            ("sa-east", (60.0, -55.0)),
            ("ap-north", (80.0, 55.0)),
        ]
        if not 1 <= k <= len(catalog):
            raise ValueError(f"k must be in [1, {len(catalog)}]")
        return cls(dict(catalog[:k]), intra_rtt_ms=intra_rtt_ms)

    # -- node -> region -------------------------------------------------------
    def place(self, node: int, region: str) -> None:
        """Pin a node to a region (overrides the hash assignment)."""
        self._pinned[int(node)] = self._index[region]
        self._pin_keys = self._pin_vals = None

    def region_index(self, ids) -> np.ndarray:
        """(Q,) node ids -> (Q,) region indices: splitmix64-hashed onto
        the region list, with pinned overrides applied vectorized."""
        ids = np.atleast_1d(np.asarray(ids, np.uint64))
        z = ids * _MIX                     # uint64 wraparound is the mix
        z = z ^ (z >> np.uint64(31))
        out = (z % np.uint64(len(self.names))).astype(np.int64)
        if self._pinned:
            if self._pin_keys is None:
                pk = np.fromiter(self._pinned, np.uint64, len(self._pinned))
                order = np.argsort(pk)
                self._pin_keys = pk[order]
                self._pin_vals = np.fromiter(
                    self._pinned.values(), np.int64, len(self._pinned))[order]
            pos = np.searchsorted(self._pin_keys, ids)
            pos = np.minimum(pos, self._pin_keys.size - 1)
            hit = self._pin_keys[pos] == ids
            out[hit] = self._pin_vals[pos[hit]]
        return out

    def region_of(self, node: int) -> str:
        return self.names[int(self.region_index(node)[0])]

    def _origin_index(self, origin) -> int:
        """Region index of an origin given as a region name or node id."""
        if isinstance(origin, str):
            return self._index[origin]
        return int(self.region_index(origin)[0])

    # -- RTT estimation -------------------------------------------------------
    def one_way_ms(self, a, b) -> float:
        return float(self._oneway_ms[self._origin_index(a),
                                     self._origin_index(b)])

    def rtt_ms(self, a, b) -> float:
        return 2.0 * self.one_way_ms(a, b)

    def rtt_ms_many(self, origin, ids) -> np.ndarray:
        """(Q,) node ids -> (Q,) estimated RTT ms from ``origin`` (a node
        id or a region name) — the vectorized ranking input."""
        oi = self._origin_index(origin)
        return 2.0 * self._oneway_ms[oi, self.region_index(ids)]



class PlacementPolicy(ABC):
    """Ranks a key's replica-set candidates for one placement decision.

    ``origin`` is where the request physically comes from (None = no
    locality information); ``prefer`` is the candidate currently holding
    the state, if any.
    """

    name: str = "abstract"
    topology: Optional[Topology] = None

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

    def __init__(self, topology: Optional[Topology] = None):
        # ranking never consults it; with one attached the serve plane
        # meters cross-region placements for the baseline
        self.topology = topology

    def rank(self, view: ReplicaView, *, origin=None,
             prefer: Optional[int] = None) -> List[int]:
        return list(view.ids)


class LatencyAware(PlacementPolicy):
    """Prefer low-RTT members of the replica set (locality/proximity-
    aware placement in the survey's taxonomy — the replica SET is fixed
    by the ring; the policy picks *which member* serves, stores first,
    or proxies).

    Ties — and everything within ``tie_ms`` of the best RTT — break by
    ring rank, so intra-region choices stay deterministic and LAN
    topologies degenerate to exact ``RingSuccessor`` behavior.

    Affinity: when ``prefer`` (the current holder) is in the candidate
    set, its effective RTT is discounted by ``affinity_ms`` — a session
    placed on a nearby node is not bounced to a marginally-nearer one by
    every churn batch.  Affinity *survives* churn structurally: the
    serve plane re-ranks only ``owner_diff``-affected sessions, and an
    unaffected session's view (hence its ranking) is unchanged.
    """

    name = "latency_aware"

    def __init__(self, topology: Topology, *, affinity_ms: float = 5.0,
                 tie_ms: float = 0.5):
        self.topology = topology
        self.affinity_ms = float(affinity_ms)
        self.tie_ms = float(tie_ms)

    def _order(self, ids: np.ndarray, rtt: np.ndarray) -> List[int]:
        # quantize to tie_ms buckets so near-equal RTTs fall back to
        # ring order (stable lexsort on the original index)
        q = np.floor(rtt / max(self.tie_ms, 1e-9)).astype(np.int64)
        order = np.lexsort((np.arange(ids.size), q))
        return [int(ids[i]) for i in order]

    def rank(self, view: ReplicaView, *, origin=None,
             prefer: Optional[int] = None) -> List[int]:
        if origin is None or len(view.ids) <= 1:
            return list(view.ids)
        ids = np.fromiter(view.ids, np.uint64, len(view.ids))
        rtt = self.topology.rtt_ms_many(origin, ids)
        if prefer is not None:
            held = ids == np.uint64(prefer)
            if held.any():
                rtt = np.where(held, np.maximum(rtt - self.affinity_ms, 0.0),
                               rtt)
        return self._order(ids, rtt)

    def gateways(self, state: RingState, k: int, *, origin=None) -> List[int]:
        act = state.active_ids()
        if origin is None or act.size <= k:
            return [int(x) for x in act[:k]]
        rtt = self.topology.rtt_ms_many(origin, act)
        return self._order(act, rtt)[:k]
