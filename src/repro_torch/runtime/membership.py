"""Cluster membership on the D1HT ring (the paper's technique as the ML
control plane).

Each training/serving host is a D1HT peer; membership events (node joins,
failures, preemptions) disseminate via EDRA with the paper's Theta tuning,
so every host can make placement decisions from its OWN full routing
table with bounded staleness (< f of lookups see a stale view) and zero
central directory — the property the paper proves scales past directory
servers (§VII-D).

Quarantine (paper §V) doubles as the spot/preemptible admission policy:
a node gets no shards, DP rank, or expert replicas until it has survived
T_q — exactly the paper's defense against volatile peers, repurposed.

This module is deterministic and host-local (events are injected by the
surrounding orchestration or by tests).  It is the port's copy of
``repro.runtime.membership``: the shared ``RingState`` and ``RoutingTable``
are the port's, and ``device=`` says where the ring's device tables live
(None = the CUDA card).
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from ..core.edra import Event
from ..core.quarantine import QuarantineManager
from ..core.ring import RoutingTable, peer_id
from ..core.ringstate import RingState
from ..core.tuning import EdraParams

from .placement import PlacementPolicy, RingSuccessor


@dataclass
class NodeInfo:
    node_id: int
    addr: Tuple[str, int]
    joined_at: float
    capabilities: Dict[str, float] = field(default_factory=dict)


class Membership:
    """Full-routing-table membership view with quarantine admission."""

    #: sliding event-rate window (seconds) and retained-sample bound for
    #: the §IV-D retune — see ``_retune``
    RATE_HORIZON = 300.0
    RATE_MAX_SAMPLES = 4096

    def __init__(self, *, s_avg: float = 3600.0, f: float = 0.01,
                 t_q: float = 600.0, now: Callable[[], float] = time.monotonic,
                 policy: Optional[PlacementPolicy] = None, device=None):
        self.now = now
        # placement policy for §V gateway selection (default: ring-
        # successor order, the first two active peers)
        self.policy = policy if policy is not None else RingSuccessor()
        self._event_times: deque = deque(maxlen=self.RATE_MAX_SAMPLES)
        # ONE RingState backs the facade table, the placement layer, and
        # the serving router's device-resident lookup table (DESIGN.md §4).
        self.ring_state = RingState(device=device)
        self.table = RoutingTable(state=self.ring_state)
        self.nodes: Dict[int, NodeInfo] = {}
        self.quarantine = QuarantineManager(t_q=t_q)
        self.params = EdraParams.derive(2, s_avg, f)
        self._listeners: List[Callable[[Event], None]] = []
        self._events_seen = 0

    # -- event intake (from the D1HT peer / DES / orchestrator) -------------
    def on_event(self, ev: Event) -> None:
        self._events_seen += 1
        self._event_times.append(self.now())
        if ev.kind == "join":
            self.table.add(ev.subject_id)
            self.nodes.setdefault(
                ev.subject_id,
                NodeInfo(ev.subject_id, ev.addr, self.now()))
        else:
            self.table.remove(ev.subject_id)
            self.nodes.pop(ev.subject_id, None)
        self._retune()
        for fn in self._listeners:
            fn(ev)

    def subscribe(self, fn: Callable[[Event], None]) -> None:
        self._listeners.append(fn)

    def _retune(self) -> None:
        """§IV-D self-organization: re-derive Theta from the locally
        observed event rate — no coordination required.

        The rate is estimated over a SLIDING window (the last
        ``RATE_HORIZON`` seconds of event timestamps, bounded by
        ``RATE_MAX_SAMPLES``), not over the view's whole lifetime: a
        lifetime-anchored window decays toward 0 on a long-lived view,
        so a churn burst after a quiet day barely moved Theta — the
        opposite of what §IV-D needs (the estimate must track the
        CURRENT rate so Theta shrinks when churn spikes).  The span of
        the retained samples is clamped below by 1 s (a same-instant
        burst still yields a finite, aggressive rate) and above by the
        horizon; samples older than the horizon are dropped."""
        now = self.now()
        while self._event_times and now - self._event_times[0] > self.RATE_HORIZON:
            self._event_times.popleft()
        if not self._event_times:
            return
        n = max(len(self.table), 2)
        span = now - self._event_times[0]
        window = min(max(span, 1.0), self.RATE_HORIZON)
        r = len(self._event_times) / window
        if r > 0:
            self.params = self.params.retune(n, r)

    # -- joins with quarantine ------------------------------------------------
    def request_join(self, host: str, port: int,
                     preemptible: bool = False) -> int:
        nid = peer_id(host, port)
        if preemptible:
            # policy-ranked gateway pick (§V)
            gateways = self.policy.gateways(self.ring_state, 2, origin=nid)
            # (re-)enqueue: a node restarting before T_q elapsed serves a
            # FRESH quarantine from now (§V — the old incarnation's
            # progress toward admission died with it)
            self.quarantine.enqueue(nid, (host, port), self.now(), gateways)
            if nid in self.table:
                # an ACTIVE member restarting as a spot instance: re-mask
                # through quarantine_member so listeners migrate its
                # owned state (a bare flag flip would orphan it)
                self.quarantine_member(nid)
            elif not self.ring_state.is_quarantined(nid):
                # tracked in the shared state but masked out of ownership
                # until T_q elapses (paper §V): gateways proxy its lookups.
                self.ring_state.add(nid, quarantined=True)
            # else: restart while already quarantine-masked — the tracked
            # masked slot is reused as-is; re-adding would rely on
            # RingState.add treating a same-flag duplicate as a no-op,
            # and any drift there would corrupt the sorted table.
        else:
            self.admit(nid, (host, port))
        return nid

    def admit(self, nid: int, addr: Tuple[str, int]) -> None:
        self.on_event(Event(subject_id=nid, kind="join", addr=addr,
                            seq=self._events_seen + 1))

    def poll_quarantine(self) -> List[int]:
        admitted = []
        for entry in self.quarantine.due(self.now()):
            self.admit(entry.peer_id, entry.addr)
            admitted.append(entry.peer_id)
        return admitted

    def fail(self, nid: int) -> None:
        """Rule-5 style failure: detected by heartbeat silence."""
        if self.quarantine.withdraw(nid) and nid not in self.nodes:
            # volatile peer: never admitted, no event was ever reported,
            # so none is reported now — just drop its masked entry
            self.ring_state.remove(nid)
            return
        # an active member, OR a member re-masked under quarantine — its
        # original join WAS disseminated, so its death must be too (the
        # facade's membership check sees only the active view)
        if nid in self.table or self.ring_state.is_quarantined(nid):
            self.on_event(Event(subject_id=nid, kind="leave",
                                seq=self._events_seen + 1))

    def quarantine_member(self, nid: int) -> bool:
        """Move an ACTIVE member back under the §V mask (straggler /
        flash-crowd damping): it stops owning keys and sessions but stays
        tracked and may keep proxying lookups as a gateway.  No EDRA
        leave event is disseminated — the node did not leave — but local
        listeners (the serve plane) are told so owned state migrates."""
        if not self.ring_state.set_quarantined(nid, True):
            return False
        for fn in self._listeners:
            fn(Event(subject_id=nid, kind="quarantine",
                     seq=self._events_seen + 1))
        return True

    # -- views ---------------------------------------------------------------------
    def size(self) -> int:
        return len(self.table)

    def members(self) -> List[int]:
        return list(self.table.ids)

    def owner_of(self, key: bytes | str) -> int:
        return self.table.owner(key)
