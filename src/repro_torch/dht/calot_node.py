"""1h-Calot peer for the discrete-event simulator (paper §II, §VII-A).

1h-Calot [52] differs from D1HT in exactly the three ways the paper lists:
  1. event-propagation trees based on peer-ID intervals (we build the same
     binomial split over the live table — cost-equivalent),
  2. explicit heartbeats (4/min to the successor, unacknowledged) for
     failure detection, instead of piggybacking on maintenance traffic,
  3. NO event aggregation: every maintenance message carries exactly one
     event (fixed 48-byte message, Fig. 2b) and is sent immediately —
     peers cannot buffer without sacrificing the one-hop guarantee.

Per-peer bandwidth therefore follows Eq VII.1:
    B = r*(v_c + v_a) + 4*v_h/60.
"""
from __future__ import annotations

import bisect
from typing import Optional

from ..core.edra import Event
from ..core.ring import RoutingTable
from ..core.tuning import EdraParams
from .des import SimNet, SimPeer
from .messages import V_A_BITS, V_H_BITS, calot_maintenance_size

HEARTBEAT_PERIOD = 15.0           # four per minute (§VII-A)


class CalotPeer(SimPeer):
    def __init__(self, pid: int, net: SimNet, params: EdraParams):
        super().__init__(pid, net)
        self.params = params
        self.table = RoutingTable([])
        self.seen: dict = {}
        self.last_pred_beat = 0.0
        self.probing: Optional[int] = None
        self._epoch = 0

    # -- lifecycle ---------------------------------------------------------
    def start(self, table_from: Optional["CalotPeer"] = None) -> None:
        self.alive = True
        self._epoch += 1
        if table_from is not None:
            self.table = RoutingTable(list(table_from.table.ids))
        self.table.add(self.id)
        self.last_pred_beat = self.net.now
        self._schedule_heartbeat()

    def stop(self, *, crash: bool) -> None:
        if not crash and self.alive:
            succ = self._succ_peer()
            if succ is not None:
                ev = self._make_event(self.id, "leave")
                self.net.send(self.id, succ, V_A_BITS, "leaving", ev)
        self.alive = False
        self._epoch += 1

    def _make_event(self, subject: int, kind: str) -> Event:
        self.net.event_seq += 1
        return Event(subject_id=subject, kind=kind, seq=self.net.event_seq)

    def _succ_peer(self, i: int = 1) -> Optional[int]:
        if len(self.table) <= 1:
            return None
        return self.table.succ(self.id, i)

    # -- heartbeats (failure detection) --------------------------------------
    def _schedule_heartbeat(self) -> None:
        epoch = self._epoch

        def fire() -> None:
            if not self.alive or self._epoch != epoch:
                return
            succ = self._succ_peer()
            if succ is not None:
                self.net.send(self.id, succ, V_H_BITS, "heartbeat", None,
                              acked=False)
            self._check_predecessor()
            self._schedule_heartbeat()

        self.net.schedule(HEARTBEAT_PERIOD, fire)

    def _check_predecessor(self) -> None:
        if len(self.table) <= 1:
            return
        pred = self.table.pred(self.id, 1)
        if (self.probing is None
                and self.net.now - self.last_pred_beat > 1.5 * HEARTBEAT_PERIOD):
            self.probing = pred
            self.net.send(self.id, pred, V_A_BITS, "probe", None, acked=False)
            self.net.schedule(5.0, lambda: self._probe_timeout(pred))

    def _probe_timeout(self, pred: int) -> None:
        if not self.alive or self.probing != pred or pred not in self.table:
            return
        # probe unanswered => confirmed dead
        self.probing = None
        self.table.remove(pred)
        ev = self._make_event(pred, "leave")
        self._propagate(ev, full_range=True)
        self._apply(ev)
        self.last_pred_beat = self.net.now

    # -- event dissemination: ID-interval tree, one event per message ----------
    def _count_in(self, hi_id: int) -> int:
        """Number of table entries clockwise in (self.id, hi_id]."""
        if len(self.table) <= 1:
            return 0
        try:
            last = self.table.predecessor_of((hi_id + 1) % (1 << 64))
        except LookupError:
            return 0
        if last == self.id:
            return 0
        ids = self.table.ids
        pos_me = bisect.bisect_left(ids, self.id)
        pos_last = bisect.bisect_left(ids, last)
        return (pos_last - pos_me) % len(ids)

    def _propagate(self, ev: Event, *, full_range: bool = False,
                   hi_id: Optional[int] = None) -> None:
        """Forward ``ev`` over 1h-Calot's peer-ID-interval tree (§II).

        The sender is responsible for informing every peer in the clockwise
        ID interval (self, hi_id].  It hands the far half (mid, hi_id] to
        the peer at the midpoint and keeps halving its own share.  Each
        receiver re-derives coverage from *its own* table, so the tree is
        robust to transient routing-table divergence.  One event per
        message, no aggregation (the paper's key contrast with EDRA).
        """
        if full_range:
            if len(self.table) <= 1:
                return
            hi_id = self.table.pred(self.id, 1)
        while True:
            k = self._count_in(hi_id)
            if k <= 0:
                return
            half = (k + 1) // 2
            mid = self.table.succ(self.id, half)
            if mid == self.id:
                return
            if not self.net.is_alive(mid):
                # ack timeout: one wasted transmission, learn, re-route so
                # the subtree is not silently lost (messages acked, Eq VII.1)
                self.net.send(self.id, mid, calot_maintenance_size(),
                              "event", (ev, mid))
                self.table.remove(mid)
                continue
            self.net.send(self.id, mid, calot_maintenance_size(),
                          "event", (ev, hi_id))
            if half == 1:
                return                       # near half is empty
            hi_id = self.table.pred(mid, 1)  # keep (self, pred(mid)]

    def _apply(self, ev: Event) -> None:
        k = ev.dedup_key()
        if k in self.seen:
            return
        self.seen[k] = self.net.now
        if ev.kind == "join":
            self.table.add(ev.subject_id)
        else:
            self.table.remove(ev.subject_id)

    # -- datagrams -------------------------------------------------------------
    def on_datagram(self, src: int, kind: str, payload) -> None:
        if kind == "heartbeat":
            try:
                if len(self.table) > 1:
                    pred = self.table.pred(self.id, 1)
                    if src == pred:
                        self.last_pred_beat = self.net.now
                        self.probing = None
                    elif self.probing is None:
                        # heartbeat from a non-predecessor: the ring changed
                        # nearby — verify pred(1) instead of trusting it
                        self.probing = pred
                        self.net.send(self.id, pred, V_A_BITS, "probe", None,
                                      acked=False)
                        self.net.schedule(5.0,
                                          lambda: self._probe_timeout(pred))
            except LookupError:
                pass
        elif kind == "probe":
            self.net.send(self.id, src, V_A_BITS, "probe-reply", None,
                          acked=False)
        elif kind == "probe-reply":
            if self.probing == src:
                self.probing = None
                self.last_pred_beat = self.net.now
        elif kind == "event":
            ev, hi_id = payload
            first_time = ev.dedup_key() not in self.seen
            self._apply(ev)
            if first_time and hi_id != self.id:
                self._propagate(ev, hi_id=hi_id)
        elif kind == "leaving":
            ev = payload
            if ev.dedup_key() not in self.seen:
                self._propagate(ev, full_range=True)
                self._apply(ev)
        elif kind == "join-request":
            newcomer = self.net.peers.get(src)
            if newcomer is not None and isinstance(newcomer, CalotPeer):
                newcomer.start(table_from=self)
                self.table.add(src)
                ev = self._make_event(src, "join")
                self._propagate(ev, full_range=True)
                self._apply(ev)
