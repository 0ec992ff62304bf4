"""D1HT peer for the discrete-event simulator (paper §IV, §VI).

Implements the full EDRA state machine:
  * Rules 1-8 message emission at (asynchronous) Theta-interval boundaries,
  * Rule 5 predecessor monitoring (missed TTL-0 -> probe -> leave event),
  * Rule 6 detection acknowledgment with TTL = rho,
  * Rule 8 range discharge via ID-interval tests on the local table,
  * Eq IV.4 early interval close when the buffer exceeds E events,
  * the §VI joining protocol (table from successor, join announced by
    EDRA, successor streams events to the newcomer),
  * voluntary leave = flush-then-notify; crash = buffer lost (§IV-C),
  * routing-table learning from received messages (§IV-C),
  * optional Quarantine admission (§V).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

from ..core.edra import Event, EventBuffer
from ..core.ring import RoutingTable, in_interval
from ..core.tuning import EdraParams
from .des import SimNet, SimPeer
from .messages import V_A_BITS, d1ht_maintenance_size


class D1HTPeer(SimPeer):
    def __init__(self, pid: int, net: SimNet, params: EdraParams,
                 *, adaptive_theta: bool = False):
        super().__init__(pid, net)
        self.params = params
        self.theta = params.theta
        self.rho = params.rho
        self.table = RoutingTable([])
        self.buffer = EventBuffer(self.rho)
        self.seen: Dict[Tuple[int, str, int], float] = {}
        self.last_pred_msg = 0.0
        self.probing: Optional[int] = None
        self.probe_sent_at = 0.0
        self.adaptive_theta = adaptive_theta
        self._events_observed = 0
        self._epoch = 0          # invalidates timers of dead incarnations
        self._interval_open = 0.0

    # -- lifecycle -------------------------------------------------------------
    def start(self, table_from: Optional["D1HTPeer"] = None) -> None:
        self.alive = True
        self._epoch += 1
        self.buffer = EventBuffer(self.rho)
        if table_from is not None:
            # §VI: the new peer gets the routing table from its successor.
            # Transfer traffic is NOT maintenance traffic (§VII-A).
            self.table = RoutingTable(list(table_from.table.ids))
        self.table.add(self.id)
        self.last_pred_msg = self.net.now
        self._schedule_interval()

    def stop(self, *, crash: bool) -> None:
        if not self.alive:
            return
        if not crash:
            # voluntary leave: flush buffered events, then tell the successor
            self._flush_interval()
            succ = self._succ_peer()
            if succ is not None and succ != self.id:
                ev = self._make_event(self.id, "leave")
                self.net.send(self.id, succ, V_A_BITS, "leaving", ev)
        self.alive = False
        self._epoch += 1

    # -- helpers ----------------------------------------------------------------
    def _make_event(self, subject: int, kind: str) -> Event:
        self.net.event_seq += 1
        return Event(subject_id=subject, kind=kind, seq=self.net.event_seq)

    def _succ_peer(self, i: int = 1) -> Optional[int]:
        if len(self.table) <= 1:
            return None
        return self.table.succ(self.id, i)

    def _pred_peer(self) -> Optional[int]:
        if len(self.table) <= 1:
            return None
        return self.table.pred(self.id, 1)

    def _n_estimate(self) -> int:
        return max(2, len(self.table))

    def _max_buffered(self) -> float:
        # Eq IV.4: E = 8 f n / (16 + 3 rho)
        n = self._n_estimate()
        return 8.0 * self.params.f * n / (16.0 + 3.0 * self.rho)

    # -- Theta intervals ----------------------------------------------------------
    def _schedule_interval(self) -> None:
        epoch = self._epoch
        self._interval_open = self.net.now

        def fire() -> None:
            if self.alive and self._epoch == epoch:
                self._end_interval()

        self.net.schedule(self.theta, fire)

    def _end_interval(self) -> None:
        self._flush_interval()
        self._check_predecessor()
        if self.adaptive_theta:
            self._retune()
        self._schedule_interval()

    def _early_close_check(self) -> None:
        """Eq IV.4 robustness: close the interval early under event bursts."""
        if len(self.buffer) >= max(2.0, math.ceil(self._max_buffered())):
            self._epoch += 1     # cancel the pending timer
            self._end_interval()

    def _flush_interval(self) -> None:
        per_ttl = self.buffer.flush()
        for l in range(self.rho):
            events = per_ttl.get(l, [])
            if 2 ** l >= len(self.table):
                continue  # target would wrap past the reporter (Rule 8)
            target = self._succ_peer(2 ** l)
            if target is None or target == self.id:
                continue
            # Rule 8: discharge events whose subject lies in stretch(p, 2^l)
            events = [e for e in events
                      if not in_interval(e.subject_id, self.id, target)]
            if l == 0 or events:   # Rule 4: M(0) always goes out, even empty
                self._send_maint(l, target, events)

    def _send_maint(self, l: int, target: int, events: List[Event]) -> None:
        """Reliable maintenance send: unacked datagrams are retransmitted;
        after the retransmit cycle times out the sender *learns* the target
        left (§IV-C routing-failure learning — no leave event is generated,
        that is the successor's job per Rule 5) and re-routes to the next
        live successor so the dissemination chain never silently breaks."""
        for _ in range(4):
            if target is None or target == self.id:
                return
            bits = d1ht_maintenance_size(events)
            if self.net.is_alive(target):
                self.net.send(self.id, target, bits, "maint", (l, events))
                return
            # ack timeout: one wasted transmission, then local learning
            self.net.send(self.id, target, bits, "maint", (l, events))
            self.table.remove(target)
            if 2 ** l >= len(self.table):
                return
            target = self._succ_peer(2 ** l)
            events = [e for e in events
                      if not in_interval(e.subject_id, self.id, target)]

    def _retune(self) -> None:
        """§IV-D self-tuning: re-derive Theta from locally observed r, n."""
        window = max(self.net.now - 1.0, 1.0)
        observed_r = self._events_observed / window if window > 0 else 0.0
        if observed_r > 0:
            p = self.params.retune(self._n_estimate(), observed_r)
            self.theta = max(0.25, p.theta)

    # -- event intake ---------------------------------------------------------------
    def _acknowledge(self, ev: Event, ttl: int) -> None:
        k = ev.dedup_key()
        if k in self.seen:
            return
        self.seen[k] = self.net.now
        self._events_observed += 1
        if ev.kind == "join":
            self.table.add(ev.subject_id)
        else:
            self.table.remove(ev.subject_id)
        self.buffer.acknowledge(ev, ttl)
        self._early_close_check()

    # -- datagram handling -------------------------------------------------------------
    def on_datagram(self, src: int, kind: str, payload) -> None:
        if kind == "maint":
            l, events = payload
            if src not in self.table:
                self.table.add(src)      # learn from messages (§IV-C)
            pred = self._pred_peer()
            if l == 0:
                if pred is None or src == pred:
                    self.last_pred_msg = self.net.now
                    self.probing = None
                elif pred is not None and self.probing is None:
                    # §IV-A stabilization: TTL-0 from someone other than our
                    # predecessor means the ring changed nearby — verify that
                    # pred(1) is still alive instead of trusting the stream.
                    self.probing = pred
                    self.probe_sent_at = self.net.now
                    self.net.send(self.id, pred, V_A_BITS, "probe", None,
                                  acked=False)
            for ev in events:
                self._acknowledge(ev, l)
        elif kind == "leaving":
            ev: Event = payload
            self._acknowledge(ev, self.rho)   # Rule 6 (voluntary, no probe)
        elif kind == "join-request":
            self._handle_join(src)
        elif kind == "probe":
            self.net.send(self.id, src, V_A_BITS, "probe-reply", None,
                          acked=False)
        elif kind == "probe-reply":
            if self.probing == src:
                self.probing = None
                self.last_pred_msg = self.net.now

    # -- Rule 5: predecessor failure detection ----------------------------------------
    def _check_predecessor(self) -> None:
        pred = self._pred_peer()
        if pred is None:
            return
        silent = self.net.now - self.last_pred_msg
        if (self.probing == pred
                and self.net.now - self.probe_sent_at > self.theta / 4.0):
            # probe outstanding with no reply => confirmed dead (Rule 5)
            self.table.remove(pred)
            self.probing = None
            ev = self._make_event(pred, "leave")
            self._acknowledge(ev, self.rho)   # Rule 6
            self.last_pred_msg = self.net.now
        elif self.probing is None and silent > self.theta:
            self.probing = pred
            self.probe_sent_at = self.net.now
            self.net.send(self.id, pred, V_A_BITS, "probe", None, acked=False)

    # -- §VI joining protocol ------------------------------------------------------------
    def _handle_join(self, new_id: int) -> None:
        """We are (about to be) the successor of ``new_id``."""
        newcomer = self.net.peers.get(new_id)
        if newcomer is None or not isinstance(newcomer, D1HTPeer):
            return
        newcomer.start(table_from=self)
        self.table.add(new_id)
        ev = self._make_event(new_id, "join")
        self._acknowledge(ev, self.rho)       # Rule 6: join detected by successor
        # stream our buffered knowledge so the newcomer misses nothing (§VI)
        for k, (bev, ttl) in list(self.buffer.acked.items()):
            newcomer._acknowledge(bev, ttl)


