"""Live D1HT peer over real UDP sockets (asyncio, loopback-friendly): the
port's copy of ``repro.dht.udp_node``, on the port's ``core.edra``,
``core.ring`` and ``core.tuning``.

The DES (``dht.des``) gives deterministic, byte-accounted experiments;
this node is the deployment path: the same EDRA state machine speaking
actual datagrams.  The wire format follows Fig. 2 and is ``repro``'s byte
for byte: a fixed header (magic, type, port, seqno) followed by 16-byte
events (kind, IPv4 address, port, seq), the port carried so that several
peers can share one loopback address.
"""
from __future__ import annotations

import asyncio
import socket
import struct
import time
from typing import Dict, List, Optional, Set, Tuple

from ..core.edra import Event, EventBuffer
from ..core.ring import RoutingTable, in_interval, peer_id
from ..core.tuning import EdraParams

MAGIC = 0xD147
T_MAINT, T_PROBE, T_PROBE_R, T_JOIN_REQ, T_TABLE, T_LEAVING, \
    T_FWD_JOIN = range(7)
HDR = struct.Struct("!HBHI")          # magic, type, port, seqno
EV = struct.Struct("!B4sHQ")          # kind, ip4, port, seq


def encode_events(events: List[Event]) -> bytes:
    out = b""
    for e in events:
        ip, port = e.addr
        out += EV.pack(1 if e.kind == "join" else 0,
                       socket.inet_aton(ip), port, e.seq)
    return out


def decode_events(buf: bytes) -> List[Event]:
    out = []
    for off in range(0, len(buf) - EV.size + 1, EV.size):
        kind, ip4, port, seq = EV.unpack_from(buf, off)
        addr = (socket.inet_ntoa(ip4), port)
        out.append(Event(subject_id=peer_id(*addr),
                         kind="join" if kind else "leave",
                         addr=addr, seq=seq))
    return out


class UdpD1HTPeer(asyncio.DatagramProtocol):
    def __init__(self, host: str, port: int, params: EdraParams):
        self.addr = (host, port)
        self.id = peer_id(host, port)
        self.params = params
        self.theta = max(params.theta, 0.2)
        self.rho = params.rho
        self.table = RoutingTable([self.id])
        self.addr_of: Dict[int, Tuple[str, int]] = {self.id: self.addr}
        self.buffer = EventBuffer(self.rho)
        self.seen: Set[Tuple[int, str, int]] = set()
        self.dead: Set[int] = set()          # leave tombstones (anti-entropy)
        self.last_pred = time.monotonic()
        self.probing: Optional[int] = None
        self.seq = 0
        self.transport: Optional[asyncio.DatagramTransport] = None
        self._task: Optional[asyncio.Task] = None
        self.running = False

    # -- lifecycle ----------------------------------------------------------
    async def start(self) -> None:
        loop = asyncio.get_running_loop()
        self.transport, _ = await loop.create_datagram_endpoint(
            lambda: self, local_addr=self.addr)
        self.running = True
        self._task = asyncio.create_task(self._interval_loop())

    async def join(self, bootstrap: Tuple[str, int]) -> None:
        await self.start()
        self._send(bootstrap, T_JOIN_REQ, b"")

    async def stop(self) -> None:
        self.running = False
        if self._task:
            self._task.cancel()
        if self.transport:
            self.transport.close()

    # -- transport ------------------------------------------------------------
    def _send(self, addr: Tuple[str, int], mtype: int, payload: bytes,
              seqno: int = 0) -> None:
        if self.transport is None or self.transport.is_closing():
            return
        self.transport.sendto(HDR.pack(MAGIC, mtype, self.addr[1], seqno)
                              + payload, addr)

    def datagram_received(self, data: bytes, addr) -> None:
        if len(data) < HDR.size:
            return
        magic, mtype, sport, seqno = HDR.unpack_from(data)
        if magic != MAGIC:
            return    # SystemID check (Fig. 2): drop foreign systems
        src = (addr[0], sport)
        src_id = peer_id(*src)
        body = data[HDR.size:]
        if mtype == T_MAINT:
            ttl = body[0]
            self._learn(src_id, src)
            if ttl == 0:
                pred = self._pred()
                if pred is None or src_id == pred:
                    self.last_pred = time.monotonic()
                    self.probing = None
                elif self.probing is None and pred is not None:
                    self.probing = pred
                    self._send(self.addr_of[pred], T_PROBE, b"")
            for ev in decode_events(body[1:]):
                self._acknowledge(ev, ttl)
        elif mtype == T_PROBE:
            self._send(src, T_PROBE_R, b"")
        elif mtype == T_PROBE_R:
            if self.probing == src_id:
                self.probing = None
                self.last_pred = time.monotonic()
        elif mtype == T_JOIN_REQ:
            self._handle_join(src_id, src)
        elif mtype == T_TABLE:
            for ev in decode_events(body):
                self._learn(ev.subject_id, ev.addr)
        elif mtype == T_LEAVING:
            for ev in decode_events(body):
                self._acknowledge(ev, self.rho)
        elif mtype == T_FWD_JOIN:
            for ev in decode_events(body):
                self._handle_join(ev.subject_id, ev.addr)

    # -- EDRA ----------------------------------------------------------------
    def _pred(self) -> Optional[int]:
        if len(self.table) <= 1:
            return None
        return self.table.pred(self.id, 1)

    def _learn(self, pid: int, addr: Tuple[str, int]) -> None:
        if pid in self.dead:
            return
        self.addr_of[pid] = addr
        self.table.add(pid)

    def _make_event(self, pid: int, kind: str) -> Event:
        self.seq += 1
        return Event(subject_id=pid, kind=kind,
                     addr=self.addr_of.get(pid, ("0.0.0.0", 0)),
                     seq=int(time.monotonic() * 1000) * 64 + self.seq % 64)

    def _acknowledge(self, ev: Event, ttl: int) -> None:
        k = ev.dedup_key()
        if k in self.seen:
            return
        self.seen.add(k)
        if ev.kind == "join":
            self.dead.discard(ev.subject_id)
            self._learn(ev.subject_id, ev.addr)
        else:
            self.dead.add(ev.subject_id)
            self.table.remove(ev.subject_id)
            self.addr_of.pop(ev.subject_id, None)
        self.buffer.acknowledge(ev, ttl)

    def _handle_join(self, new_id: int, addr: Tuple[str, int]) -> None:
        # single-hop routing of the join (paper §VI): only the NEW PEER'S
        # SUCCESSOR admits it — anyone else forwards the request one hop.
        owner = self.table.successor_of(new_id)
        if owner != self.id and owner in self.addr_of:
            self._send(self.addr_of[owner], T_FWD_JOIN,
                       encode_events([Event(subject_id=new_id, kind="join",
                                            addr=addr, seq=0)]))
            return
        # §VI: ship our routing table (not maintenance traffic), then
        # announce the join through EDRA with TTL = rho (Rule 6)
        entries = [Event(subject_id=p, kind="join",
                         addr=self.addr_of[p], seq=0)
                   for p in self.table.ids if p in self.addr_of]
        self._send(addr, T_TABLE, encode_events(entries))
        self._learn(new_id, addr)
        self._acknowledge(self._make_event(new_id, "join"), self.rho)

    async def _interval_loop(self) -> None:
        k = 0
        while self.running:
            await asyncio.sleep(self.theta)
            self._flush()
            self._check_pred()
            k += 1
            if k % 10 == 0:
                self._anti_entropy()

    def _anti_entropy(self) -> None:
        """§IV-C: EDRA is exactly-once, so peers that were mid-join when an
        event finished disseminating can stay stale; the paper points to
        re-announcements/gossip as the standard remedy.  Every ~10
        intervals we ship our member view to the successor (learning-only;
        leaves keep authority via EDRA + tombstones)."""
        if len(self.table) <= 1:
            return
        succ = self.table.succ(self.id, 1)
        if succ in self.addr_of:
            entries = [Event(subject_id=p, kind="join",
                             addr=self.addr_of[p], seq=0)
                       for p in self.table.ids if p in self.addr_of]
            self._send(self.addr_of[succ], T_TABLE, encode_events(entries))

    def _flush(self) -> None:
        per_ttl = self.buffer.flush()
        for l in range(self.rho):
            if 2 ** l >= len(self.table):
                continue
            target = self.table.succ(self.id, 2 ** l)
            if target == self.id or target not in self.addr_of:
                continue
            events = [e for e in per_ttl.get(l, [])
                      if not in_interval(e.subject_id, self.id, target)]
            if l == 0 or events:
                self._send(self.addr_of[target], T_MAINT,
                           bytes([l]) + encode_events(events))

    def _check_pred(self) -> None:
        pred = self._pred()
        if pred is None:
            return
        if self.probing == pred:
            self.probing = None
            addr = self.addr_of.get(pred, ("0.0.0.0", 0))
            self.table.remove(pred)
            self.addr_of.pop(pred, None)
            ev = Event(subject_id=pred, kind="leave", addr=addr,
                       seq=self._make_event(pred, "leave").seq)
            self._acknowledge(ev, self.rho)
            self.last_pred = time.monotonic()
        elif time.monotonic() - self.last_pred > self.theta:
            self.probing = pred
            if pred in self.addr_of:
                self._send(self.addr_of[pred], T_PROBE, b"")
