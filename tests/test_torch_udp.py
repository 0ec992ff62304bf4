"""The port's live UDP peer (``dht/udp_node.py``) against repro's.

The wire format is repro's byte for byte: header and event layouts,
message types and magic, and ``encode_events``/``decode_events`` both
ways.  Fed the same datagrams, a port peer and a repro peer keep the same
routing table and send the same replies.  The live ring on loopback
(join, converge, crash, detect) runs on ports 39140-39147, apart from
``tests/test_udp_cluster.py``'s 39120-39127 (xdist runs files at once).
"""
import asyncio

import pytest

import repro.dht.udp_node as judp
from repro.core.edra import Event as JEvent
from repro.core.tuning import EdraParams as JEdraParams
from repro_torch.core.edra import Event
from repro_torch.core.ring import peer_id
from repro_torch.core.tuning import EdraParams
from repro_torch.dht import udp_node as udp

BASE_PORT = 39140
N = 8

EVENTS = [("join", ("127.0.0.1", 39140), 0),
          ("leave", ("10.1.2.3", 7000), 17),
          ("join", ("192.168.255.254", 65535), 2**63 + 5),
          ("leave", ("0.0.0.0", 0), 2**64 - 1)]


def _events(cls):
    return [cls(subject_id=peer_id(*addr), kind=kind, addr=addr, seq=seq)
            for kind, addr, seq in EVENTS]


def test_wire_constants_are_repros():
    assert udp.HDR.format == judp.HDR.format and udp.HDR.size == 9
    assert udp.EV.format == judp.EV.format and udp.EV.size == 15
    assert udp.MAGIC == judp.MAGIC
    assert (udp.T_MAINT, udp.T_PROBE, udp.T_PROBE_R, udp.T_JOIN_REQ,
            udp.T_TABLE, udp.T_LEAVING, udp.T_FWD_JOIN) == \
        (judp.T_MAINT, judp.T_PROBE, judp.T_PROBE_R, judp.T_JOIN_REQ,
         judp.T_TABLE, judp.T_LEAVING, judp.T_FWD_JOIN)


@pytest.mark.parametrize("count", [0, 1, 4])
def test_encode_and_decode_match_repro_byte_for_byte(count):
    mine = udp.encode_events(_events(Event)[:count])
    ref = judp.encode_events(_events(JEvent)[:count])
    assert mine == ref and len(mine) == count * udp.EV.size
    for buf in (mine, ref + b"\x01\x02"):          # a torn tail is ignored
        got = udp.decode_events(buf)
        want = judp.decode_events(buf)
        assert [(e.subject_id, e.kind, e.addr, e.seq) for e in got] == \
            [(e.subject_id, e.kind, e.addr, e.seq) for e in want]


class _Sink:
    def __init__(self):
        self.sent = []

    def is_closing(self):
        return False

    def sendto(self, data, addr):
        self.sent.append((data, addr))


def test_peers_fed_the_same_datagrams_agree():
    """No sockets: both peers get a table, a join request, a probe and a
    maintenance message with events; their tables, dead sets and sent
    datagrams (byte for byte, up to the event seq clock) agree."""
    params = EdraParams.derive(N, 174 * 60)
    jparams = JEdraParams.derive(N, 174 * 60)
    me = udp.UdpD1HTPeer("127.0.0.1", BASE_PORT, params)
    ref = judp.UdpD1HTPeer("127.0.0.1", BASE_PORT, jparams)
    for p in (me, ref):
        p.transport = _Sink()
    table = [("127.0.0.1", BASE_PORT + i) for i in range(1, 6)]
    grams = [
        (udp.HDR.pack(udp.MAGIC, udp.T_TABLE, BASE_PORT + 1, 0)
         + udp.encode_events([Event(peer_id(*a), "join", a, 0)
                              for a in table]), ("127.0.0.1", 1)),
        (udp.HDR.pack(udp.MAGIC, udp.T_JOIN_REQ, BASE_PORT + 7, 0),
         ("127.0.0.1", 1)),
        (udp.HDR.pack(udp.MAGIC, udp.T_PROBE, BASE_PORT + 2, 0),
         ("127.0.0.1", 1)),
        (udp.HDR.pack(udp.MAGIC, udp.T_MAINT, BASE_PORT + 3, 0) + bytes([1])
         + udp.encode_events([Event(peer_id(*table[4]), "leave",
                                    table[4], 99)]), ("127.0.0.1", 1)),
        (udp.HDR.pack(0xBEEF, udp.T_TABLE, BASE_PORT + 6, 0)
         + udp.encode_events([Event(1, "join", ("127.0.0.1", 1), 0)]),
         ("127.0.0.1", 1)),
        (b"\x00", ("127.0.0.1", 1)),
    ]
    for data, addr in grams:
        me.datagram_received(data, addr)
        ref.datagram_received(data, addr)
        assert list(me.table.ids) == list(ref.table.ids)
        assert me.dead == ref.dead and me.addr_of == ref.addr_of
    assert len(me.transport.sent) == len(ref.transport.sent) > 0
    for (a, to_a), (b, to_b) in zip(me.transport.sent, ref.transport.sent):
        assert to_a == to_b and a[:udp.HDR.size] == b[:udp.HDR.size]


async def _converged(peers, expect_n, timeout=20.0):
    deadline = asyncio.get_event_loop().time() + timeout
    while asyncio.get_event_loop().time() < deadline:
        if all(len(p.table) == expect_n for p in peers if p.running):
            return True
        await asyncio.sleep(0.2)
    return False


@pytest.mark.slow
def test_live_udp_ring_join_and_crash():
    """8 port peers on loopback: join through one bootstrap, converge to
    full tables, agree on a key's owner, detect a crash (Rule 5) and
    disseminate it by EDRA over real datagrams."""
    async def scenario():
        params = EdraParams.derive(N, 174 * 60).retune(N, 2.0)  # fast Θ
        peers = [udp.UdpD1HTPeer("127.0.0.1", BASE_PORT + i, params)
                 for i in range(N)]
        await peers[0].start()
        for p in peers[1:]:
            await p.join(("127.0.0.1", BASE_PORT))
            await asyncio.sleep(0.15)
        assert await _converged(peers, N), [len(p.table) for p in peers]
        owners = {p.table.owner("some/key") for p in peers}
        assert len(owners) == 1
        victim = peers[3]
        await victim.stop()
        alive = [p for p in peers if p is not victim]
        assert await _converged(alive, N - 1, timeout=30.0), \
            [len(p.table) for p in alive]
        for p in alive:
            assert victim.id not in p.table
        for p in alive:
            await p.stop()

    asyncio.run(scenario())
