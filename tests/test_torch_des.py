"""The port's message-level DES (``repro_torch.dht``) against repro's, on
the CPU.

The DES is pure host Python: ``heapq`` and ``random.Random`` with the
same draws in the same order, and the routing tables' mutations stay on
the host.  So ``run_churn`` must give repro's ``ChurnResult`` exactly,
field by field, and the ``SimNet``-level scenarios of
``tests/test_des.py`` must end in the same peer tables and meters on
both packages (and pass their own checks on the port).  Also here: the
ring helpers the DES needs (``ring_distance``, ``in_interval``,
``build_ring``) and the delay models' draws.
"""
import dataclasses
import random
from types import SimpleNamespace

import numpy as np
import pytest

import repro.core.ring as j_ring
import repro.core.tuning as j_tuning
import repro.dht as j_dht
import repro.dht.des as j_des
import repro_torch.core.ring as t_ring
import repro_torch.core.tuning as t_tuning
import repro_torch.dht as t_dht
import repro_torch.dht.des as t_des
from repro.runtime.placement import Topology

PKGS = {
    "repro": SimpleNamespace(ring=j_ring, tuning=j_tuning, dht=j_dht,
                             des=j_des),
    "repro_torch": SimpleNamespace(ring=t_ring, tuning=t_tuning, dht=t_dht,
                                   des=t_des),
}

BASE = dict(s_avg=174 * 60, duration=600, warmup=120)
CASES = {
    "d1ht_n64_lan": (dict(n=64, seed=5, **BASE), None),
    "calot_n64": (dict(n=64, seed=6, protocol="calot", **BASE), None),
    "quarantine_n128": (dict(n=128, seed=7, volatile_fraction=0.31,
                             quarantine_tq=600.0, **BASE), None),
    "d1ht_n64_wan": (dict(n=64, seed=8, **BASE), "WanDelay"),
    # GeoDelay duck-types its topology: both packages get repro's
    "d1ht_n64_geo": (dict(n=64, seed=9, **BASE), "GeoDelay"),
}


def _run(pkg, name):
    kw, delay = CASES[name]
    ns = PKGS[pkg]
    if delay == "GeoDelay":
        kw = dict(kw, delay=ns.des.GeoDelay(Topology.multi_dc(4)))
    elif delay:
        kw = dict(kw, delay=getattr(ns.des, delay)())
    return ns.dht.run_churn(ns.dht.ChurnConfig(**kw))


@pytest.mark.parametrize("name", sorted(CASES))
def test_run_churn_equals_repro(name):
    want, got = _run("repro", name), _run("repro_torch", name)
    assert type(got).__module__ == "repro_torch.core.churn"
    assert want.events > 0
    for f in dataclasses.fields(want):
        if f.name not in ("cfg", "params"):
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert dataclasses.asdict(got.params) == dataclasses.asdict(want.params)
    if CASES[name][0].get("quarantine_tq"):
        assert want.quarantine_skipped > 0 and want.quarantine_admitted > 0


# ---------------------------------------------------------------------------
# SimNet-level scenarios (tests/test_des.py), on both packages
# ---------------------------------------------------------------------------

def _static_net(ns, proto, n, seed=0):
    """test_des._static_net on package ``ns``."""
    net = ns.des.SimNet(ns.des.LanDelay(), seed=seed)
    params = ns.tuning.EdraParams.derive(n, 174 * 60)
    cls = ns.dht.D1HTPeer if proto == "d1ht" else ns.dht.CalotPeer
    ids = list(ns.ring.build_ring(n, seed=seed).ids)
    for pid in ids:
        net.add_peer(cls(pid, net, params))
    net.ring = ns.ring.RoutingTable(ids)
    rng = random.Random(seed + 1)
    for pid in ids:
        p = net.peers[pid]
        p.table = ns.ring.RoutingTable(ids)
        net.schedule(rng.random() * max(params.theta, 1.0),
                     (lambda q: (lambda: q.start()))(p))
    net.run_until(40)
    return net, params, ids


def _state(net):
    """What a scenario leaves behind: every peer's table and meter, the
    clock and the ground-truth ring."""
    return ({pid: (p.alive, p.table.ids if hasattr(p, "table") else None)
             for pid, p in net.peers.items()},
            {pid: dataclasses.asdict(m) for pid, m in net.meters.items()},
            net.now, list(net.ring.ids), net.event_seq)


def _two_peer_net(ns, seed=3):
    class Sink(ns.des.SimPeer):
        def start(self):
            self.alive = True

        def stop(self, *, crash):
            self.alive = False

    net = ns.des.SimNet(ns.des.LanDelay(), seed=seed)
    for pid in (1, 2):
        p = Sink(pid, net)
        p.alive = True
        net.add_peer(p)
    return net


def _metering_warmup_edge(ns):
    net = _two_peer_net(ns)
    net.metering = False                  # still warming up at send time
    net.send(1, 2, 320, "maint")
    net.metering = True                   # window opens mid-flight
    net.run_until(1.0)
    for pid in (1, 2):
        assert net.meters[pid].in_bits == net.meters[pid].out_bits == 0
    return net


def _metering_window_close(ns):
    net = _two_peer_net(ns)
    net.metering = True
    net.send(1, 2, 320, "maint")
    net.metering = False                  # window closes mid-flight
    net.run_until(1.0)
    assert (net.meters[1].out_bits, net.meters[2].in_bits,
            net.meters[2].out_bits, net.meters[1].in_bits) == (320, 320,
                                                               288, 288)
    return net


def _single_crash(ns, proto):
    net, params, ids = _static_net(ns, proto, 48)
    victim = ids[10]
    net.peers[victim].stop(crash=True)
    net.ring.remove(victim)
    net.run_until(40 + 30 * params.theta)
    assert not [p for p in ids if p != victim
                and victim in net.peers[p].table]
    return net


def _voluntary_leave(ns, proto):
    net, params, ids = _static_net(ns, proto, 32)
    victim = ids[3]
    net.peers[victim].stop(crash=False)    # flush + notify successor
    net.ring.remove(victim)
    net.run_until(40 + 6 * params.theta)
    assert not [p for p in ids if p != victim
                and victim in net.peers[p].table]
    return net


def _join_propagates(ns):
    net, params, ids = _static_net(ns, "d1ht", 32)
    joiner = ids[7]
    net.peers[joiner].stop(crash=True)
    net.ring.remove(joiner)
    net.run_until(net.now + 30 * params.theta)
    succ = net.ring.successor_of(joiner)
    net.send(joiner, succ, 288, "join-request", None)
    net.ring.add(joiner)
    net.run_until(net.now + 30 * params.theta)
    assert not [p for p in ids if joiner not in net.peers[p].table
                and net.is_alive(p)]
    return net


SCENARIOS = {
    "metering_warmup_edge": _metering_warmup_edge,
    "metering_window_close": _metering_window_close,
    "single_crash_d1ht": lambda ns: _single_crash(ns, "d1ht"),
    "single_crash_calot": lambda ns: _single_crash(ns, "calot"),
    "voluntary_leave_d1ht": lambda ns: _voluntary_leave(ns, "d1ht"),
    "voluntary_leave_calot": lambda ns: _voluntary_leave(ns, "calot"),
    "join_propagates": _join_propagates,
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_simnet_scenario_agrees(name):
    want = _state(SCENARIOS[name](PKGS["repro"]))
    got = _state(SCENARIOS[name](PKGS["repro_torch"]))
    assert got == want


# ---------------------------------------------------------------------------
# ring helpers and delay draws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,seed", [(1, 0), (200, 1), (1000, 0)])
def test_build_ring_equals_repro(n, seed):
    got = t_ring.build_ring(n, seed=seed)
    assert isinstance(got, t_ring.RoutingTable)
    assert got.ids == j_ring.build_ring(n, seed=seed).ids
    assert len(got) == n


def test_ring_distance_and_in_interval_equal_repro():
    rng = np.random.default_rng(3)
    pts = [int(x) for x in rng.integers(0, 2**64, size=40, dtype=np.uint64)]
    pts += [0, 1, 2**63, 2**64 - 1]
    for a in pts:
        for b in pts[::3]:
            assert t_ring.ring_distance(a, b) == j_ring.ring_distance(a, b)
            for x in pts[::7] + [a, b]:
                for inc in (True, False):
                    assert t_ring.in_interval(x, a, b, inclusive_hi=inc) \
                        == j_ring.in_interval(x, a, b, inclusive_hi=inc)


@pytest.mark.parametrize("model", ["LanDelay", "WanDelay", "GeoDelay"])
def test_delay_draws_equal_repro(model):
    def make(des):
        if model == "GeoDelay":
            return des.GeoDelay(Topology.multi_dc(3))
        return getattr(des, model)()
    mj, mt = make(j_des), make(t_des)
    rj, rt = random.Random(11), random.Random(11)
    for i in range(500):
        assert mt.sample_pair(rt, i, 7 * i + 3) == mj.sample_pair(rj, i,
                                                                  7 * i + 3)
    assert mt.sample(rt) == mj.sample(rj)
    if model != "WanDelay":
        assert mt.mean == mj.mean
