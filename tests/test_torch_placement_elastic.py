"""The port's ``Placement`` and ``ElasticController`` against repro's on
the same membership, and the ``dht_cluster`` twin against
``examples/dht_cluster.py``.

Both packages admit the same peers (and fail the same ones): every key
owner, replica group, expert assignment and permutation, session owner
and balance statistic is equal; ``replan`` gives the same plans and
generations through joins and failures; straggler detection and
eviction pick the same hosts.  The twin prints the example's lines.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.runtime import ElasticController as JElastic
from repro.runtime import Membership as JMembership
from repro.runtime import Placement as JPlacement
from repro_torch import dht_cluster
from repro_torch.core.ring import RoutingTable, build_ring
from repro_torch.core.ringstate import RingState
from repro_torch.runtime import ElasticController, Membership, MeshPlan
from repro_torch.runtime import Placement

REPO = Path(__file__).resolve().parents[1]


def _memberships(n, fail=()):
    pair = (JMembership(t_q=60.0, now=lambda: 0.0),
            Membership(t_q=60.0, now=lambda: 0.0, device="cpu"))
    for i in range(n):
        for m in pair:
            m.request_join(f"10.7.{i // 256}.{i % 256}", 6000 + i)
    for k in fail:
        victim = pair[0].members()[k]
        for m in pair:
            m.fail(victim)
    return pair


@pytest.mark.parametrize("n,fail", [(1, ()), (5, ()), (64, (3, 10)),
                                    (300, (0, 299 - 2, 150))])
def test_placement_matches_repro_on_the_same_membership(n, fail):
    jm, m = _memberships(n, fail)
    assert m.members() == jm.members()
    jp, p = JPlacement(jm.table), Placement(m.table)
    keys = [f"key/{i}" for i in range(200)]
    assert p.owners(keys) == jp.owners(keys)
    assert [p.owner(k) for k in keys[:20]] == [jp.owner(k) for k in keys[:20]]
    for r in (1, 2, 3):
        assert [p.replica_owners(k, r) for k in keys[:30]] == \
            [jp.replica_owners(k, r) for k in keys[:30]]
    for e, shards, salt in ((32, 4, ""), (160, 8, "ds"), (7, 3, "x")):
        assert np.array_equal(p.expert_assignment(e, shards, salt),
                              jp.expert_assignment(e, shards, salt))
        assert np.array_equal(p.expert_permutation(e, shards, salt),
                              jp.expert_permutation(e, shards, salt))
    assert [p.session_owner(f"s{i}") for i in range(20)] == \
        [jp.session_owner(f"s{i}") for i in range(20)]
    assert p.balance_stats(512) == jp.balance_stats(512)


def test_placement_wraps_a_ring_state_and_handles_an_empty_ring():
    state = RingState(build_ring(16, seed=3).ids, device="cpu")
    p = Placement(state)
    assert isinstance(p.table, RoutingTable) and p.state is state
    assert p.owner("a") == state.successor_of(p.table.owner("a"))
    empty = Placement(RoutingTable())
    assert empty.expert_assignment(6, 4).tolist() == [0, 1, 2, 3, 0, 1]


@pytest.mark.parametrize("model_axis,min_data", [(4, 1), (2, 1), (8, 2),
                                                 (3, 1)])
def test_elastic_replan_matches_repro_through_joins_and_failures(
        model_axis, min_data):
    jm, m = _memberships(0)
    jc = JElastic(jm, model_axis=model_axis, min_data_axis=min_data)
    c = ElasticController(m, model_axis=model_axis, min_data_axis=min_data)

    def same():
        assert (c.plan.data_axis, c.plan.model_axis, c.plan.participants,
                c.plan.dropped, c.plan.size, c.generation) == \
            (jc.plan.data_axis, jc.plan.model_axis, jc.plan.participants,
             jc.plan.dropped, jc.plan.size, jc.generation)

    for i in range(37):
        for mem in (jm, m):
            mem.request_join(f"10.8.0.{i}", 5000 + i)
        same()
    for k in (0, 5, 5, 20):
        victim = jm.members()[k]
        for mem in (jm, m):
            mem.fail(victim)
        same()
    assert isinstance(c.replan(), MeshPlan)
    jc.replan()
    same()


def test_straggler_eviction_matches_repro():
    jm, m = _memberships(12)
    jc, c = JElastic(jm, model_axis=4), ElasticController(m, model_axis=4)
    assert c.stragglers() == jc.stragglers() == []
    rng = np.random.default_rng(4)
    times = rng.uniform(0.9, 1.1, 12)
    times[[2, 7]] = [2.5, 4.0]
    for ctl, mem in ((jc, jm), (c, m)):
        for nid, t in zip(mem.members(), times):
            ctl.heartbeat(nid, float(t))
    assert c.stragglers() == jc.stragglers()
    assert c.stragglers(factor=3.0) == jc.stragglers(factor=3.0)
    assert c.evict_stragglers() == jc.evict_stragglers()
    assert m.members() == jm.members() and len(m.members()) == 10
    assert (c.plan.data_axis, c.plan.participants, c.generation) == \
        (jc.plan.data_axis, jc.plan.participants, jc.generation)


def test_dht_cluster_twin_prints_the_examples_lines():
    """The twin on the CPU passes and prints every line of
    ``examples/dht_cluster.py`` (the same plans, repair counts, balance
    and expert shards), plus its line on the device lookup."""
    ref = subprocess.run(
        [sys.executable, str(REPO / "examples" / "dht_cluster.py")],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(REPO / "src")})
    assert ref.returncode == 0, ref.stdout + ref.stderr
    lines = []
    out = dht_cluster.run("cpu", log=lines.append)
    assert out["ok"] and out["owners_equal"] and out["min_replicas"] == 3
    assert out["device"] == "cpu" and out["bad_blocks"] == []
    extra = [ln for ln in lines if ln.startswith("block owners on ")]
    assert extra == ["block owners on cpu: equal to the host's successor "
                     "walk"]
    assert [ln for ln in lines if ln not in extra] == \
        ref.stdout.strip().splitlines()
