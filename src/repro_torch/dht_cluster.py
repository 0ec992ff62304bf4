"""Live D1HT cluster demo on the port: churn, failure detection, elastic
re-meshing, and real bytes surviving node crashes through the replicated
data plane (the twin of ``examples/dht_cluster.py``).

    PYTHONPATH=src python -m repro_torch.dht_cluster [--device cpu]

64 D1HT peers run EDRA on the message-level DES; the runtime control
plane mirrors their membership (its ``RingState`` on the CUDA card unless
``--device`` names another device), an ``ElasticController`` re-plans a
data x 4 mesh on every event, and a ``BlockStore`` keeps 32 blocks of
256 bytes on 3 replicas each.  Three ring-adjacent peers crash, with
re-replication between the detections.  Then the blocks' owners are
resolved in one batched lookup on the ring's device tables.  Exits 1 if
any block is lost, torn or stale, has fewer live replicas than 3, or
has a device owner other than the host's.
"""
from __future__ import annotations

import argparse
import random
import sys
from typing import Dict

import numpy as np

from .core.ring import RoutingTable, build_ring, key_id
from .core.tuning import EdraParams
from .dht.d1ht_node import D1HTPeer
from .dht.data import BlockStore
from .dht.des import LanDelay, SimNet
from .kernels.backend import resolve_device
from .runtime import ElasticController, Membership, Placement

N = 64
BLOCKS = 32
BLOCK_BYTES = 256
REPLICATION = 3


def run(device=None, *, log=print) -> Dict:
    """The scenario; returns what it observed (``ok`` False on a lost,
    torn or stale block or a block under ``REPLICATION`` live copies)."""
    dev = resolve_device(device)
    net = SimNet(LanDelay(), seed=0)
    params = EdraParams.derive(N, 174 * 60)
    ids = list(build_ring(N, seed=0).ids)
    for pid in ids:
        net.add_peer(D1HTPeer(pid, net, params))
    net.ring = RoutingTable(ids)
    rng = random.Random(1)
    for pid in ids:
        p = net.peers[pid]
        p.table = RoutingTable(ids)
        net.schedule(rng.random() * params.theta,
                     (lambda q: (lambda: q.start()))(p))
    net.run_until(30)

    # mirror protocol membership into the runtime control plane
    membership = Membership(device=dev)
    for pid in ids:
        membership.admit(pid, ("10.0.0.1", 1117))
    controller = ElasticController(membership, model_axis=4)
    first_plan = controller.replan()
    log(f"cluster up: {membership.size()} nodes, "
        f"mesh plan {first_plan.data_axis}x4")

    # replicated data plane over the same ring: real bytes, 3 copies each
    store = BlockStore(membership.ring_state, replication=REPLICATION)
    payloads = {f"demo/block-{i}": bytes(r.getrandbits(8)
                                         for _ in range(BLOCK_BYTES))
                for r, i in ((random.Random(100 + i), i)
                             for i in range(BLOCKS))}
    for name, value in payloads.items():
        store.put(name, value)
    log(f"data plane: {len(payloads)} blocks stored, "
        f"{store.upload_bytes} upload bytes ({store.replication} copies "
        f"each)")

    # three ring-ADJACENT crashes (one whole replica group for their arc),
    # re-replicated between the detections: r simultaneous unrepaired
    # crashes of one group are unrecoverable by construction
    repair = {"checked": 0, "repaired": 0, "copied_bytes": 0, "lost": 0}
    victims = ids[10:13]
    for victim in victims:
        net.peers[victim].stop(crash=True)
        net.ring.remove(victim)
        membership.fail(victim)
        store.drop_node(victim)            # a crash destroys its store
        for k, n in store.sync().items():  # detection-driven repair
            repair[k] += n
    net.run_until(net.now + 20 * params.theta)
    stale = sum(1 for pid in ids[13:20]
                if any(v in net.peers[pid].table for v in victims))
    plan = controller.plan
    log(f"after 3 crashes: peers with stale entries={stale}, "
        f"new plan {plan.data_axis}x{plan.model_axis} "
        f"(dropped {len(plan.dropped)})")

    bad = [name for name, value in payloads.items()
           if store.get(name) != value]
    counts = store.replica_counts()
    log(f"after 3 crashes: {len(payloads) - len(bad)}/{len(payloads)} "
        f"blocks intact, re-replication checked {repair['checked']} keys, "
        f"copied {repair['copied_bytes']} bytes, min live replicas "
        f"{min(counts.values())}")
    ok = not bad and min(counts.values()) >= store.replication
    if not ok:
        log(f"DATA LOSS: bad={bad}, counts={counts}")
    # the blocks' owners in one batched lookup on the ring's device tables
    # (K1 on the card), against the host's successor walk
    keys = np.array([key_id(name) for name in payloads], np.uint64)
    on_device = membership.ring_state.lookup(keys)
    owners_equal = [int(o) for o in on_device] == [
        membership.table.successor_of(int(k)) for k in keys]
    ok = ok and owners_equal
    log(f"block owners on {membership.ring_state.device}: "
        f"{'equal' if owners_equal else 'DIFFERENT'} to the host's "
        f"successor walk")

    placement = Placement(membership.table)
    balance = placement.balance_stats(2048)
    experts = placement.expert_assignment(32, 4).tolist()
    log(f"placement balance: {balance}")
    log(f"expert shards for 32 experts over 4 EP groups: {experts}")
    return {"ok": ok, "nodes": N, "members": membership.size(),
            "device": str(membership.ring_state.device),
            "first_plan": (first_plan.data_axis, first_plan.model_axis),
            "plan": (plan.data_axis, plan.model_axis),
            "dropped": len(plan.dropped), "generation": controller.generation,
            "stale_peers": stale, "bad_blocks": bad,
            "min_replicas": min(counts.values()),
            "upload_bytes": store.upload_bytes, "repair": repair,
            "owners_equal": owners_equal,
            "balance": balance, "experts": experts}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device of the ring's tables (default: the "
                         "CUDA card)")
    return 0 if run(ap.parse_args(argv).device)["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
