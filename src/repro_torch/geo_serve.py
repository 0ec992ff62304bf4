"""Geo-distributed serving demo on the port: two regions, one churned
workload, two placement policies (the twin of ``examples/geo_serve.py``).

    PYTHONPATH=src python -m repro_torch.geo_serve [--device cpu]

Eight ring nodes are pinned half to "us", half to "eu" (~40 ms one-way
between them); the same request stream — origins alternating between
the regions — and the same two node failures are replayed under
``RingSuccessor`` (placement blind to geography) and ``LatencyAware``
(ranks each session's replica set by RTT from its origin).  Every
admission or migration that lands a session outside its origin region
is metered by the serve plane.  qwen2.5-3b's smoke config in float32
with random weights from seed 0, on the CUDA card unless ``--device``
names another device.

Exits 1 unless LatencyAware measurably cuts cross-region placements.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .configs import get_smoke_config
from .kernels.backend import resolve_device
from .models import Model
from .runtime import LatencyAware, Membership, RingSuccessor, Topology
from .serve import Request, ServeCluster

N_PER_REGION = 4
REQUESTS = 12
FAIL = 2                      # nodes killed mid-decode, one per region


def run(policy, topo, model, params, dev):
    t = [0.0]
    m = Membership(t_q=60.0, now=lambda: t[0], policy=policy, device=dev)
    by_region = {"us": [], "eu": []}
    for r, region in enumerate(("us", "eu")):
        for i in range(N_PER_REGION):
            nid = m.request_join(f"10.9.{r}.{i}", 7100 + 10 * r + i)
            topo.place(nid, region)
            by_region[region].append(nid)
    cluster = ServeCluster(m, model, params, slots=8, max_len=48, device=dev)
    rng = np.random.default_rng(0)
    for i in range(REQUESTS):
        req = Request(f"g{i}", rng.integers(0, model.cfg.vocab,
                                            4 + (i % 3) * 5, dtype=np.int32),
                      max_new_tokens=6)
        cluster.submit(req, origin=("us", "eu")[i % 2])
    for _ in range(2):
        cluster.step()
    # kill one node per region mid-decode: every session it owned gets
    # re-placed by the policy (RingSuccessor -> whatever id sorts next;
    # LatencyAware -> the lowest-RTT surviving replica-set member)
    m.fail(by_region["us"][0])
    m.fail(by_region["eu"][0])
    cluster.run(max_rounds=64)
    s = cluster.stats()
    done = sum(1 for rec in cluster.sessions.values() if rec.done)
    return s, done


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    dev = resolve_device(ap.parse_args(argv).device)
    cfg = get_smoke_config("qwen2.5-3b").with_overrides(dtype="float32")
    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    topo = Topology({"us": (0.0, 0.0), "eu": (40.0, 0.0)})
    base_policy = RingSuccessor(topology=topo)   # topology for metering
    geo_policy = LatencyAware(topo, affinity_ms=5.0)

    results = {}
    for pol in (base_policy, geo_policy):
        s, done = run(pol, topo, model, params, dev)
        cross = s["cross_region_admits"] + s["cross_region_migrations"]
        results[pol.name] = cross
        print(f"{pol.name:>15}: {done}/{REQUESTS} sessions finished, "
              f"{s['migrated']} migrations, cross-region placements: "
              f"{s['cross_region_admits']} admits + "
              f"{s['cross_region_migrations']} migrations = {cross}")
        if done != REQUESTS:
            print(f"FAIL: {pol.name} lost sessions")
            return 1

    rs, la = results["ring_successor"], results["latency_aware"]
    if la >= rs:
        print(f"FAIL: latency_aware did not cut cross-region placements "
              f"({la} vs {rs})")
        return 1
    print(f"ok: latency_aware cut cross-region placements {rs} -> {la} "
          f"({1 - la / rs:.0%} fewer)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
