"""Tensor-parallel ServeCluster demo on the port: one ring node = a group
of two shards (the twin of ``examples/tp_cluster.py``).

    PYTHONPATH=src python -m repro_torch.tp_cluster [--device cpu]

A 4-node ring over four tp=2 replica groups, carved from a pool of eight
entries of one device (on the card: eight shards on ``cuda:0``, two a
group), serves six sessions; a whole ring node fails (its sessions
re-home through the per-shard KV-block handoff), then one device of a
live group is lost (the whole replica dies with it and its sessions
migrate).  qwen2.5-3b's smoke config in float32 with random weights from
seed 0.  Exits 1 unless every token stream equals a tp=1 run of the same
workload, both churn legs migrated, a handoff ran without a miss, and
one group is dead.
"""
from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Tuple

import numpy as np
import torch

from .configs import get_smoke_config
from .kernels.backend import resolve_device
from .models import Model
from .runtime import Membership
from .serve import Request, ServeCluster


def requests(cfg, *, sessions: int = 6, prompt_len: int = 40,
             max_new: int = 8, seed: int = 0) -> List[Request]:
    rng = np.random.default_rng(seed)
    return [Request(f"s{i}", rng.integers(0, cfg.vocab, prompt_len,
                                          dtype=np.int32),
                    max_new_tokens=max_new) for i in range(sessions)]


def run(model, params, reqs, tp: int, device, *, slots: int = 8,
        max_len: int = 64, prefill_chunk: int = 16, steps: int = 2,
        mirror_loss: bool = False,
        hooks=None) -> Tuple[Dict[str, List[int]], Dict, ServeCluster]:
    """The scenario of ``examples/tp_cluster.py`` on ``device``: 4 nodes,
    the requests submitted, ``steps`` rounds, the owner of the first
    session fails, one round, then (tp > 1) one device of the oldest live
    group is lost (with ``mirror_loss`` a tp = 1 run fails that node
    instead, so both runs see the same membership events), then rounds to
    the end.  ``hooks`` (callables taking the cluster) see it before the
    submits (``routed``), after them (``submitted``), and just before and
    after the node failure (``before_fail``, ``after_fail``) and the
    device loss (``before_loss``, ``after_loss``).  Returns the token
    streams, the stats and the cluster."""
    hooks = hooks or {}

    def hook(name):
        if name in hooks:
            hooks[name](cluster)

    m = Membership(t_q=60.0, now=lambda: 0.0, device=device)
    for i in range(4):
        m.request_join(f"10.3.0.{i}", 7000 + i)
    cluster = ServeCluster(m, model, params, slots=slots, max_len=max_len,
                           prefill_chunk=prefill_chunk, tp=tp, device=device)
    hook("routed")
    for r in reqs:
        cluster.submit(r)
    hook("submitted")
    for _ in range(steps):
        cluster.step()
    # churn leg 1: a whole ring node fails -> its sessions re-home via the
    # per-shard KV-block handoff (each shard's kv-head slice is fetched
    # on its own and reassembled under the target group)
    hook("before_fail")
    m.fail(cluster.sessions[reqs[0].session_id].owner)
    hook("after_fail")
    cluster.step()
    if tp > 1 or mirror_loss:
        # churn leg 2: ONE device of a live group dies -> the whole
        # replica is lost (partial-group policy) and migrates too
        hook("before_loss")
        victim = next(iter(cluster.replicas))
        if tp > 1:
            node, devs = next(iter(cluster.supervisor._groups.items()))
            if node != victim or cluster.lose_device(devs[-1]) != node:
                raise AssertionError("lose_device failed another node")
        else:
            m.fail(victim)
        hook("after_loss")
    cluster.run()
    toks = {sid: list(rec.generated) for sid, rec in cluster.sessions.items()}
    return toks, cluster.stats(), cluster


def check(base: Dict, toks: Dict, stats: Dict) -> List[str]:
    """The example's gates on a tp=2 run against the tp=1 streams."""
    faults = []
    if toks != base:
        faults.append("tp=2 token streams diverged from tp=1")
    if stats.get("migrated", 0) < 2:
        faults.append(f"expected migrations from both churn legs: {stats}")
    if stats.get("handoffs", 0) < 1 or stats.get("handoff_misses", 0):
        faults.append(f"per-shard KV handoff not exercised cleanly: {stats}")
    if stats.get("dead_groups") != 1:
        faults.append(f"partial-group loss not recorded: {stats}")
    return faults


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device of the pool (default: the CUDA card)")
    dev = resolve_device(ap.parse_args(argv).device)
    cfg = get_smoke_config("qwen2.5-3b").with_overrides(dtype="float32")
    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    reqs = requests(cfg)
    base, _, _ = run(model, params, reqs, 1, dev)
    tp2, st2, _ = run(model, params, reqs, 2, dev)
    faults = check(base, tp2, st2)
    for f in faults:
        print(f"FAIL: {f}")
    if faults:
        return 1
    print(f"ok: 6 sessions token-identical tp=1 vs tp=2 through a node "
          f"failure + a partial-group device loss "
          f"(migrated={st2['migrated']}, handoffs={st2['handoffs']}, "
          f"dead_groups={st2['dead_groups']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
