"""Serving demo on the port: a churn-aware continuous-batching cluster
over the D1HT ring (the twin of ``examples/serve_lm.py``).

    PYTHONPATH=src python -m repro_torch.serve_lm [--device cpu]

Sessions are routed to replicas by single-hop ring lookup; every replica
decodes all its slots at their own cache positions per round; killing a
replica mid-decode migrates exactly its sessions to their replica_set
successors (handed off from their replicated KV blocks, the tail
re-prefilled) with zero losses, and a quarantined spot node proxies
requests as a §V gateway without owning sessions.  qwen2.5-3b's smoke
config in bfloat16 with random weights from seed 0, on the CUDA card
unless ``--device`` names another device.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .configs import get_smoke_config
from .kernels.backend import resolve_device
from .models import Model
from .runtime import Membership
from .serve import Request, ServeCluster


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    dev = resolve_device(ap.parse_args(argv).device)

    cfg = get_smoke_config("qwen2.5-3b")
    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)

    membership = Membership(t_q=60.0, now=lambda: 0.0, device=dev)
    for i in range(4):
        membership.request_join(f"10.2.0.{i}", 9000)
    cluster = ServeCluster(membership, model, params, slots=8, max_len=64,
                           device=dev)

    # a quarantined spot node: proxies as a gateway, owns nothing (§V)
    gateway = membership.request_join("10.2.9.9", 9999, preemptible=True)

    rng = np.random.default_rng(0)
    reqs = [Request(f"user-{i}",
                    rng.integers(0, cfg.vocab, 4 + (i % 3) * 4,
                                 dtype=np.int32),
                    max_new_tokens=8) for i in range(6)]
    print("session -> replica routing (single-hop ring lookups, via "
          "gateway):")
    for r in reqs:
        cluster.submit(r, via=gateway)
        rec = cluster.sessions[r.session_id]
        print(f"  {r.session_id} (prompt {len(r.prompt):>2} tok) "
              f"-> node {rec.owner % 10**6}")
    print(f"gateway {gateway % 10**6} proxied {cluster.proxied[gateway]} "
          f"requests, owns {int(gateway in cluster.replicas)} slabs")

    # decode a few rounds, then kill the busiest replica mid-stream
    for _ in range(3):
        cluster.step()
    busiest = max(cluster.replicas,
                  key=lambda n: cluster.replicas[n].num_active)
    print(f"\nkilling node {busiest % 10**6} "
          f"({cluster.replicas[busiest].num_active} active sessions)...")
    membership.fail(busiest)
    print(f"migrated {cluster.migrated_sessions} sessions to their "
          f"replica_set successors ({cluster.handoffs} handed off from KV "
          f"blocks, {cluster.handoff_misses} re-prefilled from transcripts)")

    rounds = cluster.run()
    print(f"\nall sessions completed ({rounds} more rounds, zero losses):")
    for sid, rec in cluster.sessions.items():
        mark = f"  [migrated x{rec.migrations}]" if rec.migrations else ""
        print(f"  {sid}: {rec.generated}{mark}")
    lost = [sid for sid, rec in cluster.sessions.items()
            if len(rec.generated) != rec.max_new_tokens]
    return 1 if lost or cluster.pending_migrations else 0


if __name__ == "__main__":
    sys.exit(main())
