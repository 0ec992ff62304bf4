"""Quickstart: the D1HT core in five minutes, on the port.

    PYTHONPATH=src python -m repro_torch.quickstart [--device cpu]

The twin of ``examples/quickstart.py``: the same five steps print the
same numbers.  Step 5 turns the ring's ids into a sorted uint32 table
and routes 4096 keys through the single-word ring lookup (K7) on the
chosen device: the CUDA kernel on the card (the default), its plain
version with ``--device cpu``.
"""
from __future__ import annotations

import argparse
import sys
from typing import Callable

import numpy as np
import torch

from .core import analysis, build_ring
from .core.tuning import EdraParams
from .dht import ChurnConfig, run_churn
from .kernels.backend import resolve_device
from .kernels.ring_lookup.ops import ring_lookup


def run(device=None, out: Callable[[str], None] = print) -> dict:
    """The five steps, each printing one line through ``out``.  Returns
    step 5's uint32 ``table`` and ``keys`` (numpy) and the ``idx``
    tensor K7 gave on ``device``."""
    device = resolve_device(device)

    # 1. A consistent-hashing ring with full routing tables (paper §III)
    ring = build_ring(1000, seed=0)
    key = "checkpoint/step_420/shard_3"
    out(f"owner of {key!r}: peer {ring.owner(key) % 10**6}")

    # 2. Self-tuned EDRA parameters (paper §IV-D): every peer derives
    #    these locally from the event rate it observes
    p = EdraParams.derive(n=10**6, s_avg=174 * 60)
    out(f"n=1e6 Gnutella: rho={p.rho} Theta={p.theta:.1f}s "
        f"T_detect={p.t_detect:.1f}s max_buffer={p.max_events:.0f} events")

    # 3. Analytical maintenance traffic (paper Eq IV.5) vs the baselines
    b = analysis.d1ht_bandwidth(10**6, 174 * 60)
    c = analysis.calot_bandwidth(10**6, 174 * 60)
    out(f"per-peer maintenance: D1HT={b/1e3:.1f} kbps, 1h-Calot={c/1e3:.1f} "
        f"kbps ({c/b:.0f}x)")

    # 4. Protocol-level simulation: >99% one-hop lookups under churn (§VII)
    r = run_churn(ChurnConfig(n=200, s_avg=174 * 60, duration=300, warmup=60,
                              protocol="d1ht", seed=1))
    out(f"DES n=200: one-hop={r.one_hop_fraction*100:.2f}% "
        f"bandwidth sim/model={r.mean_out_bps/r.analytical_bps:.2f}")

    # 5. The serving hot path: batched ring lookups through K7
    table = np.sort(np.asarray([i >> 32 for i in ring.ids], np.uint32))
    keys = np.random.default_rng(0).integers(0, 2**32, 4096, dtype=np.uint32)
    idx = ring_lookup(torch.from_numpy(keys.view(np.int32)).to(device),
                      torch.from_numpy(table.view(np.int32)).to(device))
    what = "kernel" if device.type == "cuda" else f"plain version ({device})"
    out(f"ring_lookup {what} routed {len(keys)} keys; "
        f"first 5 -> peers {idx[:5].tolist()}")
    return {"table": table, "keys": keys, "idx": idx}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    run(ap.parse_args(argv).device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
