"""Churn experiment harness reproducing the paper's §VII methodology.

Two-phase runs: a growth/warmup phase (unmetered) followed by a metered
measurement window (the paper uses 30 min).  Churn is driven by per-peer
session lengths (Eq III.1 emerges from S_avg); half of the leaves are
crashes (SIGKILL — no warning, buffered events lost) and leaving peers
rejoin after 3 minutes with the same ID, exactly as in §VII-A.

Lookup correctness is sampled against the ground-truth ring: a lookup is
solved with one hop iff the origin's routing table maps the key to the
true current owner (stale entries => routing failure => extra hops).
"""
from __future__ import annotations

import random

from ..core.analysis import calot_bandwidth, d1ht_bandwidth
# Shared run shapes: this DES and the vectorized plane in core.sim
# consume the SAME config and produce the SAME result type, so the twin
# checks compare them field by field.
from ..core.churn import ChurnConfig, ChurnResult, SessionDist
from ..core.ring import RoutingTable, build_ring
from ..core.tuning import EdraParams
from .calot_node import CalotPeer
from .d1ht_node import D1HTPeer
from .des import LanDelay, SimNet
from .messages import V_A_BITS

__all__ = ["ChurnConfig", "ChurnResult", "SessionDist", "run_churn"]


# ---------------------------------------------------------------------------
# Runner
# ---------------------------------------------------------------------------

def run_churn(cfg: ChurnConfig) -> ChurnResult:
    rng = random.Random(cfg.seed + 7)
    net = SimNet(cfg.delay or LanDelay(), seed=cfg.seed)
    params = EdraParams.derive(cfg.n, cfg.s_avg, cfg.f)
    sessions = SessionDist(cfg.s_avg, cfg.volatile_fraction,
                           cfg.quarantine_tq or 600.0)

    ring = build_ring(cfg.n, seed=cfg.seed)
    ids = list(ring.ids)
    make = (lambda pid: D1HTPeer(pid, net, params)) if cfg.protocol == "d1ht" \
        else (lambda pid: CalotPeer(pid, net, params))
    for pid in ids:
        net.add_peer(make(pid))
    net.ring = RoutingTable(ids)

    # start everyone with the full table and randomized interval phases
    for pid in ids:
        peer = net.peers[pid]
        peer.table = RoutingTable(ids)
        phase = rng.random() * max(params.theta, 1.0)
        net.schedule(phase, lambda p=peer: p.start())

    stats = {"events": 0, "lookups": 0, "one_hop": 0,
             "q_admit": 0, "q_skip": 0}

    # -- churn driver ---------------------------------------------------------
    def schedule_leave(pid: int, session: float) -> None:
        net.schedule(session, lambda: do_leave(pid))

    def do_leave(pid: int) -> None:
        peer = net.peers[pid]
        if not peer.alive:
            return
        crash = rng.random() < cfg.crash_fraction
        peer.stop(crash=crash)
        if pid in net.ring:
            net.ring.remove(pid)
            if net.metering:
                stats["events"] += 1
        net.schedule(cfg.rejoin_delay, lambda: do_join(pid))

    def do_join(pid: int) -> None:
        session = sessions.sample(rng)
        if cfg.quarantine_tq is not None:
            if session <= cfg.quarantine_tq:
                # volatile peer: never admitted, no events, rejoin later (§V)
                stats["q_skip"] += 1
                net.schedule(session + cfg.rejoin_delay, lambda: do_join(pid))
                return
            stats["q_admit"] += 1
            net.schedule(cfg.quarantine_tq, lambda: admit(pid, session))
            return
        admit(pid, session)

    def admit(pid: int, session: float) -> None:
        try:
            succ_id = net.ring.successor_of(pid)
        except LookupError:
            return
        net.send(pid, succ_id, V_A_BITS, "join-request", None)
        net.ring.add(pid)
        if net.metering:
            stats["events"] += 1
        remaining = session - (cfg.quarantine_tq or 0.0)
        schedule_leave(pid, max(remaining, 1.0))

    for pid in ids:
        schedule_leave(pid, max(1.0, sessions.sample(rng)))

    # -- lookup sampling ---------------------------------------------------------
    lookup_dt = cfg.duration / cfg.lookup_samples

    def do_lookup() -> None:
        alive = [p for p in net.ring if net.is_alive(p)]
        if len(alive) >= 2:
            origin = net.peers[rng.choice(alive)]
            kid = rng.getrandbits(60)
            try:
                local = origin.table.successor_of(kid)
                true = net.ring.successor_of(kid)
                stats["lookups"] += 1
                if local == true and net.is_alive(true):
                    stats["one_hop"] += 1
            except LookupError:
                pass
        net.schedule(lookup_dt, do_lookup)

    # -- run -----------------------------------------------------------------------
    net.run_until(cfg.warmup)
    net.reset_meters()
    net.metering = True
    net.schedule(lookup_dt, do_lookup)
    net.run_until(cfg.warmup + cfg.duration)
    net.metering = False

    total_bits = net.total_maint_out_bits()
    sum_bps = total_bits / cfg.duration
    mean_bps = sum_bps / cfg.n
    analytical = (d1ht_bandwidth(cfg.n, cfg.s_avg, cfg.f)
                  if cfg.protocol == "d1ht"
                  else calot_bandwidth(cfg.n, cfg.s_avg))
    return ChurnResult(
        cfg=cfg, params=params, events=stats["events"],
        one_hop_fraction=stats["one_hop"] / max(stats["lookups"], 1),
        sum_out_bps=sum_bps, mean_out_bps=mean_bps,
        analytical_bps=analytical,
        quarantine_admitted=stats["q_admit"],
        quarantine_skipped=stats["q_skip"],
    )
