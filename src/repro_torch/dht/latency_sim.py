"""Measured request-latency plane — D1HT vs a directory server under
load (paper §VII-D, Figs 5-6).

A copy of ``repro.dht.latency_sim`` on the port's parts.
``dht.latency`` keeps the closed-form oracle; this module MEASURES
the same experiment from the repo's own components instead of
hand-calibrated constants:

  * **routing cost** — timed batched ``RingState.lookup`` calls through
    the ``ring_lookup_bucketed`` CUDA kernel K2 (the origin peer's
    local table walk; the flat ``ring_lookup64`` kernel K1 below the
    bucket threshold);
  * **directory-server capacity** — one local ``DirectoryWorker``
    (socket-backed recv -> SHA-1 hash -> successor bisect -> reply loop)
    saturated until its completion rate is service-bound, reproducing
    the paper's Cluster-B 1,600-client saturation methodology instead of
    hardcoding ``DSERVER_SAT_CLIENTS``;
  * **single-hop target service** — the same saturation measurement for
    a ``PeerWorker`` (the owner answers from its local store);
  * **stale-table retries** — the f' fraction is NOT a free parameter:
    it is the ``stale_fraction`` (1 - one-hop fraction) the churn
    plane measures for the same ring size and §VII session dynamics
    (``core.sim.simulate_churn``, kernel K4), per protocol.

Every function that builds a ``RingState`` or runs the churn plane takes
``device=``: ``None`` means the card (raises without one), ``"cpu"`` the
kernels' plain versions.

A vectorized closed-loop load generator then plays the experiment in
simulated time: n clients, each thinking Exp(1/lookup_rate) between
lookups over a ``window_s``-second measurement window; network legs are
sampled from the DES ``LanDelay`` shape (10 us floor + exponential
tail, 70 us one-way mean = the 0.14 ms measured hop); the directory
server is an explicit FCFS queue over the measured service time.  Past
saturation the closed population bounds the backlog — sojourns converge
to n*S - Z by Little's law with a permanently busy server — which is
exactly the regime the closed-form ``dserver_ms`` caps with its
finite-window term, so measured and model stay comparable on BOTH sides
of the knee.
"""
from __future__ import annotations

import math
import socket
import struct
import time
from bisect import bisect_left
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..core.ring import hash_id
from ..core.ringstate import RingState

from .latency import (DSERVER_WINDOW_S, HOP_MS_IDLE, LOOKUPS_PER_SEC,
                      RETRY_PENALTY_MS, busy_factor, latency_sweep)

# Network legs share the DES LanDelay shape: a 10 us switching/NIC floor
# plus an exponential tail, total one-way mean 70 us (= 0.14 ms RTT, the
# paper's measured one-hop latency that HOP_MS_IDLE encodes).
HOP_ONE_WAY_S = HOP_MS_IDLE * 1e-3 / 2.0
HOP_FLOOR_S = 10e-6

PASTRY_BASE = 4              # Chimera routes with base-4 digits


# ---------------------------------------------------------------------------
# Local workers + the saturation measurement (§VII-D methodology)
# ---------------------------------------------------------------------------

class DirectoryWorker:
    """The directory server's request handler.

    A lookup datagram carries the session id as the key VALUE (a
    string): the server must hash it onto the ring (SHA-1, as every peer
    would), resolve the successor on its full sorted peer table and
    reply (key, owner).  Deliberately the paper's baseline — one
    single-threaded process with a plain sorted table — NOT our
    device-resident lookup plane; the comparison is the point."""

    def __init__(self, ids: Sequence[int]):
        self.ids: List[int] = sorted(int(i) for i in ids)

    def handle(self, datagram: bytes) -> bytes:
        key = hash_id(f"session/{datagram.decode()}")
        i = bisect_left(self.ids, key)
        owner = self.ids[i % len(self.ids)]
        return struct.pack("!QQ", key, owner)


class PeerWorker:
    """The single-hop target: the owner peer holds the key locally and
    answers from its in-memory store (one hashtable get)."""

    def __init__(self, entries: int = 4096):
        self.store: Dict[str, int] = {f"s{i}": i for i in range(entries)}
        self.entries = entries

    def handle(self, datagram: bytes) -> bytes:
        sid = datagram.decode()
        return struct.pack("!Q", self.store.get(sid, 0))


def measure_worker_service_us(worker, *, requests: int = 20_000,
                              repeats: int = 5, chunk: int = 48) -> float:
    """Service time of one saturated local worker (microseconds/request).

    The paper saturated the directory server by ramping clients until
    its completion rate stopped rising; locally the equivalent is
    keeping the worker's inbound socket non-empty and timing ONLY the
    worker loop (recv -> handle -> send): ``chunk`` datagrams are
    pre-queued, the drain is timed, replies are drained outside the
    timed region.  Best-of-``repeats`` — a loaded host can only slow
    the worker down, never speed it up, so several shortish repeats
    sampling different time windows beat one long one under noisy
    neighbours.  Falls back to a socketless handler loop on platforms
    without AF_UNIX datagram pairs."""
    reqs = [f"client-{i}-session-{i % 997}".encode() for i in range(2048)]
    if not hasattr(socket, "AF_UNIX"):        # pragma: no cover
        best = math.inf
        for _ in range(repeats):
            t0 = time.perf_counter()
            for i in range(requests):
                worker.handle(reqs[i % len(reqs)])
            best = min(best, time.perf_counter() - t0)
        return best / requests * 1e6

    best = math.inf
    for _ in range(repeats):
        a, b = socket.socketpair(socket.AF_UNIX, socket.SOCK_DGRAM)
        sink_rx, sink_tx = socket.socketpair(socket.AF_UNIX,
                                             socket.SOCK_DGRAM)
        try:
            busy = 0.0
            done = 0
            while done < requests:
                k = min(chunk, requests - done)
                for i in range(k):
                    a.send(reqs[(done + i) % len(reqs)])
                t0 = time.perf_counter()      # k requests queued: the
                for _ in range(k):            # worker never idles here
                    sink_tx.send(worker.handle(b.recv(512)))
                busy += time.perf_counter() - t0
                for _ in range(k):
                    sink_rx.recv(512)         # drain outside the timing
                done += k
            best = min(best, busy / requests)
        finally:
            for s in (a, b, sink_rx, sink_tx):
                s.close()
    return best * 1e6


def _random_ring(n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.unique(rng.integers(1, 2**63, n * 9 // 8 + 8,
                                  dtype=np.uint64))[:n]


def measure_route_us_per_key(n: int, *, batch: int = 2048,
                             repeats: int = 3, seed: int = 0,
                             device=None) -> float:
    """Per-key cost of the origin's LOCAL table walk: batched
    ``RingState.lookup`` (``ring_lookup_bucketed`` at scale), timed
    best-of-``repeats`` after a warmup call absorbs the build + upload.
    Each lookup reads its owners back, so the host clock covers the
    device work."""
    state = RingState(_random_ring(n, seed), device=device)
    rng = np.random.default_rng(seed + 1)
    keys = rng.integers(0, 2**63, batch, dtype=np.uint64)
    state.lookup(keys)                         # warmup: build + upload
    best = math.inf
    for _ in range(repeats):
        t0 = time.perf_counter()
        state.lookup(keys)
        best = min(best, time.perf_counter() - t0)
    return best / batch * 1e6


@dataclass(frozen=True)
class ServiceProfile:
    """Everything the load generator needs that was MEASURED, not
    assumed, on this host."""

    route_us_per_key: float       # batched ring_lookup per-key walk
    dserver_service_us: float     # saturated DirectoryWorker
    peer_service_us: float        # saturated PeerWorker
    table_n: int                  # directory table size measured against
    requests: int                 # saturation requests per worker

    @property
    def dserver_mu(self) -> float:
        """Directory-server service rate (requests/s)."""
        return 1e6 / self.dserver_service_us

    def saturation_clients(self,
                           lookup_rate: float = LOOKUPS_PER_SEC) -> float:
        """The measured twin of DSERVER_SAT_CLIENTS: how many closed-loop
        clients at ``lookup_rate`` saturate the measured worker."""
        return self.dserver_mu / lookup_rate


def measure_profile(*, table_n: int = 4000, requests: int = 20_000,
                    repeats: int = 5, seed: int = 0,
                    route_batch: int = 2048, device=None) -> ServiceProfile:
    # workers before the route timing: the kernel warmup can spin up
    # thread pools that perturb a concurrent socket-loop sample
    dserver_us = measure_worker_service_us(
        DirectoryWorker(_random_ring(table_n, seed)),
        requests=requests, repeats=repeats)
    peer_us = measure_worker_service_us(
        PeerWorker(), requests=requests, repeats=repeats)
    return ServiceProfile(
        route_us_per_key=measure_route_us_per_key(
            table_n, batch=route_batch, repeats=repeats, seed=seed,
            device=device),
        dserver_service_us=dserver_us,
        peer_service_us=peer_us,
        table_n=table_n, requests=requests)


# ---------------------------------------------------------------------------
# Churn-emergent retry fraction (the churn plane, kernel K4)
# ---------------------------------------------------------------------------

def measured_retry_fraction(n: int, *, protocol: str = "d1ht",
                            s_avg: float = 174 * 60.0,
                            duration: float = 600.0, warmup: float = 120.0,
                            seed: int = 0,
                            volatile_fraction: float = 0.0,
                            device=None) -> float:
    """f' for ``protocol`` at ring size n, emergent from the vectorized
    churn plane: the expected stale-routing-entry fraction a random
    lookup hits (1 - one-hop fraction) under live EDRA dissemination —
    NOT the 0.01 free parameter of the closed form."""
    from ..core.churn import ChurnConfig
    from ..core.sim import simulate_churn
    r = simulate_churn(ChurnConfig(
        n=n, s_avg=s_avg, protocol=protocol, duration=duration,
        warmup=warmup, seed=seed, volatile_fraction=volatile_fraction),
        device=device)
    return r.stale_fraction


# ---------------------------------------------------------------------------
# Vectorized closed-loop generator
# ---------------------------------------------------------------------------

def _one_way(rng, size: int) -> np.ndarray:
    """One-way network leg, LanDelay-shaped (seconds)."""
    return HOP_FLOOR_S + rng.exponential(HOP_ONE_WAY_S - HOP_FLOOR_S, size)


def closed_loop_fcfs(rng, *, clients: int, think_s: float, service_s: float,
                     window_s: float, slice_s: Optional[float] = None,
                     max_requests: int = 5_000_000) -> np.ndarray:
    """Time-sliced vectorized closed-loop FCFS single server.

    Every client cycles think -> request -> (queue + service) -> think;
    service is the measured deterministic time.  Time advances in
    slices much shorter than the think time: a slice's arrivals are
    served in exact FCFS order with a vectorized Lindley recursion
    (``d_j = max(d_{j-1}, a_j) + S`` unrolled as a running max), and the
    server's busy horizon carries across slices, so cross-slice order is
    exact too.  The single approximation: a client whose think time
    expires INSIDE the current slice re-arrives at the slice boundary —
    an arrival-time shift bounded by ``slice_s`` (default think/16),
    which biases neither the sojourn measurement nor the offered load.

    Returns the sojourn time (queue wait + service, seconds) of every
    request that arrived inside the window."""
    slice_s = slice_s if slice_s is not None else think_s / 16.0
    t = rng.exponential(think_s, clients)      # desynchronized arrivals
    free = 0.0
    out: List[np.ndarray] = []
    total = 0
    t0 = 0.0
    while t0 < window_s and total < max_requests:
        t1 = t0 + slice_s
        idx = np.nonzero((t >= t0) & (t < t1))[0]
        if idx.size:
            sel = idx[np.argsort(t[idx], kind="stable")]
            a = t[sel]
            k = np.arange(a.size)
            d = service_s * (k + 1) + np.maximum.accumulate(
                np.maximum(a, free) - k * service_s)
            out.append(d - a)
            total += a.size
            free = float(d[-1])
            # re-arrivals that would land inside this slice defer to its
            # boundary (they were not in ``idx`` and must not be lost)
            t[sel] = np.maximum(d + rng.exponential(think_s, a.size), t1)
        t0 = t1
    return np.concatenate(out) if out else np.zeros(0)


def measured_route_samples(state: RingState, rng, requests: int,
                           batch: int = 4096) -> np.ndarray:
    """Per-request route times (seconds) from driving REAL batched
    lookups through ``state`` — ``ring_lookup_bucketed`` on the
    state's device at scale — with the measured per-batch wall time
    (each lookup reads its owners back) spread across the batch.  Measured once per experiment row and shared by every
    single-hop protocol (the route walk does not depend on f')."""
    route_s = np.empty(requests)
    keys = rng.integers(0, 2**63, requests, dtype=np.uint64)
    state.lookup(keys[:min(batch, requests)])  # warmup: build + upload
    for lo in range(0, requests, batch):
        hi = min(lo + batch, requests)
        t0 = time.perf_counter()
        state.lookup(keys[lo:hi])
        route_s[lo:hi] = (time.perf_counter() - t0) / (hi - lo)
    return route_s


def simulate_single_hop(rng, *, requests: int, retry_fraction: float,
                        service_us: float, busy_mult: float,
                        route_us_per_key: float = 0.0,
                        route_s: Optional[np.ndarray] = None,
                        state: Optional[RingState] = None,
                        batch: int = 4096) -> np.ndarray:
    """D1HT / 1h-Calot: local table walk + one acked network hop, retry
    (timeout + second hop) for the stale-table fraction.

    ``route_s`` carries pre-measured per-request route times (see
    ``measured_route_samples``); with ``state`` instead, the generator
    measures them here; otherwise the profiled ``route_us_per_key``
    stands in (model-extended rows)."""
    r = requests
    if route_s is not None:
        assert route_s.size == r
    elif state is not None:
        route_s = measured_route_samples(state, rng, r, batch)
    else:
        route_s = np.full(r, route_us_per_key * 1e-6)
    svc = service_us * 1e-6 * busy_mult
    lat = route_s + (_one_way(rng, r) + _one_way(rng, r)) * busy_mult + svc
    retry = np.nonzero(rng.random(r) < retry_fraction)[0]
    lat[retry] += RETRY_PENALTY_MS * 1e-3 + svc + (
        _one_way(rng, retry.size) + _one_way(rng, retry.size)) * busy_mult
    return lat


def simulate_pastry(rng, *, requests: int, n: int, service_us: float,
                    busy_mult: float, base: int = PASTRY_BASE) -> np.ndarray:
    """Multi-hop baseline: log_base(n) chained acked exchanges (Chimera
    acks per overlay hop), each a full request-hop: two network legs
    plus the hop peer's processing."""
    h = max(1.0, math.log(max(n, 2)) / math.log(base))
    hops = np.full(requests, int(h), np.int64)
    hops += rng.random(requests) < (h - int(h))   # mean exactly h
    lat = np.zeros(requests)
    svc = service_us * 1e-6 * busy_mult
    for i in range(int(np.max(hops))):
        m = np.nonzero(hops > i)[0]
        lat[m] += (_one_way(rng, m.size) + _one_way(rng, m.size)) \
            * busy_mult + svc
    return lat


def simulate_dserver(rng, *, clients: int, service_us: float,
                     busy_mult: float, window_s: float = DSERVER_WINDOW_S,
                     lookup_rate: float = LOOKUPS_PER_SEC) -> np.ndarray:
    """Directory server: closed-loop FCFS queue at the measured service
    rate plus the request/reply legs.  The server runs on its own node;
    the busy co-scheduling penalty hits the client-side network stack
    (exactly what the closed form applies it to)."""
    soj = closed_loop_fcfs(rng, clients=clients, think_s=1.0 / lookup_rate,
                           service_s=service_us * 1e-6, window_s=window_s)
    return soj + (_one_way(rng, soj.size) + _one_way(rng, soj.size)) \
        * busy_mult


# ---------------------------------------------------------------------------
# The experiment runner (Figs 5-6 rows)
# ---------------------------------------------------------------------------

def stats_ms(lat_s: np.ndarray) -> Dict[str, float]:
    ms = np.asarray(lat_s) * 1e3
    return {
        "mean_ms": round(float(ms.mean()), 4),
        "p50_ms": round(float(np.percentile(ms, 50)), 4),
        "p99_ms": round(float(np.percentile(ms, 99)), 4),
        "p999_ms": round(float(np.percentile(ms, 99.9)), 4),
        "requests": int(ms.size),
    }


def latency_point(n: int, *, busy: bool, profile: ServiceProfile,
                  fprime: Dict[str, float], nodes: int = 400,
                  window_s: float = DSERVER_WINDOW_S,
                  lookup_rate: float = LOOKUPS_PER_SEC,
                  requests: int = 200_000, seed: int = 0,
                  drive_kernel: bool = True, device=None) -> dict:
    """One measured Figs-5/6 row: all four systems at ring size n, plus
    the closed-form oracle evaluated AT the measured parameters and the
    per-system measured/model ratio."""
    rng = np.random.default_rng((seed << 8) ^ n ^ (1 << 20 if busy else 0))
    ppn = n / nodes
    bf = busy_factor(busy, ppn)
    # one set of real kernel drives per row, shared by both single-hop
    # protocols: the route walk is identical, only f' differs
    route_s = measured_route_samples(
        RingState(_random_ring(n, seed), device=device), rng, requests) \
        if drive_kernel else None

    model = latency_sweep(
        [n], busy=busy, nodes=nodes, mu=profile.dserver_mu,
        window_s=window_s, lookup_rate=lookup_rate,
        d1ht_f=fprime["d1ht"], calot_f=fprime["calot"])[n]
    measured = {
        "d1ht": simulate_single_hop(
            rng, requests=requests, retry_fraction=fprime["d1ht"],
            service_us=profile.peer_service_us, busy_mult=bf,
            route_us_per_key=profile.route_us_per_key, route_s=route_s),
        "calot": simulate_single_hop(
            rng, requests=requests, retry_fraction=fprime["calot"],
            service_us=profile.peer_service_us, busy_mult=bf,
            route_us_per_key=profile.route_us_per_key, route_s=route_s),
        "pastry": simulate_pastry(
            rng, requests=requests, n=n,
            service_us=profile.peer_service_us, busy_mult=bf),
        "dserver": simulate_dserver(
            rng, clients=n, service_us=profile.dserver_service_us,
            busy_mult=bf, window_s=window_s, lookup_rate=lookup_rate),
    }
    util = n * lookup_rate / profile.dserver_mu
    row = {
        "n": n, "busy": busy, "peers_per_node": round(ppn, 2),
        "mode": "measured",
        "retry_fraction": {k: round(v, 5) for k, v in fprime.items()},
        "dserver_util": round(util, 4),
        "sub_saturation": bool(util < 0.9),
        "systems": {},
    }
    for name, lat in measured.items():
        model_ms = getattr(model, f"{name}_ms")
        st = stats_ms(lat)
        st["model_ms"] = round(model_ms, 4)
        st["ratio_measured_over_model"] = round(
            st["mean_ms"] / max(model_ms, 1e-9), 3)
        row["systems"][name] = st
    return row


def model_extended_point(n: int, *, busy: bool, profile: ServiceProfile,
                         fprime: Dict[str, float], nodes: int = 400,
                         window_s: float = DSERVER_WINDOW_S,
                         lookup_rate: float = LOOKUPS_PER_SEC) -> dict:
    """Closed-form-only row for the n = 10^4..10^6 extension (the paper
    could only model this regime too), evaluated at the MEASURED worker
    rate and churn-emergent f' so the extension is anchored to the same
    parameters as the measured rows."""
    pt = latency_sweep([n], busy=busy, nodes=nodes, mu=profile.dserver_mu,
                       window_s=window_s, lookup_rate=lookup_rate,
                       d1ht_f=fprime["d1ht"], calot_f=fprime["calot"])[n]
    util = n * lookup_rate / profile.dserver_mu
    return {
        "n": n, "busy": busy, "peers_per_node": round(n / nodes, 2),
        "mode": "model-extended",
        "retry_fraction": {k: round(v, 5) for k, v in fprime.items()},
        "dserver_util": round(util, 4),
        "sub_saturation": bool(util < 0.9),
        "systems": {name: {"model_ms": round(getattr(pt, f"{name}_ms"), 4)}
                    for name in ("d1ht", "calot", "pastry", "dserver")},
    }


def latency_experiment(sizes: Sequence[int], *, busy: bool,
                       profile: Optional[ServiceProfile] = None,
                       nodes: int = 400,
                       window_s: float = DSERVER_WINDOW_S,
                       lookup_rate: float = LOOKUPS_PER_SEC,
                       requests: int = 200_000, seed: int = 0,
                       churn: bool = True, churn_duration: float = 600.0,
                       churn_warmup: float = 120.0,
                       fprime: Optional[Dict[str, float]] = None,
                       drive_kernel: bool = True,
                       device=None) -> List[dict]:
    """The full measured sweep for one regime (idle or busy).

    ``churn=True`` measures f' per (n, protocol) from the vectorized
    churn plane; ``fprime`` overrides it (tests inject known values).
    """
    profile = profile if profile is not None else \
        measure_profile(device=device)
    rows = []
    for n in sizes:
        if fprime is not None:
            fp = dict(fprime)
        elif churn:
            fp = {p: measured_retry_fraction(
                n, protocol=p, duration=churn_duration,
                warmup=churn_warmup, seed=seed, device=device)
                for p in ("d1ht", "calot")}
        else:
            fp = {"d1ht": 0.01, "calot": 0.012}
        rows.append(latency_point(
            n, busy=busy, profile=profile, fprime=fp, nodes=nodes,
            window_s=window_s, lookup_rate=lookup_rate, requests=requests,
            seed=seed, drive_kernel=drive_kernel, device=device))
    return rows
