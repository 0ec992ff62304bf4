"""Deterministic discrete-event network simulator for the DHT protocols
(a copy of ``repro.dht.des``; pure host Python, no device work).

Message-level fidelity: every maintenance datagram (with its Fig.-2 byte
size), ack, probe and heartbeat is individually delivered with a sampled
network delay; per-peer traffic is metered exactly as §VII-A counts it
(routing-table maintenance + failure detection only; lookups and
routing-table transfers excluded).

The two experimental environments of the paper map to delay models:
  * ``LanDelay``  — HPC datacenter (§VII-C/D): ~70 us one-way.
  * ``WanDelay``  — PlanetLab (§VII-B): lognormal, ~60 ms median one-way.
  * ``GeoDelay``  — multi-datacenter generalization of both: endpoint-
    aware, sampling each datagram around the per-region-pair medians of
    a topology like ``repro.runtime.placement.Topology`` (intra-region =
    the LanDelay regime, inter-region = the WanDelay lognormal regime).
"""
from __future__ import annotations

import heapq
import math
import random
from abc import ABC, abstractmethod
from dataclasses import dataclass, field
from typing import Callable, Dict, List

from ..core.ring import RoutingTable
from .messages import V_A_BITS, TrafficMeter


# ---------------------------------------------------------------------------
# Delay models
# ---------------------------------------------------------------------------

class DelayModel(ABC):
    @abstractmethod
    def sample(self, rng: random.Random) -> float: ...

    def sample_pair(self, rng: random.Random, src: int, dst: int) -> float:
        """One-way delay for a specific (src, dst) datagram.  The base
        models are endpoint-oblivious, so the default ignores the pair;
        ``GeoDelay`` overrides it with per-region-pair distributions."""
        return self.sample(rng)


class LanDelay(DelayModel):
    """HPC datacenter: measured one-hop lookup ~0.14 ms RTT => ~70 us one-way.

    Shifted exponential: a 10 us switching/NIC floor plus an exponential
    tail whose mean is chosen so the TOTAL mean is exactly ``mean`` —
    the floor used to be added on top of an Exp(mean) draw, which
    silently inflated the realized mean to ~80 us and skewed the
    §VII-C/D delay accounting against the documented 70 us."""

    def __init__(self, mean: float = 70e-6, floor: float = 10e-6):
        if mean <= floor:
            raise ValueError(f"mean {mean} must exceed the {floor} floor")
        self.mean = mean
        self.floor = floor

    def sample(self, rng: random.Random) -> float:
        return self.floor + rng.expovariate(1.0 / (self.mean - self.floor))


class WanDelay(DelayModel):
    """PlanetLab-like WAN: lognormal one-way delay, median ~60 ms."""

    def __init__(self, median: float = 0.060, sigma: float = 0.6):
        self.mu = math.log(median)
        self.sigma = sigma

    def sample(self, rng: random.Random) -> float:
        return rng.lognormvariate(self.mu, self.sigma)


class GeoDelay(DelayModel):
    """Multi-datacenter delay keyed on a topology like
    ``repro.runtime.placement.Topology`` (duck-typed on ``names``,
    ``intra_rtt_ms``, ``one_way_ms`` and ``_origin_index`` — no import,
    so the DHT package needs no topology class of its own).

    This is the stochastic twin of the topology's deterministic RTT
    estimator: each datagram samples around the SAME per-pair one-way
    median the placement policy ranks by, so what ``LatencyAware``
    optimizes is exactly what the DES measures.

      * intra-region: shifted exponential (the ``LanDelay`` regime) with
        mean = the topology's intra one-way estimate.  With
        ``Topology.single_region()`` (0.14 ms RTT) this reproduces the
        LanDelay default (70 us mean, 10 us floor) exactly.
      * inter-region: lognormal (the ``WanDelay``/PlanetLab regime) with
        median = the topology's inter-region one-way estimate.  A tighter
        default sigma than WanDelay's 0.6: per-pair spread is residual
        jitter, not the cross-pair spread the aggregate model folds in.
    """

    def __init__(self, topology, *, sigma: float = 0.25,
                 floor: float = 10e-6):
        self.topology = topology
        self.sigma = float(sigma)
        self.floor = float(floor)

    def _intra_mean(self) -> float:
        return max(self.topology.intra_rtt_ms * 0.5e-3, 2.0 * self.floor)

    @property
    def mean(self) -> float:
        """Expected one-way delay (s) over uniformly random region pairs
        — the hook ``core.churn.delay_mean_seconds`` duck-types on."""
        names = self.topology.names
        bump = math.exp(0.5 * self.sigma * self.sigma)  # lognormal mean/median
        tot = 0.0
        for a in names:
            for b in names:
                tot += (self._intra_mean() if a == b else
                        self.topology.one_way_ms(a, b) * 1e-3 * bump)
        return tot / (len(names) ** 2)

    def sample(self, rng: random.Random) -> float:
        # endpoint-oblivious fallback: a uniformly random region pair
        names = self.topology.names
        return self.sample_pair(rng, names[rng.randrange(len(names))],
                                names[rng.randrange(len(names))])

    def sample_pair(self, rng: random.Random, src, dst) -> float:
        topo = self.topology
        if topo._origin_index(src) == topo._origin_index(dst):
            m = self._intra_mean()
            return self.floor + rng.expovariate(1.0 / (m - self.floor))
        return rng.lognormvariate(math.log(topo.one_way_ms(src, dst) * 1e-3),
                                  self.sigma)


# ---------------------------------------------------------------------------
# Network
# ---------------------------------------------------------------------------

@dataclass(order=True)
class _Scheduled:
    t: float
    seq: int
    fn: Callable[[], None] = field(compare=False)


class SimPeer(ABC):
    """Base class: a peer with an ID living in a SimNet."""

    def __init__(self, pid: int, net: "SimNet"):
        self.id = pid
        self.net = net
        self.alive = False

    @abstractmethod
    def start(self) -> None: ...

    @abstractmethod
    def stop(self, *, crash: bool) -> None: ...

    def on_datagram(self, src: int, kind: str, payload) -> None:  # pragma: no cover
        pass


class SimNet:
    def __init__(self, delay: DelayModel, seed: int = 0):
        self.delay = delay
        self.rng = random.Random(seed)
        self.now = 0.0
        self._heap: List[_Scheduled] = []
        self._seq = 0
        self.peers: Dict[int, SimPeer] = {}
        self.ring = RoutingTable([])          # ground truth: in-ring peers
        self.meters: Dict[int, TrafficMeter] = {}
        self.metering = False                 # warmup excluded (§VII-A phase 2)
        self.event_seq = 0                    # global event seq for dedup keys

    # -- scheduling ---------------------------------------------------------
    def schedule(self, dt: float, fn: Callable[[], None]) -> None:
        self.schedule_at(self.now + dt, fn)

    def schedule_at(self, t: float, fn: Callable[[], None]) -> None:
        self._seq += 1
        heapq.heappush(self._heap, _Scheduled(t, self._seq, fn))

    def run_until(self, t_end: float) -> None:
        while self._heap and self._heap[0].t <= t_end:
            item = heapq.heappop(self._heap)
            self.now = item.t
            item.fn()
        self.now = t_end

    # -- peers ---------------------------------------------------------------
    def add_peer(self, peer: SimPeer) -> None:
        self.peers[peer.id] = peer
        self.meters.setdefault(peer.id, TrafficMeter())

    def is_alive(self, pid: int) -> bool:
        p = self.peers.get(pid)
        return p is not None and p.alive

    # -- transport ------------------------------------------------------------
    def send(self, src: int, dst: int, bits: int, kind: str, payload=None,
             *, acked: bool = True, maintenance: bool = True) -> None:
        """UDP datagram with Fig-2 accounting.

        ``acked=True`` models the per-message acknowledgment (v_a bits from
        dst back to src) without a separate queue event.

        The metering decision is captured HERE, at send time, and applied
        to every leg of the exchange: a datagram in flight across the
        warmup->measurement boundary used to meter its recv and ack but
        not its send (and the converse at window close), biasing the
        §VII-A accounting at the window edges.  A datagram now counts
        all-or-nothing with its acks.
        """
        metered = self.metering
        if metered:
            m = self.meters[src]
            m.send(bits, maintenance)
        if not self.is_alive(dst):
            return  # datagram lost; retransmission is the sender's problem
        d = self.delay.sample_pair(self.rng, src, dst)

        def deliver() -> None:
            peer = self.peers.get(dst)
            if peer is None or not peer.alive:
                return
            if metered:
                self.meters[dst].recv(bits)
                if acked:
                    self.meters[dst].send(V_A_BITS, maintenance)
                    self.meters[src].recv(V_A_BITS)
            peer.on_datagram(src, kind, payload)

        self.schedule(d, deliver)

    # -- measurement -----------------------------------------------------------
    def reset_meters(self) -> None:
        for pid in self.meters:
            self.meters[pid] = TrafficMeter()

    def total_maint_out_bits(self) -> float:
        return sum(m.maint_out_bits for m in self.meters.values())
