"""Shared churn-experiment shapes (paper §VII methodology).

``ChurnConfig`` / ``ChurnResult`` / ``SessionDist`` are the single
definition of a §VII churn run, a copy of ``repro.core.churn``.  The
port's vectorized plane (``core.sim.simulate_churn``) consumes them, as
``repro``'s message-level DES and vectorized plane do, so the parity
tests drive both packages from one config and compare their
``ChurnResult``s field by field.  Framework-free: no torch, no numpy at
import.
"""
from __future__ import annotations

import math
import random
from dataclasses import dataclass
from typing import Dict, Optional


# ---------------------------------------------------------------------------
# Session-length distributions (§V: P2P sessions are heavy-tailed)
# ---------------------------------------------------------------------------

class SessionDist:
    """Exponential by default; ``volatile_fraction`` mixes in short
    (< t_q) sessions to model the heavy tail head (24% KAD / 31% Gnutella
    sessions under 10 min)."""

    def __init__(self, s_avg: float, volatile_fraction: float = 0.0,
                 t_q: float = 600.0):
        self.s_avg = s_avg
        self.vol = volatile_fraction
        self.t_q = t_q
        if volatile_fraction > 0.0:
            short_mean = t_q / 2.0
            self.long_mean = (s_avg - volatile_fraction * short_mean) / (
                1.0 - volatile_fraction)
        else:
            self.long_mean = s_avg

    def sample(self, rng: random.Random) -> float:
        if self.vol > 0.0 and rng.random() < self.vol:
            return rng.uniform(0.0, self.t_q)
        return rng.expovariate(1.0 / self.long_mean)

    def sample_array(self, rng, size: int):
        """Vectorized twin of ``sample`` for a numpy Generator."""
        import numpy as np
        long = rng.exponential(self.long_mean, size=size)
        if self.vol <= 0.0:
            return long
        short = rng.uniform(0.0, self.t_q, size=size)
        return np.where(rng.random(size) < self.vol, short, long)


# ---------------------------------------------------------------------------
# Experiment config / result
# ---------------------------------------------------------------------------

@dataclass
class ChurnConfig:
    n: int
    s_avg: float                  # seconds
    protocol: str = "d1ht"        # "d1ht" | "calot"
    duration: float = 1800.0      # metered window (paper: 30 min)
    warmup: float = 300.0
    delay: Optional[object] = None  # a DES DelayModel (duck-typed)
    seed: int = 0
    rejoin_delay: float = 180.0   # paper: rejoin in 3 minutes, same ID
    crash_fraction: float = 0.5   # paper: half the leaves are SIGKILL
    lookup_samples: int = 4000
    quarantine_tq: Optional[float] = None
    volatile_fraction: float = 0.0
    f: float = 0.01


@dataclass
class ChurnResult:
    cfg: ChurnConfig
    params: object                # core.tuning.EdraParams
    events: int
    one_hop_fraction: float
    sum_out_bps: float            # Σ over peers (Figs 3-4 plot the sum)
    mean_out_bps: float
    analytical_bps: float         # per-peer model prediction
    quarantine_admitted: int = 0
    quarantine_skipped: int = 0
    mean_ack_s: float = 0.0       # vectorized plane only (0.0 from the DES)
    p99_ack_s: float = 0.0

    @property
    def stale_fraction(self) -> float:
        """Expected fraction of routing-table entries a random lookup
        finds stale (1 - one-hop fraction) — the f' the request-latency
        plane consumes, measured rather than assumed (paper §IV-D ties
        lookup retries to exactly this staleness)."""
        return max(0.0, 1.0 - self.one_hop_fraction)

    def summary(self) -> Dict[str, float]:
        return {
            "n": self.cfg.n,
            "protocol": self.cfg.protocol,
            "events": self.events,
            "one_hop_fraction": round(self.one_hop_fraction, 5),
            "mean_out_bps": round(self.mean_out_bps, 1),
            "sum_out_kbps": round(self.sum_out_bps / 1000.0, 1),
            "analytical_bps": round(self.analytical_bps, 1),
            "ratio_sim_over_model": round(
                self.mean_out_bps / max(self.analytical_bps, 1e-9), 3),
        }


def delay_mean_seconds(delay: Optional[object]) -> float:
    """Mean one-way delay of a DelayModel without importing the DES.

    Duck-typed on the two models the DES defines: ``LanDelay`` exposes
    ``mean`` (shifted exponential whose total mean IS ``mean``);
    ``WanDelay`` exposes ``mu``/``sigma`` (lognormal, mean =
    exp(mu + sigma^2/2)).  ``None`` means the DES default (LAN)."""
    if delay is None:
        return 70e-6
    if hasattr(delay, "mean"):
        return float(delay.mean)
    if hasattr(delay, "mu") and hasattr(delay, "sigma"):
        return float(math.exp(delay.mu + delay.sigma ** 2 / 2.0))
    raise TypeError(f"cannot derive a mean delay from {delay!r}")
