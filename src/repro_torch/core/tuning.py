"""EDRA tuning equations (paper §III, §IV-C, §IV-D).

Every symbol follows the paper:

    n       system size (number of peers)
    S_avg   average session length (seconds)
    r       event rate (joins+leaves per second)        -- Eq III.1
    rho     ceil(log2(n)) -- number of message TTL levels
    Theta   event-buffering interval length (seconds)   -- Eq IV.2 / IV.3
    f       max acceptable fraction of routing failures (default 1%)
    T_avg   upper bound on the average acknowledge time -- Eq IV.1
    E       max number of events a peer may buffer      -- Eq IV.4

The tuning theorem is the paper's enabling insight: because every peer
learns about *every* event (it is a single-hop DHT), each peer can locally
estimate r and n and evaluate these closed forms with no coordination.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

DEFAULT_F = 0.01  # paper: "f is typically 1%"


def rho(n: int) -> int:
    """rho = ceil(log2(n)) (Rule 1)."""
    if n < 2:
        return 1
    return max(1, math.ceil(math.log2(n)))


def event_rate(n: float, s_avg: float) -> float:
    """Eq III.1: r = 2*n/S_avg (one join + one leave per session)."""
    return 2.0 * n / s_avg


def t_avg(theta: float, n: int, delta_avg: float) -> float:
    """Eq IV.1: upper bound on average acknowledge time.

    T_avg = 2*Theta (failure detection, Rule 5 worst case)
          + rho*(Theta + 2*delta_avg)/4 (per-hop buffering + delay).
    """
    return 2.0 * theta + rho(n) * (theta + 2.0 * delta_avg) / 4.0


def theta_exact(n: int, s_avg: float, f: float = DEFAULT_F,
                delta_avg: float = 0.0) -> float:
    """Eq IV.2: Theta = (2*f*S_avg - 2*rho*delta_avg)/(8 + rho).

    Derived from T_avg * r / n <= f with Eqs III.1 and IV.1.
    """
    p = rho(n)
    return max(0.0, (2.0 * f * s_avg - 2.0 * p * delta_avg) / (8.0 + p))


def theta(n: int, s_avg: float, f: float = DEFAULT_F) -> float:
    """Eq IV.3: Theta = 4*f*S_avg/(16 + 3*rho).

    The paper's practical form, assuming delta_avg = Theta/4 (an
    overestimate of measured Internet delays).
    """
    return 4.0 * f * s_avg / (16.0 + 3.0 * rho(n))


def max_buffered_events(n: int, f: float = DEFAULT_F) -> float:
    """Eq IV.4: E = 8*f*n/(16 + 3*rho) events.

    Robustness cap against event bursts; derived from Eq IV.3 with
    r = E/Theta (peers observe similar event rates).
    """
    return 8.0 * f * n / (16.0 + 3.0 * rho(n))


@dataclass(frozen=True)
class EdraParams:
    """Resolved protocol parameters for a (n, S_avg, f) operating point."""

    n: int
    s_avg: float
    f: float
    rho: int
    theta: float
    r: float
    t_detect: float  # paper §IV-C: T_detect = 2*Theta (worst case, failures)
    t_avg: float
    max_events: float

    @classmethod
    def derive(cls, n: int, s_avg: float, f: float = DEFAULT_F) -> "EdraParams":
        th = theta(n, s_avg, f)
        return cls(
            n=n,
            s_avg=s_avg,
            f=f,
            rho=rho(n),
            theta=th,
            r=event_rate(n, s_avg),
            t_detect=2.0 * th,
            t_avg=t_avg(th, n, delta_avg=th / 4.0),
            max_events=max_buffered_events(n, f),
        )

    def retune(self, observed_n: int, observed_r: float) -> "EdraParams":
        """Self-organization: re-derive Theta from locally observed n and r.

        Eq III.1 inverted gives the implied S_avg; every peer can do this
        independently because it sees all events (paper §IV-D).
        """
        s_avg = 2.0 * observed_n / max(observed_r, 1e-12)
        return EdraParams.derive(observed_n, s_avg, self.f)


# Session lengths measured by the studies the paper cites (§VIII).
SESSION_LENGTHS_MIN = {
    "datacenter-stress": 60,   # "more dynamic scenario" used in §VII
    "kad": 169,                # Steiner et al. [50]
    "gnutella": 174,           # Saroiu et al. [49]
    "bittorrent": 780,         # Andrade et al. [2]
}
