"""Analytical maintenance-traffic models (paper §IV-E/F, §VII, §VIII).

Implements, with the paper's message formats (Fig. 2):

  * D1HT      — Eqs IV.5-IV.7 (per-peer, incoming == outgoing)
  * 1h-Calot  — Eq VII.1 (also valid for 1HS [44] and SFDHT [24], §II)
  * OneHop    — reconstruction of Fonseca et al. [17] with optimal
                topological parameters (the assumption the paper makes)
  * Quarantine — §V / §VIII overhead-reduction model

Wire constants (Fig. 2, bits, including 28-byte IPv4+UDP headers):
  v_m = 320  D1HT/OneHop maintenance message fixed part (40 bytes)
  v_c = 384  1h-Calot maintenance message (48 bytes, one event each)
  v_a = 288  acknowledgment (36 bytes)
  v_h = 288  heartbeat (36 bytes)
  m   = 32   bits per event (IPv4, default port; 48 with port number)

Note on Eq VII.1: the paper prints ``4*n*v_h/60`` for the heartbeat term;
dimensional analysis and the paper's own Fig. 7 values (1h-Calot slightly
above 140 kbps at n=1e6 with KAD dynamics) require the per-peer reading
``4*v_h/60`` (each peer sends four *unacknowledged* heartbeats per
minute).  We implement the per-peer term (see DESIGN.md §2).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

import numpy as np

from .tuning import DEFAULT_F, event_rate, rho, theta

V_M = 320   # D1HT/OneHop maintenance header bits
V_C = 384   # 1h-Calot maintenance message bits (single event)
V_A = 288   # ack bits
V_H = 288   # heartbeat bits
M_BITS = 32  # bits per event (default port)


# ---------------------------------------------------------------------------
# D1HT (Eqs IV.5 - IV.7)
# ---------------------------------------------------------------------------

def p_msg(l: int, n: int, r: float, th: float, p: int | None = None) -> float:
    """Eq IV.6: P(l) = 1 - (1 - 2*r*Theta/n)^(2^(rho-l-1))."""
    p = rho(n) if p is None else p
    k = 2.0 ** (p - l - 1)
    base = max(0.0, 1.0 - 2.0 * r * th / n)
    return 1.0 - base ** k


def n_msgs(n: int, r: float, th: float) -> float:
    """Eq IV.7: average number of maintenance messages per Theta interval."""
    p = rho(n)
    return 1.0 + sum(p_msg(l, n, r, th, p) for l in range(1, p))


def d1ht_bandwidth(n: int, s_avg: float, f: float = DEFAULT_F,
                   v_m: int = V_M, v_a: int = V_A, m: int = M_BITS) -> float:
    """Eq IV.5 per-peer maintenance traffic, bit/s (out == in).

    (N_msgs * (v_m + v_a) + r * m * Theta) / Theta
    """
    th = theta(n, s_avg, f)
    r = event_rate(n, s_avg)
    return (n_msgs(n, r, th) * (v_m + v_a) + r * m * th) / th


def d1ht_bandwidth_components(n: int, s_avg: float, f: float = DEFAULT_F) -> Dict[str, float]:
    th = theta(n, s_avg, f)
    r = event_rate(n, s_avg)
    nm = n_msgs(n, r, th)
    return {
        "theta_s": th,
        "rho": rho(n),
        "event_rate_per_s": r,
        "n_msgs_per_interval": nm,
        "header_bps": nm * (V_M + V_A) / th,
        "payload_bps": r * M_BITS,
        "total_bps": nm * (V_M + V_A) / th + r * M_BITS,
    }


# ---------------------------------------------------------------------------
# 1h-Calot (Eq VII.1; per-peer heartbeat reading — see module docstring)
# ---------------------------------------------------------------------------

def calot_bandwidth(n: int, s_avg: float, v_c: int = V_C, v_a: int = V_A,
                    v_h: int = V_H, heartbeats_per_min: float = 4.0) -> float:
    """Per-peer 1h-Calot maintenance traffic, bit/s.

    Each event reaches every peer in its own (un-aggregated) message and
    is acked: each peer therefore forwards r messages/s and sends r acks/s
    (2n messages per event system-wide), plus 4 unacked heartbeats/min.
    """
    r = event_rate(n, s_avg)
    return r * (v_c + v_a) + heartbeats_per_min * v_h / 60.0


# ---------------------------------------------------------------------------
# OneHop (reconstruction of [17] with optimal topology parameters)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class OneHopPoint:
    n: int
    s_avg: float
    f: float
    k_slices: int
    u_units: int
    unit_size: float
    t_big: float
    t_wait: float
    t_small: float
    slice_leader_bps: float
    unit_leader_bps: float
    ordinary_bps: float


def onehop_bandwidth(n: int, s_avg: float, f: float = DEFAULT_F,
                     v_m: int = V_M, v_a: int = V_A, m: int = M_BITS) -> OneHopPoint:
    """OneHop [17] per-role maintenance traffic (bit/s).

    Three-level hierarchy: k slices, u units per slice, units of
    n/(k*u) nodes.  Event flow: detector -> slice leader; slice leaders
    exchange batches every t_big; slice leader -> its u unit leaders every
    t_wait; unit leaders piggyback on keep-alives (period t_small) that
    ordinary nodes exchange with ring neighbours, so an event crosses half
    a unit in ~unit_size*t_small/8 on average (random node sits 0..size/2
    hops from the leader; each hop waits ~t_small/2).

    Topology follows the OneHop design point (k = 5*sqrt(n) slices, u = 5
    units/slice, 1 s keep-alives, 5 s unit dissemination) — the "optimal
    topological parameters" the D1HT paper grants OneHop — with t_big
    stretched to the same staleness budget D1HT uses (§IV-D):

        t_big/2 + t_wait/2 + traverse  <=  f*S_avg/2.

    Slice-leader failures are not charged (paper §VIII assumption).
    """
    r = event_rate(n, s_avg)
    k = max(2, int(math.ceil(5.0 * math.sqrt(n))))
    u = 5
    unit_size = max(1.0, n / (k * u))
    t_small = 1.0
    t_wait = 5.0
    traverse = unit_size * t_small / 8.0
    budget = f * s_avg / 2.0
    # OneHop's published design point aggregates for ~30 s at slice leaders;
    # shrink only if the staleness budget demands it (never below t_wait).
    t_big = max(t_wait, min(30.0, 2.0 * (budget - t_wait / 2.0 - traverse)))
    # slice-leader out: batches to k-1 other leaders (its slice's share of
    # events each) + aggregated batches to its u unit leaders + acks.
    inter = (k - 1) * (v_m + v_a + (r / k) * t_big * m) / t_big
    intra = u * (v_m + v_a + r * t_wait * m) / t_wait
    sl = inter + intra
    # unit leader pushes every event to both ring neighbours via keep-alives
    ul = 2.0 * (v_m + v_a) / t_small + 2.0 * r * m
    # ordinary node forwards each event once along the chain + keep-alives
    ordinary = (v_m + v_a) / t_small + r * m
    return OneHopPoint(n, s_avg, f, k, u, unit_size,
                       t_big, t_wait, t_small, sl, ul, ordinary)


# ---------------------------------------------------------------------------
# Quarantine (§V, §VIII)
# ---------------------------------------------------------------------------

def quarantine_bandwidth(n: int, s_avg: float, volatile_fraction: float,
                         f: float = DEFAULT_F) -> float:
    """Per-peer D1HT traffic with Quarantine (bit/s).

    Sessions shorter than T_q (a ``volatile_fraction`` of all sessions —
    24% for KAD, 31% for Gnutella at T_q=10 min) never enter the ring:
    their joins/leaves are not reported.  The ring holds q = (1-vol)*n
    peers and sees event rate q*r (Fig. 8 captions: q=0.76n / q=0.69n).
    """
    q = 1.0 - volatile_fraction
    n_eff = max(2, int(round(q * n)))
    return d1ht_bandwidth(n_eff, s_avg, f)


def quarantine_reduction(n: int, s_avg: float, volatile_fraction: float,
                         f: float = DEFAULT_F) -> float:
    """Fractional overhead reduction brought by Quarantine (Fig. 8)."""
    base = d1ht_bandwidth(n, s_avg, f)
    quar = quarantine_bandwidth(n, s_avg, volatile_fraction, f)
    return 1.0 - quar / base


# ---------------------------------------------------------------------------
# Convenience sweep used by benchmarks/fig7_analytical.py
# ---------------------------------------------------------------------------

def sweep(n_values, s_avg_minutes, f: float = DEFAULT_F) -> Dict[str, np.ndarray]:
    s = s_avg_minutes * 60.0
    d1 = np.array([d1ht_bandwidth(int(n), s, f) for n in n_values])
    ca = np.array([calot_bandwidth(int(n), s) for n in n_values])
    oh = [onehop_bandwidth(int(n), s, f) for n in n_values]
    return {
        "n": np.asarray(n_values, dtype=np.int64),
        "d1ht_bps": d1,
        "calot_bps": ca,
        "onehop_slice_leader_bps": np.array([o.slice_leader_bps for o in oh]),
        "onehop_unit_leader_bps": np.array([o.unit_leader_bps for o in oh]),
        "onehop_ordinary_bps": np.array([o.ordinary_bps for o in oh]),
    }
