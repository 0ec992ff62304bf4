"""Vectorized EDRA simulators of the port (torch), the counterpart of
``repro.core.jax_sim``.

Simulates event dissemination over a D1HT ring at protocol granularity
— per-event, per-peer acknowledge times following the exact EDRA tree
(binomial offsets, per-hop interval flushes, message delays, Rule-8
truncation) — without materializing individual messages.  Two entry
points:

  * ``simulate(SimConfig)`` — the fixed-n plane: dense (E, n)
    event-by-peer matrices, exact per-peer metering, 10^4..10^5 peers.
    Its randomness comes from a ``torch.Generator`` on the device, so
    its numbers differ from ``repro``'s ``jax.random`` draws: the two
    planes agree statistically.
  * ``simulate_churn(ChurnConfig)`` — the §VII measurement at the
    paper's Internet scale (n up to 10^6-10^7): continuous join/leave/
    crash churn with Quarantine admission, D1HT vs 1h-Calot, per-peer
    maintenance bandwidth and one-hop metering.  Everything drawn from
    ``np.random.default_rng(cfg.seed)`` is drawn exactly as ``repro``
    draws it, in the same order, so the event stream and the (event,
    observer) pairs are ``repro``'s own.  The pairs then live on the
    device: kernel K4 (``kernels.edra_tree``) evaluates their ancestor
    chains in chunks written straight into full-size output buffers,
    and the §VII-A metering runs on the device; only scalars and (M,)
    vectors come back.

Model notes
-----------
* Peers have asynchronous Theta intervals (random phases).
* A peer that acknowledges an event at time t forwards it at its next
  interval boundary; all children of that flush share the flush instant
  and draw independent network delays (exponential with mean delta_avg).
* Failures (half of leaves, as in §VII-A) are detected after
  U(Theta, 2*Theta) — one missed TTL-0 message plus the probe (Rule 5);
  joins and voluntary leaves are announced immediately.
* A routing-table entry is stale from the instant the event happens until
  the observing peer acknowledges it; a random-target lookup fails with
  probability (#stale entries)/n (paper §IV-D).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from ..kernels.backend import resolve_device
from ..kernels.edra_tree.ops import edra_tree
from ..kernels.edra_tree.ref import popcount32
from .analysis import (M_BITS, V_A, V_C, V_H, V_M, calot_bandwidth,
                       d1ht_bandwidth)
from .churn import ChurnConfig, ChurnResult, SessionDist, delay_mean_seconds
from .tuning import EdraParams

_M32 = 0xFFFFFFFF


@dataclass(frozen=True)
class SimConfig:
    n: int                      # ring size (held constant; leave+rejoin churn)
    s_avg: float                # average session length, seconds
    duration: float = 1800.0    # measurement window, seconds (paper: 30 min)
    f: float = 0.01
    delta_avg: float = 0.050    # mean one-way message delay, seconds
    failure_fraction: float = 0.5   # of leaves detected via Rule 5 (§VII-A)
    lookups: int = 4096         # lookup samples for the one-hop fraction
    seed: int = 0


@dataclass
class SimResult:
    params: EdraParams
    num_events: int
    one_hop_fraction: float
    mean_ack_time: float
    p99_ack_time: float
    theorem1_bound: float       # rho*Theta/2 + detection & delay allowances
    mean_out_bps: float
    p95_out_bps: float
    analytical_bps: float
    per_peer_out_bps: np.ndarray

    def summary(self) -> Dict[str, float]:
        return {
            "n": self.params.n,
            "theta_s": self.params.theta,
            "events": self.num_events,
            "one_hop_fraction": self.one_hop_fraction,
            "mean_ack_s": self.mean_ack_time,
            "p99_ack_s": self.p99_ack_time,
            "t_avg_bound_s": self.theorem1_bound,
            "mean_out_bps": self.mean_out_bps,
            "p95_out_bps": self.p95_out_bps,
            "analytical_bps": self.analytical_bps,
        }


def _trailing_zeros(x: torch.Tensor) -> torch.Tensor:
    """Trailing zeros of int64 values in [1, 2^32)."""
    return popcount32(((x & -x) - 1) & _M32)


def _simulate_core(gen: torch.Generator, *, n: int, rho: int,
                   num_events: int, num_lookups: int, num_intervals: int,
                   theta: float, duration: float, delta_avg: float,
                   failure_fraction: float, device: torch.device):
    def rand(*shape):
        return torch.rand(shape, generator=gen, device=device)

    # --- events ------------------------------------------------------------
    t_event = torch.sort(rand(num_events) * duration).values
    reporter = torch.randint(0, n, (num_events,), generator=gen,
                             device=device)                 # ring index of P
    is_failure = rand(num_events) < failure_fraction
    detect_extra = torch.where(is_failure, theta + rand(num_events) * theta,
                               0.0)                         # U(Θ, 2Θ)
    t_detect = t_event + detect_extra

    # --- per-peer interval phases -------------------------------------------
    phase = rand(n) * theta

    def next_flush(t, ph):
        """First interval boundary of a peer with phase ph strictly after t."""
        return ph + torch.ceil((t - ph) / theta + 1e-9) * theta

    # --- exact tree propagation ---------------------------------------------
    # offsets[e, j] = clockwise offset of peer j from event e's reporter
    peers = torch.arange(n, device=device)
    offsets = (peers[None, :] - reporter[:, None]) % n          # (E, n)
    ttl = torch.where(offsets == 0, rho, _trailing_zeros(offsets))
    depth = popcount32(offsets)
    parent = offsets & (offsets - 1)                            # (E, n)
    parent_peer = (parent + reporter[:, None]) % n              # ring index
    parent_phase = phase[parent_peer]

    delays = torch.empty((num_events, n), device=device).exponential_(
        generator=gen) * delta_avg

    # iterate depth levels: ack[d] = flush(ack[parent]) + delay
    ack = torch.where(offsets == 0, t_detect[:, None], float("inf"))
    for d in range(1, rho + 1):
        # columns of ``ack`` are ring indices; the tree parent of the peer
        # in column j sits at ring index parent_peer[e, j]
        parent_ack = torch.gather(ack, 1, parent_peer)
        t = next_flush(parent_ack, parent_phase) + delays
        ack = torch.where((depth == d) & (offsets != 0), t, ack)
    ack_rel = ack - t_event[:, None]                            # ack latency

    # --- one-hop lookup fraction --------------------------------------------
    t_lookup = rand(num_lookups) * duration
    origin = torch.randint(0, n, (num_lookups,), generator=gen, device=device)
    # stale[e, l] = event e happened before lookup l but origin not yet acked
    ev_before = t_event[:, None] <= t_lookup[None, :]
    not_acked = ack[:, origin] > t_lookup[None, :]
    stale_counts = (ev_before & not_acked).sum(dim=0)           # per lookup
    one_hop = 1.0 - (stale_counts / n).mean()

    # --- maintenance traffic --------------------------------------------------
    # message M(l>=1) sent by peer j at interval k iff it acked an event with
    # TTL >= l+1 during k (Rules 3-4).  TTL-0 messages are always sent.
    k_idx = torch.floor((ack - phase[None, :]) / theta).long().clamp(
        0, num_intervals - 1)
    in_window = ack < duration
    flat_jk = peers[None, :] * num_intervals + k_idx            # (E, n)

    ttl0 = float(np.floor(duration / theta))
    msgs_sent = torch.full((n,), ttl0, dtype=torch.float64, device=device)
    msgs_recv = msgs_sent.clone()          # the roll of a constant vector
    for l in range(1, rho):
        mark = torch.zeros(n * num_intervals, dtype=torch.bool, device=device)
        mark[flat_jk[(ttl >= l + 1) & in_window]] = True
        sent = mark.view(n, num_intervals).sum(dim=1)           # per peer
        msgs_sent += sent
        # receivers: M(l) from j arrives at j + 2^l (ring)
        msgs_recv += torch.roll(sent, 1 << l)

    # payload: event acked with TTL=t is re-sent in messages l < t whose
    # target offset + 2^l stays inside the ring (Rule 8).
    payload = torch.zeros(n, dtype=torch.int64, device=device)
    for l in range(rho):
        payload += ((l < ttl) & (offsets + (1 << l) < n)
                    & in_window).sum(dim=0)
    out_bits = msgs_sent * V_M + msgs_recv * V_A + payload * M_BITS
    return one_hop, ack_rel, out_bits / duration


def simulate(cfg: SimConfig, *, device=None) -> SimResult:
    """The fixed-n plane (``repro.core.jax_sim.simulate``) on torch:
    ``device=None`` means the card (raises without one)."""
    device = resolve_device(device)
    params = EdraParams.derive(cfg.n, cfg.s_avg, cfg.f)
    num_events = max(1, int(round(params.r * cfg.duration)))
    if num_events * cfg.n > 6e7:
        raise ValueError(
            f"sim too large: events({num_events}) x n({cfg.n}) — shrink duration")
    num_intervals = int(np.ceil(cfg.duration / params.theta)) + 2

    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    one_hop, ack_rel, out_bps = _simulate_core(
        gen, n=cfg.n, rho=params.rho, num_events=num_events,
        num_lookups=cfg.lookups, num_intervals=num_intervals,
        theta=params.theta, duration=cfg.duration,
        delta_avg=cfg.delta_avg, failure_fraction=cfg.failure_fraction,
        device=device)

    ack_np = ack_rel.cpu().numpy()
    finite = ack_np[np.isfinite(ack_np)]
    out_np = out_bps.cpu().numpy()
    return SimResult(
        params=params,
        num_events=num_events,
        one_hop_fraction=float(one_hop),
        mean_ack_time=float(finite.mean()),
        p99_ack_time=float(np.percentile(finite, 99)),
        theorem1_bound=params.t_avg,
        mean_out_bps=float(out_np.mean()),
        p95_out_bps=float(np.percentile(out_np, 95)),
        analytical_bps=d1ht_bandwidth(cfg.n, cfg.s_avg, cfg.f),
        per_peer_out_bps=out_np,
    )


# ---------------------------------------------------------------------------
# Vectorized churn plane: the §VII experiment at 10^6 peers
# ---------------------------------------------------------------------------

_CALOT_HEARTBEAT = 15.0      # four per minute (§VII-A)
_CALOT_PROBE_TIMEOUT = 5.0   # 1h-Calot probe confirmation window


def _churn_event_stream(cfg: ChurnConfig, rng):
    """Continuous join/leave/crash churn as per-peer renewal processes.

    Per-peer sessions from the §V volatile-fraction mix, half the leaves
    are crashes, leavers rejoin after ``rejoin_delay`` with the same ID,
    and — when ``quarantine_tq`` is set — a rejoin whose sampled session
    is shorter than T_q is never admitted (no events at all, retry after
    the session, §V) while admitted peers enter T_q late with the
    remainder of their session.  Vectorized over peers round by round
    (each round advances every still-active peer one alive/off cycle).

    Returns (t, kind, crash) sorted by time — kind +1 join / -1 leave,
    t the instant the ground-truth ring changes — plus quarantine
    admission counters.
    """
    horizon = cfg.warmup + cfg.duration
    sessions = SessionDist(cfg.s_avg, cfg.volatile_fraction,
                           cfg.quarantine_tq or 600.0)
    t_parts, k_parts, c_parts = [], [], []
    q_admit = q_skip = 0
    start = np.zeros(cfg.n)
    sess = sessions.sample_array(rng, cfg.n)   # initial population: no gate
    active = np.ones(cfg.n, bool)
    while active.any():
        idx = np.nonzero(active)[0]
        t_leave = start[idx] + np.maximum(sess[idx], 1.0)
        keep = t_leave <= horizon
        idx, t_leave = idx[keep], t_leave[keep]
        active[:] = False
        if not idx.size:
            break
        crash = rng.random(idx.size) < cfg.crash_fraction
        t_parts.append(t_leave)
        k_parts.append(np.full(idx.size, -1, np.int8))
        c_parts.append(crash)

        t_re = t_leave + cfg.rejoin_delay
        s_new = sessions.sample_array(rng, idx.size)
        if cfg.quarantine_tq is not None:
            tq = cfg.quarantine_tq
            while True:
                retry = (s_new <= tq) & (t_re <= horizon)
                if not retry.any():
                    break
                q_skip += int(retry.sum())
                t_re = np.where(retry, t_re + s_new + cfg.rejoin_delay, t_re)
                s_new = np.where(retry, sessions.sample_array(rng, idx.size),
                                 s_new)
            t_join = t_re + tq
            admit = (s_new > tq) & (t_join <= horizon)
            q_admit += int(admit.sum())
            s_next = np.maximum(s_new - tq, 1.0)
        else:
            t_join = t_re
            admit = t_join <= horizon
            s_next = s_new
        j = idx[admit]
        t_parts.append(t_join[admit])
        k_parts.append(np.full(j.size, 1, np.int8))
        c_parts.append(np.zeros(j.size, bool))
        start[j] = t_join[admit]
        sess[j] = s_next[admit]
        active[j] = True

    t = np.concatenate(t_parts) if t_parts else np.zeros(0)
    kind = np.concatenate(k_parts) if k_parts else np.zeros(0, np.int8)
    crash = np.concatenate(c_parts) if c_parts else np.zeros(0, bool)
    order = np.argsort(t, kind="stable")
    return t[order], kind[order], crash[order], q_admit, q_skip


def _mean_live(n0: int, t: np.ndarray, kind: np.ndarray,
               w0: float, w1: float) -> float:
    """Time-averaged live-peer count over [w0, w1] from the event stream."""
    n_after = n0 + np.cumsum(kind, dtype=np.int64)
    inside = (t > w0) & (t < w1)
    ti = t[inside]
    ni = n_after[inside]
    i0 = int(np.searchsorted(t, w0, side="right"))
    n_at_w0 = int(n_after[i0 - 1]) if i0 > 0 else n0
    edges = np.concatenate([[w0], ti, [w1]])
    vals = np.concatenate([[n_at_w0], ni])
    return float(np.sum(vals * np.diff(edges)) / max(w1 - w0, 1e-9))


def _distinct_interval_counts(slot: torch.Tensor, k_idx: torch.Tensor,
                              num_intervals: int, m: int) -> torch.Tensor:
    """Per-slot count of distinct interval indices (Rules 3-4 message
    dedup: one M(l) per interval regardless of how many events it
    carries).  slot/k_idx: (S,) int64 tensors of selected pairs."""
    flat = torch.unique(slot * num_intervals + k_idx)
    return torch.bincount(flat // num_intervals, minlength=m)


def _percentile(x: torch.Tensor, q: float) -> float:
    """``np.percentile(x, q)`` (linear interpolation, numpy's own lerp)
    of a 1-D tensor of any size (``torch.quantile`` refuses > 2^24)."""
    n = x.numel()
    vi = (n - 1) * (q / 100.0)
    lo = int(np.floor(vi))
    hi = min(lo + 1, n - 1)
    a, b = (float(v) for v in torch.sort(x).values[[lo, hi]].cpu())
    g = vi - lo
    return b - (b - a) * (1.0 - g) if g >= 0.5 else a + (b - a) * g


def simulate_churn(cfg: ChurnConfig, *, meter_peers: Optional[int] = None,
                   pair_budget: int = 24_000_000, chunk: int = 1 << 21,
                   device=None) -> ChurnResult:
    """§VII churn measurement on the vectorized plane (D1HT or 1h-Calot).

    Consumes the same ``ChurnConfig`` and returns the same
    ``ChurnResult`` as ``repro.core.jax_sim.simulate_churn``.  Metering
    follows the §VII-A accounting: per-peer outbound bits = maintenance-
    message headers sent (one M(l) per Theta interval that acknowledged
    an event with TTL > l, M(0) always) + acks for messages received +
    Rule-8-truncated event payloads; lookups and routing-table transfers
    excluded.  Per-peer quantities are measured on ``meter_peers``
    sampled observers (default: sized so event x observer pairs stay
    under ``pair_budget``); acknowledge times come from K4 in launches
    of at most ``chunk`` pairs.  ``device=None`` means the card (raises
    without one); ``device="cpu"`` runs K4's plain version.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(cfg.seed)
    params = EdraParams.derive(cfg.n, cfg.s_avg, cfg.f)
    theta = params.theta
    delta_avg = delay_mean_seconds(cfg.delay)
    calot = cfg.protocol == "calot"
    w0, w1 = cfg.warmup, cfg.warmup + cfg.duration

    t, kind, crash, q_admit, q_skip = _churn_event_stream(cfg, rng)
    n_after = np.maximum(cfg.n + np.cumsum(kind, dtype=np.int64), 2)
    nbar = _mean_live(cfg.n, t, kind, w0, w1)

    # events whose dissemination can overlap the metered window: the ack
    # tail spans detection (<= 2 Theta) + rho buffered hops
    tail = (params.rho + 2) * theta + 20.0 * delta_avg + 1.0
    if calot:
        tail = 2.5 * _CALOT_HEARTBEAT + _CALOT_PROBE_TIMEOUT \
            + (params.rho + 2) * 3.0 * delta_avg + 1.0
    sel = (t >= w0 - tail) & (t <= w1)
    t_ev = t[sel]
    crash_ev = crash[sel]
    n_ev = n_after[sel].astype(np.uint32)
    e = int(t_ev.size)
    events_in_window = int(np.sum((t >= w0) & (t <= w1)))

    if calot:
        detect = t_ev + np.where(
            crash_ev,
            1.5 * _CALOT_HEARTBEAT + rng.uniform(0, _CALOT_HEARTBEAT, e)
            + _CALOT_PROBE_TIMEOUT,
            0.0)
    else:
        detect = t_ev + np.where(
            crash_ev, theta + rng.uniform(0, theta, e), 0.0)   # U(Θ, 2Θ)

    m = meter_peers or int(np.clip(pair_budget // max(e, 1), 16, 1024))
    analytical = (calot_bandwidth(cfg.n, cfg.s_avg) if calot else
                  d1ht_bandwidth(cfg.n, cfg.s_avg, cfg.f))

    # Eq IV.4 early interval close: every peer acks every event, so its
    # buffer fills at the global event rate; an interval also ends when
    # the buffer reaches E.  The effective interval length feeds the
    # message accounting below and the kernel's per-hop flush model.
    fill_rate = t.size / max(cfg.warmup + cfg.duration, 1.0)
    e_cap = float(max(2.0, np.ceil(params.max_events)))
    if calot or fill_rate <= 0.0:
        theta_eff = theta
    else:
        fills = rng.gamma(e_cap, 1.0 / fill_rate, 8192)
        theta_eff = float(np.minimum(theta, fills).mean())
    if e == 0:
        return ChurnResult(
            cfg=cfg, params=params, events=0, one_hop_fraction=1.0,
            sum_out_bps=0.0, mean_out_bps=0.0, analytical_bps=analytical,
            quarantine_admitted=q_admit, quarantine_skipped=q_skip)

    # (E, M) pairs: uniform observer offsets per event (reporters are
    # uniform on the ring, so fixed metered peers see uniform offsets)
    reporter = (rng.random(e) * n_ev).astype(np.uint32)
    offsets = (rng.random((e, m)) * n_ev[:, None]).astype(np.uint32)
    ekey = rng.integers(0, 2**32, size=e, dtype=np.uint64).astype(np.uint32)
    levels = max(1, int(np.ceil(np.log2(max(cfg.n, 2)))))

    def upload(a: np.ndarray) -> torch.Tensor:
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    # the pair batch lives on the device: offsets once, the per-event
    # columns expanded there to (P,)
    p = e * m
    off = upload(offsets).reshape(p)
    n_col = upload(n_ev)

    def per_pair(col: torch.Tensor) -> torch.Tensor:
        return col[:, None].expand(e, m).reshape(p)

    pair_in = (off, per_pair(n_col), per_pair(upload(reporter)),
               per_pair(upload(detect.astype(np.float32))),
               per_pair(upload(ekey)))
    # K4 writes each chunk straight into its slice of (P,) outputs; the
    # last slice ends at P, so the ragged tail needs no padding.  The
    # plane reads neither depth nor parent: they go to chunk scratch.
    csize = min(chunk, (p + 2047) // 2048 * 2048)
    ack = torch.empty(p, dtype=torch.float32, device=dev)
    ttl = torch.empty(p, dtype=torch.int32, device=dev)
    sends = torch.empty(p, dtype=torch.int32, device=dev)
    depth = torch.empty(csize, dtype=torch.int32, device=dev)
    parent = torch.empty(csize, dtype=torch.int32, device=dev)
    kernel_theta = 0.0 if calot else theta   # Calot forwards unbuffered
    for lo in range(0, p, csize):
        hi = min(lo + csize, p)
        edra_tree(*(x[lo:hi] for x in pair_in),
                  levels=levels, theta=kernel_theta, delta_avg=delta_avg,
                  seed=cfg.seed, fill_rate=0.0 if calot else fill_rate,
                  e_cap=e_cap, out=(ack[lo:hi], ttl[lo:hi], depth[:hi - lo],
                                    parent[:hi - lo], sends[lo:hi]))
    del pair_in, depth, parent

    ack = ack.view(e, m)
    ttl = ttl.view(e, m)
    sends = sends.view(e, m)
    in_win = (ack >= w0) & (ack < w1)
    t_col = upload(t_ev)                                  # float64

    # -- one-hop fraction: expected stale routing entries at a random
    #    lookup instant = sum over (event, observer) staleness overlap
    stale = (ack.clamp(max=w1).double() - t_col.clamp(min=w0)[:, None]
             ).clamp(min=0.0)
    mean_stale_entries = float(stale.sum()) / m / cfg.duration
    del stale
    one_hop = 1.0 - mean_stale_entries / max(nbar, 1.0)

    ack_rel = (ack.double() - t_col[:, None])[in_win]
    mean_ack = float(ack_rel.mean()) if ack_rel.numel() else 0.0
    p99_ack = _percentile(ack_rel, 99) if ack_rel.numel() else 0.0
    del ack_rel

    # -- per-peer maintenance traffic (§VII-A accounting) ------------------
    payload = (sends * in_win).sum(dim=0).double()
    if calot:
        # one fixed-size message per event per tree edge + acks on every
        # reception + 4 unacked heartbeats/min (Eq VII.1 measured)
        out_bits = payload * V_C + in_win.sum(dim=0) * V_A \
            + float(np.floor(cfg.duration / _CALOT_HEARTBEAT)) * V_H
    else:
        num_intervals = int(np.ceil(cfg.duration / theta_eff)) + 2
        phase = rng.uniform(0.0, theta_eff, m)
        k_idx = torch.floor(((ack - w0).double() - upload(phase)[None, :])
                            / theta_eff).long().clamp(0, num_intervals - 1)
        slot = torch.arange(m, device=dev)[None, :].expand(e, m)
        ttl0 = float(np.floor(cfg.duration / theta_eff))
        sent_levels = torch.zeros(m, dtype=torch.int64, device=dev)
        off2 = off.view(e, m).long() & _M32
        n2 = (n_col.long() & _M32)[:, None]
        for l in range(1, params.rho):
            lv = in_win & (ttl > l) & ((off2 + (1 << l)) < n2)
            sent_levels += _distinct_interval_counts(
                slot[lv], k_idx[lv], num_intervals, m)
        msgs_sent = ttl0 + sent_levels
        # receptions: by ring symmetry the M(l) stream a peer receives is
        # the one the peer 2^l counterclockwise sends — another uniform
        # sample; decorrelate by rolling the metered sample
        msgs_recv = ttl0 + torch.roll(sent_levels, 1)
        out_bits = msgs_sent * V_M + msgs_recv * V_A + payload * M_BITS

    out_bits = out_bits.cpu().numpy()
    mean_out_bps = float(out_bits.mean()) / cfg.duration * (nbar / cfg.n)
    return ChurnResult(
        cfg=cfg, params=params, events=events_in_window,
        one_hop_fraction=float(one_hop),
        sum_out_bps=mean_out_bps * cfg.n, mean_out_bps=mean_out_bps,
        analytical_bps=analytical,
        quarantine_admitted=q_admit, quarantine_skipped=q_skip,
        mean_ack_s=mean_ack, p99_ack_s=p99_ack)
