"""The port's vectorized simulators (``repro_torch.core.sim``) against
``repro.core.jax_sim``, on the CPU.

``simulate_churn`` draws everything host-side exactly as ``repro`` does,
so the event stream and the (event, observer) pairs are identical, and
K4's plain version equals ``repro``'s kernel on the integers.  The
``ChurnResult`` then matches field by field: ``events`` and the
quarantine counters exactly; ``one_hop_fraction`` within 1e-6
absolute; ``mean_out_bps``, ``sum_out_bps``, ``mean_ack_s`` and
``p99_ack_s`` within 1e-4 relative.  The gaps come from the last ulp of
float32 ``log`` (torch against XLA), which can move an acknowledge time
across an interval or window edge.  Observed on the three configs:
one-hop <= 7e-10, bandwidth <= 3.9e-6 relative, mean ack <= 1.3e-7
relative, p99 ack 0.

``simulate`` draws from a ``torch.Generator``, so its parity with
``repro``'s ``jax.random`` plane is statistical (see its test).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core.churn import ChurnConfig as ReproChurnConfig
from repro.core.jax_sim import SimConfig as ReproSimConfig
from repro.core.jax_sim import simulate as repro_simulate
from repro.core.jax_sim import simulate_churn as repro_simulate_churn
from repro_torch.core.churn import ChurnConfig
from repro_torch.core.sim import (SimConfig, _percentile, simulate,
                                  simulate_churn)

torch.set_num_threads(1)

CONFIGS = {
    "d1ht_n512": dict(n=512, s_avg=174 * 60, duration=300, warmup=60,
                      seed=3),
    "calot_n2048": dict(n=2048, s_avg=169 * 60, duration=300, warmup=60,
                        seed=9, protocol="calot"),
    "quarantine_n2048": dict(n=2048, s_avg=174 * 60, duration=300,
                             warmup=60, seed=7, volatile_fraction=0.31,
                             quarantine_tq=600.0),
}
EXACT = ("events", "quarantine_admitted", "quarantine_skipped")
RELATIVE = ("mean_out_bps", "sum_out_bps", "mean_ack_s", "p99_ack_s")


def _assert_same_result(got, want):
    for f in EXACT:
        assert getattr(got, f) == getattr(want, f), f
    assert got.one_hop_fraction == pytest.approx(want.one_hop_fraction,
                                                 abs=1e-6, rel=0)
    for f in RELATIVE:
        assert getattr(got, f) == pytest.approx(getattr(want, f), rel=1e-4,
                                                abs=0), f
    assert got.analytical_bps == want.analytical_bps
    assert dataclasses.asdict(got.params) == dataclasses.asdict(want.params)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_simulate_churn_equals_repro(name):
    kw = CONFIGS[name]
    want = repro_simulate_churn(ReproChurnConfig(**kw))
    got = simulate_churn(ChurnConfig(**kw), device="cpu")
    assert want.events > 0
    _assert_same_result(got, want)


def test_simulate_churn_independent_of_chunk():
    """K4 in launches of 4096 pairs or in one: the same result."""
    cfg = ChurnConfig(**CONFIGS["quarantine_n2048"])
    one = simulate_churn(cfg, device="cpu", meter_peers=128)
    many = simulate_churn(cfg, device="cpu", meter_peers=128, chunk=4096)
    for f in EXACT + RELATIVE + ("one_hop_fraction",):
        assert getattr(one, f) == getattr(many, f), f


def test_simulate_churn_d1ht_beats_calot():
    """The paper's headline ordering (Figs 3-4) on the port, on the SAME
    event stream (``test_jax_sim.test_churn_plane_d1ht_beats_calot``)."""
    base = CONFIGS["calot_n2048"].copy()
    base.pop("protocol")
    d1 = simulate_churn(ChurnConfig(protocol="d1ht", **base), device="cpu",
                        meter_peers=128)
    ca = simulate_churn(ChurnConfig(protocol="calot", **base), device="cpu",
                        meter_peers=128)
    assert d1.events == ca.events
    assert d1.mean_out_bps < ca.mean_out_bps
    assert ca.one_hop_fraction >= 0.98 and d1.one_hop_fraction >= 0.98


def test_simulate_churn_quarantine_reduces_traffic():
    """§V on the port (``test_jax_sim``'s quarantine test)."""
    base = CONFIGS["quarantine_n2048"].copy()
    base.pop("quarantine_tq")
    plain = simulate_churn(ChurnConfig(**base), device="cpu", meter_peers=128)
    quar = simulate_churn(ChurnConfig(quarantine_tq=600.0, **base),
                          device="cpu", meter_peers=128)
    assert quar.mean_out_bps < plain.mean_out_bps
    assert quar.quarantine_skipped > 0
    assert quar.events < plain.events
    assert quar.one_hop_fraction >= 0.98


def test_simulate_churn_needs_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        simulate_churn(ChurnConfig(**CONFIGS["d1ht_n512"]))


@pytest.mark.parametrize("size", [1, 2, 7, 1000, 4099])
def test_percentile_equals_numpy(size):
    x = np.random.default_rng(size).exponential(3.0, size)
    for q in (0, 50, 95, 99, 99.9, 100):
        assert _percentile(torch.from_numpy(x), q) == np.percentile(x, q)


# ``repro``'s fixed-n plane at n = 512 over five seeds (3-7): one-hop
# 0.99446-0.99465 (std 6.6e-5), mean ack 28.19-29.19 s (std 0.35 s),
# mean_out_bps 92.37-93.14 (std 0.275).  Two independent draws differ
# with std sqrt(2) * std; the tolerances are 5 sqrt(2) std.
SIM_TOL = {"one_hop_fraction": 4.7e-4, "mean_ack_time": 2.5,
           "mean_out_bps": 1.95}


def _assert_sim_claims(r):
    """``test_jax_sim.test_sim_one_hop_and_ack_bound``'s assertions."""
    assert r.one_hop_fraction >= 0.99           # claim C1
    assert r.mean_ack_time <= r.theorem1_bound  # Theorem 1 (+detection)
    assert 0.55 <= r.mean_out_bps / r.analytical_bps <= 1.1


def test_simulate_matches_repro_statistically():
    kw = dict(n=512, s_avg=174 * 60, duration=1200.0, seed=3)
    want = repro_simulate(ReproSimConfig(**kw))
    got = simulate(SimConfig(**kw), device="cpu")
    _assert_sim_claims(want)
    _assert_sim_claims(got)
    assert got.num_events == want.num_events
    assert got.theorem1_bound == want.theorem1_bound
    assert got.per_peer_out_bps.shape == (512,)
    for f, tol in SIM_TOL.items():
        assert abs(getattr(got, f) - getattr(want, f)) <= tol, f
