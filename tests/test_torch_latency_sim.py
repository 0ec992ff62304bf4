"""The port's request-latency planes (``repro_torch.dht``) against
``repro.dht``'s, on the CPU.

Every function that only draws from a numpy ``Generator`` must give
``repro``'s numbers exactly from the same seed.  The kernel-driven route
timing goes through the port's ``RingState.lookup`` (the ring lookups'
plain versions on the CPU), and the stale-table retry fraction comes
from the port's churn plane.
"""
import numpy as np
import pytest
import torch

from repro.dht import latency as repro_latency
from repro.dht import latency_sim as repro_ls
from repro_torch.core.churn import ChurnConfig
from repro_torch.core.ringstate import RingState
from repro_torch.core.sim import simulate_churn
from repro_torch.dht import latency, latency_sim

torch.set_num_threads(1)

FP = {"d1ht": 0.01, "calot": 0.012}


def _profile(mod):
    return mod.ServiceProfile(route_us_per_key=0.5, dserver_service_us=10.4,
                              peer_service_us=9.0, table_n=4000, requests=0)


def _both(fn_name, *args, seed=0, **kw):
    out = []
    for mod in (repro_ls, latency_sim):
        out.append(getattr(mod, fn_name)(np.random.default_rng(seed), *args,
                                         **kw))
    return out


@pytest.mark.parametrize("clients", [800, 4000])
def test_closed_loop_fcfs_equals_repro(clients):
    want, got = _both("closed_loop_fcfs", clients=clients, think_s=1 / 30.0,
                      service_s=10e-6, window_s=0.5, seed=clients)
    np.testing.assert_array_equal(got, want)


def test_single_hop_pastry_dserver_equal_repro():
    route_s = np.random.default_rng(9).uniform(0, 1e-6, 5000)
    for name, kw in (
            ("simulate_single_hop", dict(requests=5000, retry_fraction=0.02,
                                         service_us=9.0, busy_mult=1.3,
                                         route_s=route_s)),
            ("simulate_single_hop", dict(requests=5000, retry_fraction=0.02,
                                         service_us=9.0, busy_mult=1.0,
                                         route_us_per_key=0.5)),
            ("simulate_pastry", dict(requests=5000, n=1600, service_us=9.0,
                                     busy_mult=1.0)),
            ("simulate_dserver", dict(clients=1600, service_us=10.4,
                                      busy_mult=1.0, window_s=0.5))):
        want, got = _both(name, seed=4, **kw)
        np.testing.assert_array_equal(got, want)
        assert latency_sim.stats_ms(got) == repro_ls.stats_ms(want)


def test_latency_sweep_equals_repro():
    kw = dict(busy=True, nodes=200, mu=9e4, window_s=5.0, d1ht_f=0.011,
              calot_f=0.013)
    sizes = [800, 3200, 10**6]
    want = repro_latency.latency_sweep(sizes, **kw)
    got = latency.latency_sweep(sizes, **kw)
    for n in sizes:
        assert vars(got[n]) == vars(want[n])


@pytest.mark.parametrize("n,busy", [(800, False), (4000, False),
                                    (1600, True)])
def test_latency_point_equals_repro(n, busy):
    kw = dict(busy=busy, fprime=FP, requests=20_000, window_s=1.0,
              drive_kernel=False, seed=1)
    want = repro_ls.latency_point(n, profile=_profile(repro_ls), **kw)
    got = latency_sim.latency_point(n, profile=_profile(latency_sim), **kw)
    assert got == want


def test_latency_point_drives_the_ports_lookup(monkeypatch):
    """``drive_kernel=True`` times real batched lookups through the
    port's ``RingState`` on the requested device."""
    calls = []
    lookup = RingState.lookup

    def counting(self, keys, **kw):
        calls.append((self.device.type, len(keys)))
        return lookup(self, keys, **kw)

    monkeypatch.setattr(RingState, "lookup", counting)
    row = latency_sim.latency_point(
        2400, busy=False, profile=_profile(latency_sim), fprime=FP,
        requests=4096, window_s=0.5, drive_kernel=True, seed=2, device="cpu")
    assert calls and all(dev == "cpu" for dev, _ in calls)
    assert sum(k for _, k in calls[1:]) == 4096      # after the warm-up
    assert row["systems"]["d1ht"]["requests"] == 4096
    assert row["systems"]["d1ht"]["mean_ms"] > 0.1   # legs dominate


def test_measured_retry_fraction_is_the_ports_churn_plane():
    kw = dict(s_avg=174 * 60.0, duration=120.0, warmup=30.0, seed=4)
    got = latency_sim.measured_retry_fraction(512, protocol="calot",
                                              device="cpu", **kw)
    res = simulate_churn(ChurnConfig(n=512, protocol="calot", **kw),
                         device="cpu")
    assert got == 1.0 - res.one_hop_fraction
    assert 0.0 < got < 0.02
