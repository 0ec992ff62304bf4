"""Request-latency planes of the port (paper §VII-D, Figs 5-6).

``latency`` is the closed-form oracle and ``latency_sim`` its measured
twin, copies of ``repro.dht``'s modules whose route timing runs the
port's ring-lookup kernels and whose stale-table retry fraction comes
from the port's churn plane (``core.sim``).
"""
from .latency import LatencyPoint, latency_sweep
from .latency_sim import (ServiceProfile, latency_experiment, latency_point,
                          measure_profile, measured_retry_fraction)

__all__ = [
    "LatencyPoint", "latency_sweep",
    "ServiceProfile", "latency_experiment", "latency_point",
    "measure_profile", "measured_retry_fraction",
]
