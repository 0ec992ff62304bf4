"""Protocol-level DHT planes of the port.

``des`` is the deterministic message-level discrete-event network, and
``d1ht_node``, ``calot_node`` and ``experiment.run_churn`` drive the
paper's §VII churn methodology over it: copies of ``repro.dht``'s
modules on the port's core, pure host Python, so a run reproduces
``repro``'s ``ChurnResult`` exactly.  It is the oracle of the vectorized
churn plane (``core.sim``) at n <= 10^3.  ``latency`` is the
closed-form Figs 5-6 oracle and ``latency_sim`` its measured twin, whose
route timing runs the port's ring-lookup kernels and whose stale-table
retry fraction comes from the vectorized churn plane.  ``data`` is the
replicated KV-block store and the prefix cache the serve cluster hands
sessions off through.
"""
from .calot_node import CalotPeer
from .d1ht_node import D1HTPeer
from .data import (BlockMeta, BlockStore, Bf16Words, PrefixCache,
                   pack_array, unpack_array)
from .des import GeoDelay, LanDelay, SimNet, WanDelay
from .experiment import ChurnConfig, ChurnResult, run_churn
from .latency import LatencyPoint, latency_sweep
from .latency_sim import (ServiceProfile, latency_experiment, latency_point,
                          measure_profile, measured_retry_fraction)

__all__ = [
    "CalotPeer", "D1HTPeer", "GeoDelay", "LanDelay", "SimNet", "WanDelay",
    "BlockMeta", "BlockStore", "Bf16Words", "PrefixCache", "pack_array",
    "unpack_array",
    "ChurnConfig", "ChurnResult", "run_churn",
    "LatencyPoint", "latency_sweep",
    "ServiceProfile", "latency_experiment", "latency_point",
    "measure_profile", "measured_retry_fraction",
]
