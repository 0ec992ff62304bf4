"""D1HT core of the port: the ring, the device-resident routing table,
EDRA (events, the dissemination tree), Theta tuning, the analytical
traffic models, quarantine, the §VII churn shapes (copies of
``repro.core``'s numpy-only modules, with the device paths on torch) and
the vectorized simulators (``sim``, the counterpart of ``jax_sim``)."""
from .churn import ChurnConfig, ChurnResult, SessionDist
from .edra import Event, EventBuffer, dissemination_tree
from .quarantine import QuarantineManager
from .ring import RoutingTable, build_ring, hash_id, key_id, peer_id
from .ringstate import OwnerDiff, RingState
from .sim import SimConfig, SimResult, simulate, simulate_churn
from .tuning import EdraParams

__all__ = ["ChurnConfig", "ChurnResult", "SessionDist",
           "Event", "EventBuffer", "dissemination_tree", "QuarantineManager",
           "RoutingTable", "build_ring", "hash_id", "key_id", "peer_id",
           "OwnerDiff", "RingState", "SimConfig", "SimResult", "simulate",
           "simulate_churn", "EdraParams"]
