"""D1HT core of the port: the ring, the device-resident routing table,
EDRA events, Theta tuning and quarantine (copies of ``repro.core``'s
numpy-only modules, with the device paths on torch)."""
from .edra import Event
from .quarantine import QuarantineManager
from .ring import RoutingTable, hash_id, key_id, peer_id
from .ringstate import OwnerDiff, RingState
from .tuning import EdraParams

__all__ = ["Event", "QuarantineManager", "RoutingTable", "hash_id", "key_id",
           "peer_id", "OwnerDiff", "RingState", "EdraParams"]
