from .failover import ReplicaSupervisor
from .membership import Membership, NodeInfo
from .placement import LatencyAware, PlacementPolicy, RingSuccessor, Topology

__all__ = ["LatencyAware", "Membership", "NodeInfo", "PlacementPolicy",
           "ReplicaSupervisor", "RingSuccessor", "Topology"]
