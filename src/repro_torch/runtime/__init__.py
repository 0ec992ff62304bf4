from .elastic import ElasticController, MeshPlan
from .failover import ReplicaSupervisor
from .membership import Membership, NodeInfo
from .placement import (LatencyAware, Placement, PlacementPolicy,
                        RingSuccessor, Topology)

__all__ = ["ElasticController", "LatencyAware", "Membership", "MeshPlan",
           "NodeInfo", "Placement", "PlacementPolicy", "ReplicaSupervisor",
           "RingSuccessor", "Topology"]
