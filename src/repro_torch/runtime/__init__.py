from .elastic import ElasticController, MeshPlan
from .failover import FailoverConfig, FailoverManager, ReplicaSupervisor
from .membership import Membership, NodeInfo
from .placement import (LatencyAware, Placement, PlacementPolicy,
                        RingSuccessor, Topology)

__all__ = ["ElasticController", "FailoverConfig", "FailoverManager",
           "LatencyAware", "Membership", "MeshPlan",
           "NodeInfo", "Placement", "PlacementPolicy", "ReplicaSupervisor",
           "RingSuccessor", "Topology"]
