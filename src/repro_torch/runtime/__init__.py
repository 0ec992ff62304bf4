from .membership import Membership, NodeInfo
from .placement import PlacementPolicy, RingSuccessor

__all__ = ["Membership", "NodeInfo", "PlacementPolicy", "RingSuccessor"]
