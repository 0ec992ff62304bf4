"""Device pools of the port: ``mesh.replica_groups`` carves a pool of
torch devices into the tensor-parallel groups a ring node serves on."""
from .mesh import DeviceGroup, replica_groups

__all__ = ["DeviceGroup", "replica_groups"]
