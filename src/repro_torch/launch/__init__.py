"""Device pools of the port: ``mesh.make_host_mesh`` lays a pool of torch
devices out as a (data, model) mesh, and ``mesh.replica_groups`` carves
one into the tensor-parallel groups a ring node serves on."""
from .mesh import DeviceGroup, DeviceMesh, make_host_mesh, replica_groups

__all__ = ["DeviceGroup", "DeviceMesh", "make_host_mesh", "replica_groups"]
