"""Device pools and the launch group of the port: ``mesh.make_host_mesh``
lays a pool of torch devices out as a (data, model) mesh,
``mesh.replica_groups`` carves one into the tensor-parallel groups a ring
node serves on, and ``mesh.make_production_mesh`` is ``repro``'s
production grid of ``meta`` entries.  ``presets`` maps logical axes onto
it per (arch family x shape mode), ``hlo_cost`` counts a step's work on a
torch trace, and ``dryrun`` reckons every (arch x shape x mesh) cell on
the ``meta`` device."""
from .mesh import (HARDWARE, DeviceGroup, DeviceMesh, make_host_mesh,
                   make_production_mesh, replica_groups)

__all__ = ["HARDWARE", "DeviceGroup", "DeviceMesh", "make_host_mesh",
           "make_production_mesh", "replica_groups"]
