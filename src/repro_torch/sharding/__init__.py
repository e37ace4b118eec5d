"""The device mesh and grid partition of the sharded 1:n deployment and of
the lane farm over a mesh (twin of :mod:`repro.sharding`, grid part)."""
from .specs import (GridPartition, Mesh, axis_devices, check_even,
                    gather_grid, local_slot, make_mesh, scatter_grid,
                    slice_partition)

__all__ = ["GridPartition", "Mesh", "axis_devices", "check_even",
           "gather_grid", "local_slot", "make_mesh", "scatter_grid",
           "slice_partition"]
