"""The sharded 1:n deployment's mesh and grid partition (twin of
:mod:`repro.sharding`, grid part)."""
from .specs import (GridPartition, Mesh, check_even, gather_grid, make_mesh,
                    scatter_grid)

__all__ = ["GridPartition", "Mesh", "check_even", "gather_grid",
           "make_mesh", "scatter_grid"]
