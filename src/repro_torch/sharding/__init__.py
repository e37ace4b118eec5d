"""The device mesh and grid partition of the sharded 1:n deployment and of
the lane farm over a mesh, and the LM parallelism policy (twin of
:mod:`repro.sharding`)."""
from .specs import (AbstractMesh, GridPartition, Mesh, axis_devices,
                    batch_spec, cache_shardings, check_even, dp_axes,
                    gather_grid, local_slot, make_abstract_mesh, make_mesh,
                    mesh_size, opt_shardings, param_spec, params_shardings,
                    replicated, scatter_grid, slice_partition, spec_shards,
                    zero1_spec)

__all__ = ["AbstractMesh", "GridPartition", "Mesh", "axis_devices",
           "batch_spec", "cache_shardings", "check_even", "dp_axes",
           "gather_grid", "local_slot", "make_abstract_mesh", "make_mesh",
           "mesh_size", "opt_shardings", "param_spec", "params_shardings",
           "replicated", "scatter_grid", "slice_partition", "spec_shards",
           "zero1_spec"]
