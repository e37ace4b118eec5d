"""Pattern core of the port: semantics, reduce, stencil, frames, engine,
pattern, the sharded 1:n mode and the streaming tier (twins of
:mod:`repro.core`)."""
from ..sharding.specs import GridPartition, make_mesh
from .executor import (ShardedStencilEngine, StencilEngine,
                       check_unroll_feasible, sweep_once)
from .frames import (FrameSpec, frame_env, frame_spec, make_frame,
                     refresh_frame, unframe)
from .halo import distributed_loop_of_stencil_reduce, exchange_halo
from .pattern import (LoopOfStencilReduce, LoopResult,
                      loop_of_stencil_reduce, loop_of_stencil_reduce_d,
                      loop_of_stencil_reduce_s)
from .reduce import (MONOIDS, Sentinel, collective_combine, health_status,
                     health_update, resolve_monoid, tree_reduce,
                     two_phase_reduce)
from .semantics import Boundary
from .stencil import (TapAccessor, conv_taps, stencil_indexed, stencil_taps,
                      stencil_windows)
from .streaming import (FarmEngine, NonFiniteItemError, StreamResult,
                        StreamRunner, farm, item_status, ofarm, pipe,
                        sharded_farm)

__all__ = ["Boundary", "FarmEngine", "FrameSpec", "GridPartition",
           "LoopOfStencilReduce", "LoopResult", "MONOIDS",
           "NonFiniteItemError", "Sentinel", "ShardedStencilEngine",
           "StencilEngine", "StreamResult", "StreamRunner", "TapAccessor",
           "check_unroll_feasible", "collective_combine", "conv_taps",
           "distributed_loop_of_stencil_reduce", "exchange_halo", "farm",
           "frame_env", "frame_spec", "health_status", "health_update",
           "item_status", "make_mesh",
           "loop_of_stencil_reduce",
           "loop_of_stencil_reduce_d", "loop_of_stencil_reduce_s",
           "make_frame", "ofarm", "pipe", "refresh_frame", "resolve_monoid",
           "sharded_farm", "stencil_indexed",
           "stencil_taps", "stencil_windows", "sweep_once", "tree_reduce",
           "two_phase_reduce", "unframe"]
