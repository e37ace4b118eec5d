"""PyTorch/CUDA port of the Loop-of-stencil-reduce system.

The JAX package :mod:`repro` is the reference; this package is its twin
for an NVIDIA H100 and never imports it (nor JAX).  Ported so far: the
paper's own loop on one device (:class:`~repro_torch.core.pattern.
LoopOfStencilReduce` on a persistent halo frame, whose sweeps run on a
hand-written CUDA kernel, ``kernels/csrc/window.cuh``), the §4 apps in
:mod:`repro_torch.kernels.ops`, the streaming farm tier
(:class:`~repro_torch.core.streaming.FarmEngine`, with the fault and
recovery layer of :mod:`repro_torch.resilience`) and the LM path
(``configs``, ``models``, ``serve``); further slices are listed in
ROADMAP.md.

Entry points run on the CUDA card unless the caller passes
``device="cpu"``, which selects the plain PyTorch path.
"""
from .core import (Boundary, FarmEngine, LoopOfStencilReduce, LoopResult,
                   Sentinel, StreamResult, health_status,
                   loop_of_stencil_reduce, loop_of_stencil_reduce_d,
                   loop_of_stencil_reduce_s)
from .device import resolve_backend, resolve_device

__all__ = ["Boundary", "FarmEngine", "LoopOfStencilReduce", "LoopResult",
           "Sentinel", "StreamResult", "health_status",
           "loop_of_stencil_reduce", "loop_of_stencil_reduce_d",
           "loop_of_stencil_reduce_s",
           "resolve_backend", "resolve_device"]
