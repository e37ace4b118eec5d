"""Persistent-halo execution engine — the backend axis of the pattern.

PyTorch twin of :mod:`repro.core.executor` (single-device part).  Two
backends (:mod:`repro_torch.device`):

``"torch"``
    The shift-algebra path (:func:`repro_torch.core.stencil.stencil_taps`),
    padding per application.  Reference semantics; also the path for
    non-2D arrays, non-taps modes and user lambdas.

``"cuda"``
    The hand-written fused stencil+reduce kernel iterated on a
    **persistent halo frame** (:class:`StencilEngine`): the grid is staged
    into a frame once, the frame ping-pongs between two buffers allocated
    once, and only the O(m+n) ghost ring is re-asserted between sweeps.

``"cuda-multistep"`` (temporal blocking) and ``"cuda-sharded"`` (the 1:n
deployment) are reserved for later slices and raise
``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from ..device import BACKENDS, resolve_backend, resolve_device, to_device
from .frames import (DEFAULT_BLOCK, FrameSpec, frame_env, frame_spec,
                     make_frame, refresh_frame, unframe)
from .semantics import Boundary

__all__ = ["BACKENDS", "StencilEngine", "check_unroll_feasible",
           "local_extents", "sweep_once"]


def local_extents(m: int, n: int, part) -> tuple[int, int]:
    """Per-shard domain extents of an (m, n) grid under ``part`` (an object
    with ``axis_names``, ``array_axes`` and ``mesh.shape``, as the
    reference's ``GridPartition``); (m, n) when None."""
    lm, ln = m, n
    if part is not None:
        for name, ax in zip(part.axis_names, part.array_axes):
            nsh = part.mesh.shape[name]
            if ax == 0:
                lm = m // nsh
            elif ax == 1:
                ln = n // nsh
    return lm, ln


def check_unroll_feasible(m: int, n: int, unroll: int, *, k: int = 1,
                          part=None) -> None:
    """Loud feasibility check for an explicit ``unroll=T`` (same
    ``ValueError`` text as the reference, on the same shapes)."""
    lm, ln = local_extents(m, n, part)
    if k * unroll < min(lm, ln):
        return
    tmax = max((min(lm, ln) - 1) // k, 0)
    where = (f"each of the {tuple(part.shards)} shards holds a local "
             f"{lm}x{ln} block of the {m}x{n} grid" if part is not None
             else f"the {m}x{n} grid")
    raise ValueError(
        f"unroll={unroll} is infeasible: the k*T={k * unroll}-deep halo "
        f"must fit inside the local domain, but {where} "
        f"(k*T < min(local m, n) = {min(lm, ln)} requires T <= {tmax}). "
        f"Lower unroll, pass unroll='auto', or use a coarser "
        f"decomposition.")


@dataclasses.dataclass
class StencilEngine:
    """The persistent-frame loop body of the ``"cuda"`` backend.

    ``delta``/``measure`` mirror the pattern's -d variant: the fused reduce
    folds ``delta(new, old)`` or ``measure(new)``; with neither, ``new``.
    (On the card the kernel takes a registered two-argument measure, i.e.
    ``delta=ref.abs_delta``, or none.)

    :meth:`prepare` allocates the two frame buffers the loop ping-pongs
    between (zero-initialised) and the reduce scratch, once; every sweep
    writes into the buffer it does not read, so the loop allocates no
    frame.  The sweeps run through
    :func:`repro_torch.kernels.stencil2d.stencil2d_fused_framed`, which
    launches the kernel on a CUDA frame and runs its plain version on a
    CPU frame (the CPU tests drive the engine that way).
    """

    f: Callable
    k: int = 1
    boundary: Boundary | str = Boundary.ZERO
    combine: Any = "sum"
    identity: Any = None
    delta: Optional[Callable] = None
    measure: Optional[Callable] = None
    block: tuple[int, int] = DEFAULT_BLOCK
    unroll: int = 1
    acc_dtype: Any = torch.float32

    def __post_init__(self):
        self.boundary = Boundary(self.boundary)
        self._kernel_measure = self.delta
        if self.delta is None and self.measure is not None:
            meas = self.measure
            self._kernel_measure = lambda new, old: meas(new)
        self._buffers = None
        self._scratch = None

    # -- frame staging (once, outside the loop) -------------------------
    def prepare(self, a: torch.Tensor, env=()):
        """Stage ``a`` and the env fields into frames (O(mn), once), and
        allocate the second frame buffer and the reduce scratch."""
        from ..kernels.stencil2d import alloc_scratch

        m, n = a.shape
        spec = frame_spec(m, n, k=self.k, block=self.block)
        frame = make_frame(a, spec, self.boundary)
        env_frames = tuple(frame_env(e, spec, self.boundary) for e in env)
        self._buffers = (frame, torch.zeros_like(frame))
        self._scratch = alloc_scratch(spec, a.device)
        return frame, env_frames, spec

    # -- the loop body (zero-copy) --------------------------------------
    def sweeps(self, frame: torch.Tensor, env_frames, spec: FrameSpec):
        """``unroll`` sweeps; returns (frame', reduced).

        The reduce covers the final sweep (measure against the second to
        last iterate); the earlier sweeps skip the fold.  The returned
        frame's ghost ring is refreshed — a valid input for the next call.
        """
        from ..kernels.stencil2d import stencil2d_fused_framed

        if self._buffers is None or not any(frame is b
                                            for b in self._buffers):
            raise ValueError("sweeps takes a frame staged by prepare()")
        red = None
        for s in range(self.unroll):
            out = self._buffers[1] if frame is self._buffers[0] \
                else self._buffers[0]
            frame, red = stencil2d_fused_framed(
                frame, self.f, spec, env_framed=env_frames,
                combine=self.combine, identity=self.identity,
                measure=self._kernel_measure, acc_dtype=self.acc_dtype,
                do_reduce=(s == self.unroll - 1), out=out,
                scratch=self._scratch)
            refresh_frame(frame, spec, self.boundary)
        return frame, red

    def unframe(self, frame: torch.Tensor, spec: FrameSpec) -> torch.Tensor:
        """The domain as a tensor of its own — once, after convergence (a
        copy: the frame buffers are overwritten by later sweeps)."""
        return unframe(frame, spec).clone()


def sweep_once(a, f, *, env=(), k=1, combine="sum", identity=None,
               measure=None, boundary="zero", block=DEFAULT_BLOCK,
               backend=None, unroll=1, acc_dtype=torch.float32,
               device=None):
    """One fused stencil+reduce application through the backend axis —
    the entry point for non-iterative uses (Sobel, the AMF detection
    pass).  Returns ``(new, reduced)``.

    ``measure`` is the *kernel* convention, a two-argument
    ``measure(new, old_center)`` (e.g. ``ref.abs_delta``).  ``unroll``
    applies that many sweeps, the reduce taken on the final one.
    ``"torch"`` runs the oracle path; ``"cuda"`` frames, sweeps and
    unframes per application.
    """
    dev = resolve_device(device)
    be = resolve_backend(backend, dev)
    a = to_device(a, dev)
    env = tuple(to_device(e, dev) for e in env)
    if be == "torch":
        from ..kernels import ref as R
        step = lambda x: R.stencil2d_fused_ref(
            x, f, env=env, k=k, combine=combine, identity=identity,
            measure=measure, boundary=boundary, acc_dtype=acc_dtype)
    else:
        from ..kernels.stencil2d import stencil2d_fused
        step = lambda x: stencil2d_fused(
            x, f, env=env, k=k, combine=combine, identity=identity,
            measure=measure, boundary=boundary, block=block,
            acc_dtype=acc_dtype)
    new, red = step(a)
    for _ in range(unroll - 1):
        new, red = step(new)
    return new, red
