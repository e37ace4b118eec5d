"""Persistent-halo execution engine — the backend axis of the pattern.

PyTorch twin of :mod:`repro.core.executor` (single-device part).  Three
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

``"cuda-multistep"``
    Temporal blocking: the pattern's ``unroll=T`` becomes the fused sweep
    count of the hand-written multistep kernel
    (:func:`repro_torch.kernels.multistep.stencil2d_multistep_framed`) on a
    frame of pad k·T, one launch and one ghost refresh per T sweeps.

The engine also carries a **lane stack** of frames (the 1:1 farm,
:meth:`repro_torch.core.pattern.LoopOfStencilReduce.farm_run`): one launch
sweeps every lane, and a lane that is done keeps its value.

``"cuda-sharded"`` (the 1:n deployment) is reserved for a later slice and
raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from ..device import BACKENDS, resolve_backend, resolve_device, to_device
from .frames import (DEFAULT_BLOCK, FrameSpec, LaneFrameSpec, ceil_mul,
                     frame_env, frame_spec, lane_env_frames, make_frame,
                     make_lane_frames, refill_lane_env, refill_lane_frames,
                     refresh_frame, unframe)
from .semantics import Boundary

__all__ = ["BACKENDS", "StencilEngine", "auto_unroll",
           "check_unroll_feasible", "sweep_once"]


# auto_unroll's limits, the reference's own: the deepest T tried, the most
# recomputed halo cells per output cell, the body steps one dispatch should
# cover, and the block its redundancy is counted on when the caller gives
# none (the reference's default block, not the port's frame layout block).
UNROLL_CAP = 8
REDUNDANCY_LIMIT = 1.5
DISPATCH_AMORTIZE = 64
AUTO_UNROLL_BLOCK = (256, 256)


def auto_unroll(m: int, n: int, *, k: int = 1, block=AUTO_UNROLL_BLOCK,
                segment: Optional[int] = None) -> int:
    """Temporal-blocking depth T for ``unroll="auto"`` on
    ``"cuda-multistep"`` — a copy of the reference's heuristic with the
    same arithmetic and defaults, so the same arguments give the same T
    (the 8/128 tile clipping included) and a loop resolves ``"auto"`` to
    the reference's T: the pattern passes the caller's ``block``, or none.
    The kernel picks its own CTA tile, so T does not depend on the frame
    layout's ``DEFAULT_BLOCK``.

    Take the largest T ≤ ``UNROLL_CAP`` with k·T < min(m, n) (the halo
    must fit the domain) and (1 + 2kT/bm)(1 + 2kT/bn) ≤
    ``REDUNDANCY_LIMIT`` (the recomputed halo cells).  With ``segment``
    (body steps per dispatch) T is pushed up toward
    ceil(``DISPATCH_AMORTIZE`` / segment) while it stays feasible.  The
    reference derived these limits for a TPU; an H100 cost model is still
    to come (ROADMAP.md).
    """
    if min(m, n) <= k:
        raise ValueError(
            f"stencil radius k={k} does not fit the local domain "
            f"({m}x{n}): even T=1 needs k < min(local m, n); use a "
            f"coarser decomposition or a larger grid")
    bm = min(block[0], ceil_mul(m, 8))
    bn = min(block[1], ceil_mul(n, 128))
    best = 1
    for T in range(1, UNROLL_CAP + 1):
        if k * T >= min(m, n):
            break
        if (1 + 2 * k * T / bm) * (1 + 2 * k * T / bn) > REDUNDANCY_LIMIT:
            break
        best = T
    if segment is not None and best * segment < DISPATCH_AMORTIZE:
        want = -(-DISPATCH_AMORTIZE // segment)        # ceil division
        T = best
        while T < min(want, UNROLL_CAP) and k * (T + 1) < min(m, n):
            T += 1
        best = T
    return best


def check_unroll_feasible(m: int, n: int, unroll: int, *,
                          k: int = 1) -> None:
    """Loud feasibility check for an explicit ``unroll=T`` (same
    ``ValueError`` text as the reference, on the same shapes)."""
    if k * unroll < min(m, n):
        return
    tmax = max((min(m, n) - 1) // k, 0)
    raise ValueError(
        f"unroll={unroll} is infeasible: the k*T={k * unroll}-deep halo "
        f"must fit inside the local domain, but the {m}x{n} grid "
        f"(k*T < min(local m, n) = {min(m, n)} requires T <= {tmax}). "
        f"Lower unroll, pass unroll='auto', or use a coarser "
        f"decomposition.")


@dataclasses.dataclass
class StencilEngine:
    """The persistent-frame loop body of the kernel backends (``"cuda"``,
    ``"cuda-multistep"``).

    ``delta``/``measure`` mirror the pattern's -d variant: the fused reduce
    folds ``delta(new, old)`` or ``measure(new)``; with neither, ``new``.
    (On the card the kernels take a registered two-argument measure, i.e.
    ``delta=ref.abs_delta``, or none.)

    :meth:`prepare` (or :meth:`prepare_lanes` for a lane stack) allocates
    the two frame buffers the loop ping-pongs between and the reduce
    scratch, once; every launch writes into the buffer it does not read, so
    the loop allocates no frame.  On ``"cuda"`` a call of :meth:`sweeps` is
    ``unroll`` single-sweep launches, each followed by the ghost refresh; on
    ``"cuda-multistep"`` it is one launch of ``unroll`` fused sweeps on a
    frame of pad k·unroll (env fields in halo layout) and one refresh.  The
    launches go through the kernel wrappers, which run their plain versions
    on a CPU frame (the CPU tests drive the engine that way).
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
    backend: str = "cuda"
    acc_dtype: Any = torch.float32

    def __post_init__(self):
        if self.backend not in ("cuda", "cuda-multistep"):
            raise ValueError(
                f"StencilEngine runs the kernel backends 'cuda' and "
                f"'cuda-multistep'; got {self.backend!r}")
        self.boundary = Boundary(self.boundary)
        self._kernel_measure = self.delta
        if self.delta is None and self.measure is not None:
            meas = self.measure
            self._kernel_measure = lambda new, old: meas(new)
        self._buffers = None
        self._scratch = None

    @property
    def _multistep(self) -> bool:
        return self.backend == "cuda-multistep"

    def _spec(self, m: int, n: int) -> FrameSpec:
        return frame_spec(m, n, k=self.k, block=self.block,
                          sweeps=self.unroll if self._multistep else 1)

    # -- frame staging (once, outside the loop) -------------------------
    def prepare(self, a: torch.Tensor, env=()):
        """Stage ``a`` and the env fields into frames (O(mn), once), and
        allocate the second frame buffer and the reduce scratch."""
        from ..kernels.stencil2d import alloc_scratch

        m, n = a.shape
        spec = self._spec(m, n)
        frame = make_frame(a, spec, self.boundary)
        env_frames = tuple(frame_env(e, spec, self.boundary,
                                     halo=self._multistep) for e in env)
        self._buffers = (frame, torch.zeros_like(frame))
        self._scratch = alloc_scratch(spec, a.device)
        return frame, env_frames, spec

    # -- the loop body (zero-copy) --------------------------------------
    def _other(self, frame):
        if self._buffers is None or not any(frame is b
                                            for b in self._buffers):
            raise ValueError("sweeps takes a frame staged by prepare()")
        return self._buffers[1] if frame is self._buffers[0] \
            else self._buffers[0]

    def sweeps(self, frame: torch.Tensor, env_frames, spec: FrameSpec,
               live: Optional[torch.Tensor] = None):
        """``unroll`` sweeps; returns (frame', reduced).

        The reduce covers the final sweep (measure against the second to
        last iterate); on ``"cuda"`` the earlier sweeps skip the fold.  The
        returned frame's ghost ring is refreshed — a valid input for the
        next call.  ``live`` (lane stacks) marks the lanes to sweep; the
        others come back unchanged.
        """
        from ..kernels.multistep import stencil2d_multistep_framed
        from ..kernels.stencil2d import stencil2d_fused_framed

        kw = dict(env_framed=env_frames, combine=self.combine,
                  identity=self.identity, measure=self._kernel_measure,
                  acc_dtype=self.acc_dtype, scratch=self._scratch,
                  live=live)
        if self._multistep:
            frame, red = stencil2d_multistep_framed(
                frame, self.f, spec, T=self.unroll, boundary=self.boundary,
                out=self._other(frame), **kw)
            return refresh_frame(frame, spec, self.boundary), red
        red = None
        for s in range(self.unroll):
            frame, red = stencil2d_fused_framed(
                frame, self.f, spec, do_reduce=(s == self.unroll - 1),
                out=self._other(frame), **kw)
            refresh_frame(frame, spec, self.boundary)
        return frame, red

    def unframe(self, frame: torch.Tensor, spec: FrameSpec) -> torch.Tensor:
        """The domain as a tensor of its own — once, after convergence (a
        copy: the frame buffers are overwritten by later sweeps)."""
        return unframe(frame, spec).clone()

    # -- the lane axis (1:1 farm) ----------------------------------------
    def lane_spec(self, lanes: int, m: int, n: int) -> LaneFrameSpec:
        """Frame geometry for ``lanes`` independent (m, n) items."""
        return LaneFrameSpec(lanes=lanes, frame=self._spec(m, n))

    def prepare_lanes(self, a: torch.Tensor, env=()):
        """Stage a (lanes, m, n) stack (and (lanes, m, n) env fields) into
        lane frames, and allocate the second lane buffer and the per-lane
        reduce scratch — once."""
        from ..kernels.stencil2d import alloc_scratch

        lanes, m, n = a.shape
        lspec = self.lane_spec(lanes, m, n)
        frames = make_lane_frames(a, lspec.frame, self.boundary)
        env_frames = tuple(
            lane_env_frames(e, lspec.frame, self.boundary,
                            halo=self._multistep) for e in env)
        self._buffers = (frames, torch.zeros_like(frames))
        self._scratch = alloc_scratch(lspec.frame, a.device, lanes)
        return frames, env_frames, lspec

    def refill_lanes(self, frames, env_frames, interiors, env_new,
                     lspec: LaneFrameSpec):
        """Refill the lane slots in place with the next items — interior
        writes plus the ghost refresh; no re-framing, no allocation."""
        frames = refill_lane_frames(frames, interiors, lspec.frame,
                                    self.boundary)
        env_frames = tuple(
            refill_lane_env(ef, e, lspec.frame, self.boundary,
                            halo=self._multistep)
            for ef, e in zip(env_frames, env_new))
        return frames, env_frames

    def sweeps_lanes(self, frames, env_frames, lspec: LaneFrameSpec,
                     live: Optional[torch.Tensor] = None):
        """``unroll`` sweeps on every live lane; returns (frames',
        (lanes,) reduced).  Each launch covers the whole stack
        (``blockIdx.z`` is the lane), not a Python loop over lanes."""
        return self.sweeps(frames, env_frames, lspec.frame, live)

    def unframe_lanes(self, frames, lspec: LaneFrameSpec) -> torch.Tensor:
        """Every lane's domain, as a tensor of its own."""
        return unframe(frames, lspec.frame).clone()


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
    unframes per application; ``"cuda-multistep"`` fuses the ``unroll``
    sweeps into one launch on a frame of pad k·unroll.
    """
    dev = resolve_device(device)
    be = resolve_backend(backend, dev)
    a = to_device(a, dev)
    env = tuple(to_device(e, dev) for e in env)
    if be == "cuda-multistep":
        from ..kernels.multistep import stencil2d_multistep
        return stencil2d_multistep(
            a, f, env=env, k=k, T=unroll, combine=combine,
            identity=identity, measure=measure, boundary=boundary,
            block=block, acc_dtype=acc_dtype)
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
