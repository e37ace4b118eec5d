"""Persistent-halo execution engine — the backend axis of the pattern.

PyTorch twin of :mod:`repro.core.executor`.  Four backends
(:mod:`repro_torch.device`):

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

``"cuda-sharded"``
    The 1:n deployment (:class:`ShardedStencilEngine`): one frame per
    shard of a device mesh, each swept by the kernel of ``"cuda"`` (or, at
    ``unroll=T > 1``, by the multistep kernel on a k·T-deep frame with the
    shard's own domain bounds), then one edge-strip exchange between the
    shards' frames and one fold of the per-shard partial reduces.

Both engines also carry a **lane stack** of frames (the 1:1 farm,
:meth:`repro_torch.core.pattern.LoopOfStencilReduce.farm_run`, and the
streaming farm over a mesh, :class:`repro_torch.core.streaming.FarmEngine`):
one launch a shard sweeps every lane, and a lane that is done keeps its
value.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Optional

import torch

from ..device import BACKENDS, resolve_backend, resolve_device, to_device
from .frames import (DEFAULT_BLOCK, FrameSpec, LaneFrameSpec,
                     ShardedFrameSpec, alloc_lane_env, alloc_lane_frames,
                     ceil_mul, frame_env, frame_env_sharded, frame_spec,
                     make_frame, make_frames_sharded, refill_lane_env,
                     refill_lane_env_sharded, refill_lane_frames,
                     refill_lane_frames_sharded, refill_lanes_env_masked,
                     refill_lanes_masked, refill_slot_env,
                     refill_slot_env_sharded, refill_slot_frame,
                     refill_slot_frame_sharded, refresh_frame,
                     refresh_frames_sharded, shard_domain_bounds,
                     sharded_frame_spec, unframe)
from .reduce import collective_combine, resolve_monoid
from .semantics import Boundary

__all__ = ["BACKENDS", "ShardedStencilEngine", "StencilEngine",
           "auto_unroll", "check_unroll_feasible", "local_extents",
           "sweep_once"]


# auto_unroll's limits, the reference's own: the deepest T tried, the most
# recomputed halo cells per output cell, the body steps one dispatch should
# cover, and the block its redundancy is counted on when the caller gives
# none (the reference's default block, not the port's frame layout block).
UNROLL_CAP = 8
REDUNDANCY_LIMIT = 1.5
DISPATCH_AMORTIZE = 64
AUTO_UNROLL_BLOCK = (256, 256)


def local_extents(m: int, n: int, part) -> tuple[int, int]:
    """Per-shard domain extents of an (m, n) grid under ``part`` (a
    :class:`repro_torch.sharding.GridPartition`); (m, n) when None."""
    lm, ln = m, n
    if part is not None:
        for name, ax in zip(part.axis_names, part.array_axes):
            nsh = part.axis_size(name)
            if ax == 0:
                lm = m // nsh
            elif ax == 1:
                ln = n // nsh
    return lm, ln


def auto_unroll(m: int, n: int, *, k: int = 1, block=AUTO_UNROLL_BLOCK,
                part=None, segment: Optional[int] = None) -> int:
    """Temporal-blocking depth T for ``unroll="auto"`` on
    ``"cuda-multistep"`` and ``"cuda-sharded"`` — a copy of the
    reference's heuristic with the same arithmetic and defaults, so the
    same arguments give the same T (the 8/128 tile clipping included) and
    a loop resolves ``"auto"`` to the reference's T: the pattern passes the
    caller's ``block``, or none.  The kernel picks its own CTA tile, so T
    does not depend on the frame layout's ``DEFAULT_BLOCK``.

    Take the largest T ≤ ``UNROLL_CAP`` with k·T < min(local m, n) (the
    halo must fit a shard's domain; ``part`` gives the local extents) and
    (1 + 2kT/bm)(1 + 2kT/bn) ≤ ``REDUNDANCY_LIMIT`` (the recomputed halo
    cells).  With ``segment`` (body steps per dispatch) T is pushed up
    toward ceil(``DISPATCH_AMORTIZE`` / segment) while it stays feasible.
    The reference derived these limits for a TPU; an H100 cost model is
    still to come (ROADMAP.md).
    """
    lm, ln = local_extents(m, n, part)
    if min(lm, ln) <= k:
        raise ValueError(
            f"stencil radius k={k} does not fit the local domain "
            f"({lm}x{ln}): even T=1 needs k < min(local m, n); use a "
            f"coarser decomposition or a larger grid")
    bm = min(block[0], ceil_mul(lm, 8))
    bn = min(block[1], ceil_mul(ln, 128))
    best = 1
    for T in range(1, UNROLL_CAP + 1):
        if k * T >= min(lm, ln):
            break
        if (1 + 2 * k * T / bm) * (1 + 2 * k * T / bn) > REDUNDANCY_LIMIT:
            break
        best = T
    if segment is not None and best * segment < DISPATCH_AMORTIZE:
        want = -(-DISPATCH_AMORTIZE // segment)        # ceil division
        T = best
        while T < min(want, UNROLL_CAP) and k * (T + 1) < min(lm, ln):
            T += 1
        best = T
    return best


def check_unroll_feasible(m: int, n: int, unroll: int, *, k: int = 1,
                          part=None) -> None:
    """Loud feasibility check for an explicit ``unroll=T`` (same
    ``ValueError`` text as the reference, on the same shapes, the mesh
    context included)."""
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
        next call.  A lane stack of frames is swept by each launch as a
        whole (``blockIdx.z`` is the lane) and reduces to a (lanes,)
        vector; ``live`` marks the lanes to sweep, the others come back
        unchanged.
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
        """The domain (each lane's, for a stack) as a tensor of its own —
        once, after convergence (a copy: the frame buffers are overwritten
        by later sweeps)."""
        return unframe(frame, spec).clone()

    # -- the lane axis (1:1 farm) ----------------------------------------
    def lane_spec(self, lanes: int, m: int, n: int) -> LaneFrameSpec:
        """Frame geometry for ``lanes`` independent (m, n) items."""
        return LaneFrameSpec(lanes=lanes, frame=self._spec(m, n))

    def alloc_lanes(self, lspec: LaneFrameSpec, dtype, env_dtypes=(),
                    device=None):
        """Allocate the lane slots (zeros) and one env slot stack per dtype
        in ``env_dtypes``, with the second lane buffer and the per-lane
        reduce scratch — once.  Items enter the slots in place, through the
        refills below.  Returns ``(frames, env_frames)``."""
        from ..kernels.stencil2d import alloc_scratch

        frames = alloc_lane_frames(lspec, dtype, device)
        env_frames = tuple(alloc_lane_env(lspec, d, self._multistep, device)
                           for d in env_dtypes)
        self._buffers = (frames, torch.zeros_like(frames))
        self._scratch = alloc_scratch(lspec.frame, device, lspec.lanes)
        return frames, env_frames

    def buffer_pointers(self) -> tuple:
        """``data_ptr()`` of the two frame buffers the sweeps ping-pong
        between (unchanged for the engine's life once allocated)."""
        return tuple(b.data_ptr() for b in self._buffers)

    def prepare_lanes(self, a: torch.Tensor, env=()):
        """Stage a (lanes, m, n) stack (and (lanes, m, n) env fields) into
        lane frames (:meth:`alloc_lanes`, then :meth:`refill_lanes`)."""
        lanes, m, n = a.shape
        lspec = self.lane_spec(lanes, m, n)
        frames, env_frames = self.alloc_lanes(
            lspec, a.dtype, tuple(e.dtype for e in env), a.device)
        frames, env_frames = self.refill_lanes(frames, env_frames, a, env,
                                               lspec)
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

    def refill_slot(self, frames, env_frames, idx: int, interior, env_new,
                    lspec: LaneFrameSpec):
        """Refill ONE lane slot ``idx`` (and its env slots) in place."""
        refill_slot_frame(frames, interior, idx, lspec.frame, self.boundary)
        for ef, e in zip(env_frames, env_new):
            refill_slot_env(ef, e, idx, lspec.frame, self.boundary,
                            halo=self._multistep)
        return frames, env_frames

    def refill_masked(self, frames, env_frames, take, interiors, env_new,
                      lspec: LaneFrameSpec):
        """Refill the slots where the (lanes,) bool ``take`` is set from
        the (lanes, m, n) ``interiors`` and env stacks, in place; the other
        slots keep their values."""
        refill_lanes_masked(frames, take, interiors, lspec.frame,
                            self.boundary)
        for ef, e in zip(env_frames, env_new):
            refill_lanes_env_masked(ef, take, e, lspec.frame, self.boundary,
                                    halo=self._multistep)
        return frames, env_frames


def _on(device: torch.device):
    """Make ``device`` current for a kernel launch (the C entries launch
    on the current card)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


@dataclasses.dataclass
class ShardedStencilEngine:
    """The 1:n persistent engine: per-shard frames, edge-strip exchange,
    one fold of the partial reduces (twin of the reference's
    ``ShardedStencilEngine``, single-controller: one process drives every
    shard, whose frames form a list in mesh order).

    A call of :meth:`sweeps` is, for each shard, one kernel launch on its
    device — ``unroll`` = 1: the single sweep of ``"cuda"``; ``unroll=T``
    > 1: the multistep kernel's T sweeps on a k·T-deep frame, ⊥ re-asserted
    only on sides at the global edge (:func:`~repro_torch.core.frames.
    shard_domain_bounds`, host ints) — then ONE ghost exchange
    (:func:`~repro_torch.core.frames.refresh_frames_sharded`) and ONE fold
    of the per-shard partials on the lead device
    (:func:`~repro_torch.core.reduce.collective_combine`).  :meth:`prepare`
    allocates each shard's second frame and reduce scratch once, as
    :class:`StencilEngine` does; the launches go through the kernel
    wrappers, which run their plain versions on CPU frames.

    The lane half (the composed lanes × spatial farm): each shard holds a
    lane stack (lanes, fm, fn) of its block of every lane, allocated once
    by :meth:`alloc_lanes` and refilled in place (:meth:`refill_lanes`,
    :meth:`refill_slot`); :meth:`sweeps` and :meth:`unframe` take the
    stacks as they are (the reference's ``sweeps_lanes`` /
    ``unframe_lanes``): one launch a shard over its whole stack, the
    exchange batched over the lanes, and the partials folded lane by lane
    into a (lanes,) reduce.
    """

    f: Callable
    part: Any                        # GridPartition (mesh + decomposition)
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
        self._op, _ = resolve_monoid(self.combine, self.identity)
        self._kernel_measure = self.delta
        if self.delta is None and self.measure is not None:
            meas = self.measure
            self._kernel_measure = lambda new, old: meas(new)
        self._buffers = None

    @property
    def _multistep(self) -> bool:
        return self.unroll > 1

    # -- per-shard frame staging (once, outside the loop) ---------------
    def prepare(self, blocks, env_blocks=()):
        """Stage each shard's block (a list in mesh order, each on its
        device) and its env slices (one such list per field) into frames,
        and allocate each shard's second frame, reduce scratch and domain
        bounds.  Returns ``(frames, env_frames, sspec)``; ``env_frames[i]``
        is shard i's tuple of env frames."""
        from ..kernels.stencil2d import alloc_scratch

        sspec = self.lane_sspec(*blocks[0].shape)
        frames = make_frames_sharded(blocks, sspec, self.boundary)
        per_field = [frame_env_sharded(e, sspec, self.boundary,
                                       halo=self._multistep)
                     for e in env_blocks]
        env_frames = [tuple(f[i] for f in per_field)
                      for i in range(len(frames))]
        self._buffers = [(fr, torch.zeros_like(fr)) for fr in frames]
        self._scratch = [alloc_scratch(sspec.local, fr.device)
                         for fr in frames]
        self._bounds = [shard_domain_bounds(sspec, i)
                        for i in range(len(frames))]
        return frames, env_frames, sspec

    def lane_sspec(self, lm: int, ln: int) -> ShardedFrameSpec:
        """Per-shard frame geometry of a local (lm, ln) block (one lane's,
        or the single grid's)."""
        return sharded_frame_spec(
            lm, ln, self.part, k=self.k, block=self.block,
            sweeps=self.unroll if self._multistep else 1)

    # -- the lane half: lane stacks a shard --------------------------------
    def alloc_lanes(self, sspec: ShardedFrameSpec, lanes: int, dtype,
                    env_dtypes=()):
        """Allocate each shard's lane slots (zeros, on its device), its
        second lane buffer, per-lane reduce scratch and domain bounds, and
        one env slot stack per dtype in ``env_dtypes`` (block-rounded
        interiors, or full frames under temporal blocking) — once.
        Returns ``(frames, env_frames)``: lists in mesh order,
        ``env_frames[i]`` shard i's tuple."""
        from ..kernels.stencil2d import alloc_scratch

        lspec = LaneFrameSpec(lanes, sspec.local)
        devs = self.part.devices
        frames = [alloc_lane_frames(lspec, dtype, d) for d in devs]
        env_frames = [tuple(alloc_lane_env(lspec, t, self._multistep, d)
                            for t in env_dtypes) for d in devs]
        self._buffers = [(fr, torch.zeros_like(fr)) for fr in frames]
        self._scratch = [alloc_scratch(sspec.local, d, lanes) for d in devs]
        self._bounds = [shard_domain_bounds(sspec, i)
                        for i in range(len(devs))]
        return frames, env_frames

    def prepare_lanes(self, blocks, env_blocks=()):
        """Stage each shard's (lanes, lm, ln) block stack (a list in mesh
        order) and its env stacks (one such list per field) into lane
        frames: :meth:`alloc_lanes`, then :meth:`refill_lanes`."""
        lanes, lm, ln = blocks[0].shape
        sspec = self.lane_sspec(lm, ln)
        frames, env_frames = self.alloc_lanes(
            sspec, lanes, blocks[0].dtype,
            tuple(e[0].dtype for e in env_blocks))
        self.refill_lanes(frames, env_frames, blocks, env_blocks, sspec)
        return frames, env_frames, sspec

    def refill_lanes(self, frames, env_frames, interiors, env_new,
                     sspec: ShardedFrameSpec):
        """Refill every shard's lane stack in place with its blocks of the
        next items (``interiors[i]``: shard i's (lanes, lm, ln); ``env_new``
        one such list per field), then the lane-batched exchange.  Pass
        ``frames[i][:c]`` views to refill the first c lanes."""
        refill_lane_frames_sharded(frames, interiors, sspec, self.boundary)
        for j, e in enumerate(env_new):
            refill_lane_env_sharded([ef[j] for ef in env_frames], e, sspec,
                                    self.boundary, halo=self._multistep)
        return frames, env_frames

    def refill_slot(self, frames, env_frames, li: int, interiors, env_new,
                    sspec: ShardedFrameSpec):
        """Refill lane slot ``li`` of every shard's stack in place with its
        (lm, ln) block of the next item, then re-assert that lane's ghost
        strips on every shard."""
        refill_slot_frame_sharded(frames, interiors, li, sspec,
                                  self.boundary)
        for j, e in enumerate(env_new):
            refill_slot_env_sharded([ef[j] for ef in env_frames], e, li,
                                    sspec, self.boundary,
                                    halo=self._multistep)
        return frames, env_frames

    def buffer_pointers(self) -> tuple:
        """``data_ptr()`` of every shard's two frame buffers."""
        return tuple(b.data_ptr() for pair in self._buffers for b in pair)

    def _other(self, i: int, frame):
        a, b = self._buffers[i]
        if frame is not a and frame is not b:
            raise ValueError("sweeps takes frames staged by prepare()")
        return b if frame is a else a

    # -- the loop body ----------------------------------------------------
    def sweeps(self, frames, env_frames, sspec: ShardedFrameSpec,
               live: Optional[torch.Tensor] = None):
        """``unroll`` sweeps on every shard, ONE ghost exchange and the
        combine; returns (frames', reduced) with ``reduced`` a 0-d tensor on
        the lead device, or for lane stacks a (lanes,) tensor folded lane by
        lane; ``live`` (a (lanes,) bool) marks the lanes to sweep, the
        others come back unchanged."""
        from ..kernels.multistep import stencil2d_multistep_framed
        from ..kernels.stencil2d import stencil2d_fused_framed

        spec = sspec.local
        kw = dict(combine=self.combine, identity=self.identity,
                  measure=self._kernel_measure, acc_dtype=self.acc_dtype)
        new, partials = [], []
        for i, frame in enumerate(frames):
            if live is not None:
                kw["live"] = live.to(frame.device)
            with _on(frame.device):
                if self._multistep:
                    out, red = stencil2d_multistep_framed(
                        frame, self.f, spec, T=self.unroll,
                        env_framed=env_frames[i], boundary=self.boundary,
                        domain_bounds=self._bounds[i],
                        out=self._other(i, frame),
                        scratch=self._scratch[i], **kw)
                else:
                    out, red = stencil2d_fused_framed(
                        frame, self.f, spec, env_framed=env_frames[i],
                        out=self._other(i, frame),
                        scratch=self._scratch[i], **kw)
            new.append(out)
            partials.append(red)
        refresh_frames_sharded(new, sspec, self.boundary)
        return new, collective_combine(self._op, partials)

    def unframe(self, frames, sspec: ShardedFrameSpec) -> list:
        """Each shard's local domain (each lane's, for lane stacks) as a
        tensor of its own, after convergence."""
        return [unframe(fr, sspec.local).clone() for fr in frames]


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
    if be == "cuda-sharded":
        # loop-only: it needs a mesh partition and a loop carry; one-shot
        # sweeps stay on one device, as in the reference
        raise ValueError(
            f"unknown backend {be!r} for sweep_once; choose from "
            "('torch', 'cuda', 'cuda-multistep')")
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
