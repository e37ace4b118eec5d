"""Persistent halo frames — the device-resident grid layout of the engine.

PyTorch twin of the single-device half of :mod:`repro.core.frames`.  The
framed array is the loop-carried representation: the grid is staged into
it once (:func:`make_frame`), the kernel reads and writes it directly,
only the O(m+n) ghost ring is re-asserted between sweeps
(:func:`refresh_frame`), and the domain is sliced out once at the end
(:func:`unframe`).  :func:`refresh_frame` and :func:`unframe` also take a
lane stack of frames (leading lane axis), the carry of the lane farm
(:class:`LaneFrameSpec` and the ``*lane*`` helpers below), and the
streaming farm refills single slots or masked sets of slots in place and
stages items in a ring (the ``refill_*`` and ``*stage_ring*`` helpers).

    ┌──────────────────────────────┐
    │ ghost ring (pad = k·T wide)  │   frame shape: (gm·bm + 2·pad,
    │  ┌────────────┬───────────┐  │                 gn·bn + 2·pad)
    │  │ domain     │ round-up  │  │
    │  │ (m, n)     │ (inert)   │  │   domain at [pad:pad+m, pad:pad+n]
    │  ├────────────┴───────────┤  │
    │  │ block round-up (inert) │  │
    │  └────────────────────────┘  │
    └──────────────────────────────┘

The ghost ring equals :meth:`Boundary.pad` cell for cell (corners compose
axis by axis, like ``jnp.pad``).  The block (bm, bn) sets the frame's
round-up; the CUDA kernel picks its own CTA tile
(:func:`repro_torch.kernels.stencil2d.cta_tile`).  The reference's 8/128
clipping is a TPU tiling rule and does not apply here (rows clip to a
multiple of 8, columns to a warp of 32).
"""
from __future__ import annotations

import dataclasses

import torch

from .semantics import Boundary

DEFAULT_BLOCK = (32, 32)


def ceil_mul(x: int, q: int) -> int:
    """Round ``x`` up to the next multiple of ``q``."""
    return -(-x // q) * q


@dataclasses.dataclass(frozen=True)
class FrameSpec:
    """Static geometry of a persistent halo frame."""

    m: int          # logical domain rows
    n: int          # logical domain cols
    k: int          # stencil radius per sweep
    pad: int        # ghost-ring width (= k·sweeps for temporal blocking)
    bm: int         # block rows (the round-up)
    bn: int         # block cols
    gm: int         # grid rows
    gn: int         # grid cols

    @property
    def interior(self) -> tuple[int, int]:
        """Block-rounded interior (domain + round-up)."""
        return self.gm * self.bm, self.gn * self.bn

    @property
    def shape(self) -> tuple[int, int]:
        mi, ni = self.interior
        return mi + 2 * self.pad, ni + 2 * self.pad


def frame_spec(m: int, n: int, *, k: int = 1, block=DEFAULT_BLOCK,
               sweeps: int = 1) -> FrameSpec:
    """Frame geometry for an (m, n) domain; ``sweeps`` > 1 widens the
    ghost ring for temporal blocking."""
    bm = min(block[0], ceil_mul(m, 8))
    bn = min(block[1], ceil_mul(n, 32))
    gm, gn = -(-m // bm), -(-n // bn)
    pad = k * sweeps
    if pad >= min(m, n):
        raise ValueError(
            f"halo width k*sweeps={pad} must be < min(m, n)={min(m, n)}; "
            f"lower `unroll` or use a larger grid")
    return FrameSpec(m=m, n=n, k=k, pad=pad, bm=bm, bn=bn, gm=gm, gn=gn)


def make_frame(a: torch.Tensor, spec: FrameSpec,
               boundary: Boundary | str) -> torch.Tensor:
    """Embed ``a`` into a zero-initialised frame and refresh its ghosts.
    Runs once, before the loop — the only O(mn) staging cost."""
    frame = torch.zeros(spec.shape, dtype=a.dtype, device=a.device)
    p = spec.pad
    frame[p:p + spec.m, p:p + spec.n] = a
    return refresh_frame(frame, spec, boundary)


def frame_env(e: torch.Tensor, spec: FrameSpec, boundary: Boundary | str,
              halo: bool = False) -> torch.Tensor:
    """Stage a read-only ``env`` field once, outside the loop.

    Without ``halo`` the field is block-rounded only (interior layout,
    zero round-up).  With ``halo`` it gets the full frame layout (temporal
    blocking evaluates f on ghost cells; under ``wrap`` those must see the
    wrapped env, for the other models a zero ring suffices).
    """
    if not halo:
        mi, ni = spec.interior
        out = torch.zeros((mi, ni), dtype=e.dtype, device=e.device)
        out[:spec.m, :spec.n] = e
        return out
    return make_frame(e, spec, _env_ghost(boundary))


def refresh_frame(frame: torch.Tensor, spec: FrameSpec,
                  boundary: Boundary | str) -> torch.Tensor:
    """Re-assert the ⊥ ghost ring around the (m, n) domain, in place —
    four strip writes, O(m+n) cells.

    Column strips are filled from domain columns first, then row strips
    run full width over the column-refreshed frame, so corners compose
    like ``jnp.pad``.  Cells beyond the ``pad``-wide ring (deep round-up)
    are never read by a domain cell and are left as they are.  A lane
    stack is refreshed lane by lane in the same four writes.
    """
    boundary = Boundary(boundary)
    p, m, n = spec.pad, spec.m, spec.n
    r0, r1 = p, p + m                      # domain rows in frame coords
    f = frame
    if boundary in (Boundary.ZERO, Boundary.NAN):
        fill = 0.0 if boundary is Boundary.ZERO else float("nan")
        f[..., r0:r1, 0:p] = fill
        f[..., r0:r1, p + n:p + n + p] = fill
        f[..., 0:p, :] = fill
        f[..., r1:r1 + p, :] = fill
        return frame
    if boundary is Boundary.REFLECT:
        # ghost col p-d mirrors domain col p+d (no edge repeat)
        f[..., r0:r1, 0:p] = f[..., r0:r1, p + 1:2 * p + 1].flip(-1)
        f[..., r0:r1, p + n:p + n + p] = \
            f[..., r0:r1, p + n - 1 - p:p + n - 1].flip(-1)
        f[..., 0:p, :] = f[..., p + 1:2 * p + 1, :].flip(-2)
        f[..., r1:r1 + p, :] = f[..., r1 - 1 - p:r1 - 1, :].flip(-2)
        return frame
    if boundary is Boundary.WRAP:
        # source and target strips never overlap (pad < min(m, n))
        f[..., r0:r1, 0:p] = f[..., r0:r1, n:p + n]
        f[..., r0:r1, p + n:p + n + p] = f[..., r0:r1, p:2 * p]
        f[..., 0:p, :] = f[..., r1 - p:r1, :]
        f[..., r1:r1 + p, :] = f[..., p:2 * p, :]
        return frame
    raise ValueError(boundary)


def unframe(frame: torch.Tensor, spec: FrameSpec) -> torch.Tensor:
    """The (m, n) domain of ``frame`` (a view; per lane for a stack)."""
    p = spec.pad
    return frame[..., p:p + spec.m, p:p + spec.n]


# ---------------------------------------------------------------------------
# Lane frames — the stacked carry of the 1:1 farm (twin of the reference's
# lane half of frames.py).  ``lanes`` independent frames of one
# :class:`FrameSpec` live in one (lanes, H, W) tensor; the kernels sweep all
# lanes in one launch.  Slots are allocated once and refilled in place with
# the next items' interiors (O(m·n) write + O(m+n) ghost refresh per lane,
# no re-framing); stale round-up cells of an earlier item are inert, as in
# :func:`refresh_frame`.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LaneFrameSpec:
    """Static geometry of a lane stack: ``lanes`` frames of ``frame``."""

    lanes: int
    frame: FrameSpec

    @property
    def shape(self) -> tuple[int, int, int]:
        return (self.lanes, *self.frame.shape)


def alloc_lane_frames(lspec: LaneFrameSpec, dtype,
                      device=None) -> torch.Tensor:
    """Allocate the lane slots (zeros) — once, at stream start."""
    return torch.zeros(lspec.shape, dtype=dtype, device=device)


def make_lane_frames(a: torch.Tensor, spec: FrameSpec,
                     boundary: Boundary | str) -> torch.Tensor:
    """Embed a (lanes, m, n) stack into lane frames (one-shot staging)."""
    frames = alloc_lane_frames(LaneFrameSpec(a.shape[0], spec), a.dtype,
                               a.device)
    return refill_lane_frames(frames, a, spec, boundary)


def refill_lane_frames(frames: torch.Tensor, interiors: torch.Tensor,
                       spec: FrameSpec,
                       boundary: Boundary | str) -> torch.Tensor:
    """Refill the lane slots in place with the next items' (lanes, m, n)
    interiors, then re-assert every lane's ghost ring."""
    p = spec.pad
    frames[:, p:p + spec.m, p:p + spec.n] = interiors
    return refresh_frame(frames, spec, boundary)


def _env_ghost(boundary: Boundary | str) -> Boundary:
    """The ring of a halo env frame: wrapped under wrap, else zero (see
    :func:`frame_env`)."""
    b = Boundary(boundary)
    return b if b is Boundary.WRAP else Boundary.ZERO


def alloc_lane_env(lspec: LaneFrameSpec, dtype, halo: bool = False,
                   device=None) -> torch.Tensor:
    """Zero-allocate the per-lane env slots, in :func:`frame_env`'s layout:
    block-rounded interior, or the full frame with ``halo``."""
    shape = lspec.frame.shape if halo else lspec.frame.interior
    return torch.zeros((lspec.lanes, *shape), dtype=dtype, device=device)


def lane_env_frames(e: torch.Tensor, spec: FrameSpec,
                    boundary: Boundary | str,
                    halo: bool = False) -> torch.Tensor:
    """Stage a (lanes, m, n) stack of per-lane env fields (one-shot)."""
    slots = alloc_lane_env(LaneFrameSpec(e.shape[0], spec), e.dtype, halo,
                           e.device)
    return refill_lane_env(slots, e, spec, boundary, halo)


def refill_lane_env(env_frames: torch.Tensor, e: torch.Tensor,
                    spec: FrameSpec, boundary: Boundary | str,
                    halo: bool = False) -> torch.Tensor:
    """Refill the env slots in place for the next items — an interior
    write, plus the ghost ring with ``halo``."""
    if not halo:
        env_frames[:, :spec.m, :spec.n] = e
        return env_frames
    p = spec.pad
    env_frames[:, p:p + spec.m, p:p + spec.n] = e
    return refresh_frame(env_frames, spec, _env_ghost(boundary))


# ---------------------------------------------------------------------------
# Continuous refills — the streaming farm's in-place slot hand-offs (twins of
# the reference's single-device refills).  A finished slot gets the next
# item's interior by one ``copy_`` into its domain view (or, chained, every
# taken slot at once by a select under a (lanes,) mask), then the ghost ring
# is re-asserted from the new interior.  No frame is allocated.
# ---------------------------------------------------------------------------


def refill_slot_frame(frames: torch.Tensor, interior: torch.Tensor, idx: int,
                      spec: FrameSpec,
                      boundary: Boundary | str) -> torch.Tensor:
    """Refill ONE lane slot ``idx`` in place with the next item's (m, n)
    interior and re-assert that lane's ghost ring (the other lanes' rings
    already agree with their domains)."""
    p = spec.pad
    frames[idx, p:p + spec.m, p:p + spec.n] = interior
    refresh_frame(frames[idx], spec, boundary)
    return frames


def refill_slot_env(env_frames: torch.Tensor, e: torch.Tensor, idx: int,
                    spec: FrameSpec, boundary: Boundary | str,
                    halo: bool = False) -> torch.Tensor:
    """Refill ONE lane's env slot in place (:func:`frame_env`'s layout):
    an interior write, plus the ghost ring with ``halo``."""
    off = spec.pad if halo else 0
    env_frames[idx, off:off + spec.m, off:off + spec.n] = e
    if halo:
        refresh_frame(env_frames[idx], spec, _env_ghost(boundary))
    return env_frames


def _masked_interior_write(slots: torch.Tensor, take: torch.Tensor,
                           new: torch.Tensor, off: int, m: int, n: int):
    cur = slots[:, off:off + m, off:off + n]
    cur.copy_(torch.where(take.reshape(-1, 1, 1), new.to(slots.dtype), cur))


def refill_lanes_masked(frames: torch.Tensor, take: torch.Tensor,
                        interiors: torch.Tensor, spec: FrameSpec,
                        boundary: Boundary | str) -> torch.Tensor:
    """Masked batch refill: the slots where the (lanes,) bool ``take`` is
    set receive ``interiors`` (a (lanes, m, n) stack; rows of untaken
    lanes are ignored), the others keep their interiors bit for bit; then
    every ghost ring is re-asserted (a no-op value-wise for untaken
    lanes).  In place; returns ``frames``."""
    _masked_interior_write(frames, take, interiors, spec.pad, spec.m, spec.n)
    return refresh_frame(frames, spec, boundary)


def refill_lanes_env_masked(env_frames: torch.Tensor, take: torch.Tensor,
                            e: torch.Tensor, spec: FrameSpec,
                            boundary: Boundary | str,
                            halo: bool = False) -> torch.Tensor:
    """Masked batch env refill (twin of :func:`refill_lanes_masked` for
    :func:`frame_env`'s layout)."""
    _masked_interior_write(env_frames, take, e, spec.pad if halo else 0,
                           spec.m, spec.n)
    if halo:
        refresh_frame(env_frames, spec, _env_ghost(boundary))
    return env_frames


# ---------------------------------------------------------------------------
# Staging ring — the device-resident refill queue of the chained path: the
# host writes the next K items' prepped (m, n) interiors (and env fields)
# ahead of need, and the chained segment seats finished slots from it by a
# device-side read cursor.  The ring holds logical interiors, not frames:
# the masked refill re-derives ghosts exactly as a host-admitted item's.
# ---------------------------------------------------------------------------


def alloc_stage_ring(depth: int, entry_shape: tuple, dtype,
                     device=None) -> torch.Tensor:
    """Allocate a depth-K staging ring of per-item entries (zeros) —
    once, at stream start."""
    return torch.zeros((depth, *entry_shape), dtype=dtype, device=device)


def stage_ring_write(ring: torch.Tensor, entry: torch.Tensor,
                     pos: int) -> torch.Tensor:
    """Write one prepped entry at ring position ``pos``, in place."""
    ring[pos] = entry
    return ring


# ---------------------------------------------------------------------------
# Sharded frames — the 1:n deployment of the persistent-halo engine (twin of
# the reference's sharded half).  Each shard carries its own frame on its own
# device; the shards of one grid travel together as a list in mesh order
# (:mod:`repro_torch.sharding.specs`).  The ghost ring is re-asserted by
# ``copy_`` of O(pad·n) edge strips straight from the neighbour's frame into
# this one's ring (a peer-to-peer copy across cards, an on-card copy where
# two shards share a card: the reference's ppermute), with the global ⊥
# model applied only on shards at the global edge.  With temporal blocking
# (pad = k·T) one exchange feeds T fused sweeps.
# ---------------------------------------------------------------------------

# strip copies between two shards' frames and the cells they moved, counted
# by the exchange where it copies (local ⊥ fills are not counted);
# chip_smoke.py reads them around its sharded runs
exchange_counts = {"strips": 0, "cells": 0}


@dataclasses.dataclass(frozen=True)
class ShardedFrameSpec:
    """Per-shard frame geometry plus its embedding in the device mesh.

    ``local`` is the shard's own :class:`FrameSpec` (``m``/``n`` are the
    LOCAL domain extents); ``axis_names[ax]`` is the mesh axis that
    decomposes array axis ``ax`` (None = not decomposed), ``sizes[ax]`` its
    arity and ``strides[ax]`` the step in the shard index between
    neighbours along it (0 when not decomposed).
    """

    local: FrameSpec
    axis_names: tuple          # per array axis: mesh axis name or None
    sizes: tuple               # per array axis: mesh axis arity (1 if local)
    strides: tuple             # per array axis: shard-index step (0 if local)

    def coord(self, index: int, axis: int) -> int:
        """Shard ``index``'s coordinate along array ``axis``."""
        if self.strides[axis] == 0:
            return 0
        return (index // self.strides[axis]) % self.sizes[axis]

    def neighbour(self, index: int, axis: int, step: int) -> int:
        """The shard ``step`` (±1) away along array ``axis``, on the ring."""
        c = self.coord(index, axis)
        to = (c + step) % self.sizes[axis]
        return index + (to - c) * self.strides[axis]


def sharded_frame_spec(lm: int, ln: int, part, *, k: int = 1,
                       block=DEFAULT_BLOCK, sweeps: int = 1
                       ) -> ShardedFrameSpec:
    """Frame geometry for one shard of an (lm·P, ln·Q) global domain under
    ``part`` (a :class:`repro_torch.sharding.GridPartition`).  The ghost
    ring must fit inside the *local* domain (pad = k·sweeps < min(lm, ln))
    — deep temporal blocking wants coarse shards."""
    names, sizes, strides = [None, None], [1, 1], [0, 0]
    for name, ax in zip(part.axis_names, part.array_axes):
        if ax not in (0, 1):
            raise ValueError(f"sharded frames are 2-D; array axis {ax}")
        names[ax] = name
        sizes[ax] = part.axis_size(name)
        strides[ax] = part.stride(name)
    spec = frame_spec(lm, ln, k=k, block=block, sweeps=sweeps)
    return ShardedFrameSpec(local=spec, axis_names=tuple(names),
                            sizes=tuple(sizes), strides=tuple(strides))


def _strip(frame, axis, lo, hi, olo, ohi):
    """The view frame[lo:hi] along ``axis``, [olo:ohi] along the other
    (the frame's last two dims: a lane stack's every lane at once)."""
    idx = [slice(olo, ohi), slice(olo, ohi)]
    idx[axis] = slice(lo, hi)
    return frame[(Ellipsis, *idx)]


def _edge_fill(frame, spec: FrameSpec, axis: int, boundary: Boundary,
               olo: int, ohi: int, low: bool) -> None:
    """⊥ on one side of one axis, from the frame itself: the constant, the
    mirror of domain rows d0+1…d0+p (or their high twins), or the wrap."""
    p = spec.pad
    d0, d1 = p, p + (spec.m if axis == 0 else spec.n)
    dst = _strip(frame, axis, 0, p, olo, ohi) if low else \
        _strip(frame, axis, d1, d1 + p, olo, ohi)
    if boundary in (Boundary.ZERO, Boundary.NAN):
        dst.fill_(0.0 if boundary is Boundary.ZERO else float("nan"))
    elif boundary is Boundary.REFLECT:
        src = _strip(frame, axis, d0 + 1, d0 + 1 + p, olo, ohi) if low \
            else _strip(frame, axis, d1 - 1 - p, d1 - 1, olo, ohi)
        dst.copy_(src.flip(axis - 2))
    elif boundary is Boundary.WRAP:
        dst.copy_(_strip(frame, axis, d1 - p, d1, olo, ohi) if low
                  else _strip(frame, axis, d0, d0 + p, olo, ohi))
    else:
        raise ValueError(boundary)


def _exchange_axis(frames, sspec: ShardedFrameSpec, axis: int,
                   boundary: Boundary, olo: int, ohi: int) -> None:
    """One axis's ghost strips of every shard, restricted to [olo:ohi]
    along the other axis: my last ``pad`` domain rows go into the next
    shard's leading ghost strip and my first ``pad`` into the previous
    one's trailing strip.  Global-edge shards fill the missing side from
    the ⊥ model; WRAP closes the ring (on an axis of one shard it exchanges
    with itself, which is the local wrap).  Every source is a domain strip
    and every target a ghost strip, so the copies of one pass commute."""
    spec = sspec.local
    p = spec.pad
    d0, d1 = p, p + (spec.m if axis == 0 else spec.n)
    nsh, decomposed = sspec.sizes[axis], sspec.axis_names[axis] is not None
    wrap = boundary is Boundary.WRAP
    for i, frame in enumerate(frames):
        c = sspec.coord(i, axis)
        for low, has in ((True, c > 0), (False, c < nsh - 1)):
            if not decomposed or not (has or wrap):
                _edge_fill(frame, spec, axis, boundary, olo, ohi, low)
                continue
            src = frames[sspec.neighbour(i, axis, -1 if low else 1)]
            dst = _strip(frame, axis, 0, p, olo, ohi) if low else \
                _strip(frame, axis, d1, d1 + p, olo, ohi)
            dst.copy_(_strip(src, axis, d1 - p, d1, olo, ohi) if low
                      else _strip(src, axis, d0, d0 + p, olo, ohi))
            exchange_counts["strips"] += 1
            exchange_counts["cells"] += dst.numel()


def refresh_frames_sharded(frames, sspec: ShardedFrameSpec,
                           boundary: Boundary | str):
    """Re-assert every shard's ghost ring, in place — the loop body's
    exchange.  Returns ``frames`` (a list in mesh order).  Each shard's
    frame may be a lane stack (leading lane axis, the same lanes on every
    shard): one strip copy then moves that strip of every lane.

    Axis 0 strips span the domain's columns; then axis 1 strips run the
    full frame height, so corner ghosts come from the diagonal neighbour
    (the reference's two-pass order, which is not :func:`refresh_frame`'s:
    axis 0 must be done on every shard before axis 1 reads a ghost row).
    Copies across devices order themselves against both devices' current
    streams; nothing here synchronises the host.
    """
    boundary = Boundary(boundary)
    spec = sspec.local
    p = spec.pad
    extents = ((p, p + spec.n), (0, spec.shape[0]))
    for axis in (0, 1):
        _exchange_axis(frames, sspec, axis, boundary, *extents[axis])
    return frames


def make_frames_sharded(blocks, sspec: ShardedFrameSpec,
                        boundary: Boundary | str) -> list:
    """Embed each shard's block (mesh order) into a frame on its device
    and exchange the ghosts.  Runs once, before the loop."""
    spec = sspec.local
    p = spec.pad
    frames = []
    for blk in blocks:
        frame = torch.zeros(spec.shape, dtype=blk.dtype, device=blk.device)
        frame[p:p + spec.m, p:p + spec.n] = blk
        frames.append(frame)
    return refresh_frames_sharded(frames, sspec, boundary)


def frame_env_sharded(blocks, sspec: ShardedFrameSpec,
                      boundary: Boundary | str, halo: bool = False) -> list:
    """Stage each shard's slice of a read-only env field, once.

    Without ``halo`` each slice is block-rounded only (interior layout) and
    is never exchanged.  With ``halo`` (temporal blocking) the ghost strips
    hold the *neighbour's* env — intermediate sweeps evaluate ``f`` on
    ghost cells that are real cells of the adjacent shard — through the
    same exchange; at global edges the ring is zero except under WRAP, as
    in :func:`frame_env`.
    """
    if not halo:
        return [frame_env(b, sspec.local, boundary) for b in blocks]
    return make_frames_sharded(blocks, sspec, _env_ghost(boundary))


# ---------------------------------------------------------------------------
# Sharded lane refills — the composed lanes x spatial farm's slot hand-offs
# (twins of the reference's ``refill_*_sharded``).  One lane shard's slots
# are a lane stack (lanes, fm, fn) on each spatial shard; a refill writes
# every spatial shard's block of the new interior, then re-asserts the ghost
# strips of every spatial shard through the loop body's exchange, on the
# refilled lanes only (the other lanes' rings already agree with their
# domains).  The reference's owner mask is host arithmetic here: the caller
# passes the owner lane shard's stacks (:func:`repro_torch.sharding.
# local_slot`).
# ---------------------------------------------------------------------------


def refill_lane_frames_sharded(frames, interiors, sspec: ShardedFrameSpec,
                               boundary: Boundary | str) -> list:
    """Write each spatial shard's (lanes, lm, ln) block of the next items
    into its lane stack (lists in mesh order, the lane counts equal), then
    exchange the ghosts of every lane.  In place; returns ``frames``."""
    p = sspec.local.pad
    for fr, blk in zip(frames, interiors):
        fr[..., p:p + sspec.local.m, p:p + sspec.local.n] = blk
    return refresh_frames_sharded(frames, sspec, boundary)


def refill_lane_env_sharded(env_frames, e, sspec: ShardedFrameSpec,
                            boundary: Boundary | str,
                            halo: bool = False) -> list:
    """Sharded twin of :func:`refill_lane_env`: each spatial shard's env
    block into its env lane stack; with ``halo`` the ghost strips hold the
    neighbour's env through the exchange (:func:`frame_env_sharded`)."""
    if not halo:
        for ef, blk in zip(env_frames, e):
            ef[..., :sspec.local.m, :sspec.local.n] = blk
        return env_frames
    return refill_lane_frames_sharded(env_frames, e, sspec,
                                      _env_ghost(boundary))


def refill_slot_frame_sharded(frames, interiors, li: int,
                              sspec: ShardedFrameSpec,
                              boundary: Boundary | str) -> list:
    """Refill lane slot ``li`` of one lane shard's stacks with each
    spatial shard's (lm, ln) block of the next item, then re-assert that
    lane's ghost strips on EVERY spatial shard (a neighbour's ghost rows
    read this lane's new domain).  In place; returns ``frames``."""
    refill_lane_frames_sharded([fr[li:li + 1] for fr in frames],
                               [blk[None] for blk in interiors], sspec,
                               boundary)
    return frames


def refill_slot_env_sharded(env_frames, e, li: int, sspec: ShardedFrameSpec,
                            boundary: Boundary | str,
                            halo: bool = False) -> list:
    """Single-slot twin of :func:`refill_lane_env_sharded`."""
    refill_lane_env_sharded([ef[li:li + 1] for ef in env_frames],
                            [blk[None] for blk in e], sspec, boundary, halo)
    return env_frames


def shard_domain_bounds(sspec: ShardedFrameSpec, index: int) -> tuple:
    """``(row_lo, row_hi, col_lo, col_hi)`` of the GLOBAL domain in shard
    ``index``'s frame coordinates, as host ints (the mesh coordinates are
    known on the host).  Sides that continue into a neighbour shard get
    ±2^30 sentinels, so the multistep kernel's per-sweep ⊥ re-assertion
    never fires there: those ghost cells are real cells of the neighbour
    and evolve freely."""
    spec = sspec.local
    big = 1 << 30
    p = spec.pad
    out = []
    for axis, dom in enumerate((spec.m, spec.n)):
        c = sspec.coord(index, axis)
        out += [p if c == 0 else -big,
                p + dom if c == sspec.sizes[axis] - 1 else big]
    return tuple(out)
