"""Persistent halo frames — the device-resident grid layout of the engine.

PyTorch twin of the single-device half of :mod:`repro.core.frames`.  The
framed array is the loop-carried representation: the grid is staged into
it once (:func:`make_frame`), the kernel reads and writes it directly,
only the O(m+n) ghost ring is re-asserted between sweeps
(:func:`refresh_frame`), and the domain is sliced out once at the end
(:func:`unframe`).  :func:`refresh_frame` and :func:`unframe` also take a
lane stack of frames (leading lane axis), the carry of the lane farm
(:class:`LaneFrameSpec` and the ``*lane*`` helpers below).

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


def unframe_lanes(frames: torch.Tensor, spec: FrameSpec) -> torch.Tensor:
    """Every lane's (m, n) domain (a view)."""
    return unframe(frames, spec)


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
