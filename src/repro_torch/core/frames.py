"""Persistent halo frames — the device-resident grid layout of the engine.

PyTorch twin of the single-device half of :mod:`repro.core.frames`.  The
framed array is the loop-carried representation: the grid is staged into
it once (:func:`make_frame`), the kernel reads and writes it directly,
only the O(m+n) ghost ring is re-asserted between sweeps
(:func:`refresh_frame`), and the domain is sliced out once at the end
(:func:`unframe`).

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
axis by axis, like ``jnp.pad``).  The tile (bm, bn) is the CUDA kernel's
CTA tile; the reference's 8/128 clipping is a TPU tiling rule and does not
apply here (rows clip to a multiple of 8, columns to a warp of 32).
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
    bm: int         # tile rows (CTA tile of the kernel)
    bn: int         # tile cols
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
    b = Boundary(boundary)
    return make_frame(e, spec, b if b is Boundary.WRAP else Boundary.ZERO)


def refresh_frame(frame: torch.Tensor, spec: FrameSpec,
                  boundary: Boundary | str) -> torch.Tensor:
    """Re-assert the ⊥ ghost ring around the (m, n) domain, in place —
    four strip writes, O(m+n) cells.

    Column strips are filled from domain columns first, then row strips
    run full width over the column-refreshed frame, so corners compose
    like ``jnp.pad``.  Cells beyond the ``pad``-wide ring (deep round-up)
    are never read by a domain cell and are left as they are.
    """
    boundary = Boundary(boundary)
    p, m, n = spec.pad, spec.m, spec.n
    r0, r1 = p, p + m                      # domain rows in frame coords
    if boundary in (Boundary.ZERO, Boundary.NAN):
        fill = 0.0 if boundary is Boundary.ZERO else float("nan")
        frame[r0:r1, 0:p] = fill
        frame[r0:r1, p + n:p + n + p] = fill
        frame[0:p, :] = fill
        frame[r1:r1 + p, :] = fill
        return frame
    if boundary is Boundary.REFLECT:
        # ghost col p-d mirrors domain col p+d (no edge repeat)
        frame[r0:r1, 0:p] = frame[r0:r1, p + 1:2 * p + 1].flip(1)
        frame[r0:r1, p + n:p + n + p] = \
            frame[r0:r1, p + n - 1 - p:p + n - 1].flip(1)
        frame[0:p, :] = frame[p + 1:2 * p + 1, :].flip(0)
        frame[r1:r1 + p, :] = frame[r1 - 1 - p:r1 - 1, :].flip(0)
        return frame
    if boundary is Boundary.WRAP:
        # source and target strips never overlap (pad < min(m, n))
        frame[r0:r1, 0:p] = frame[r0:r1, n:p + n]
        frame[r0:r1, p + n:p + n + p] = frame[r0:r1, p:2 * p]
        frame[0:p, :] = frame[r1 - p:r1, :]
        frame[r1:r1 + p, :] = frame[p:2 * p, :]
        return frame
    raise ValueError(boundary)


def unframe(frame: torch.Tensor, spec: FrameSpec) -> torch.Tensor:
    """The (m, n) domain of ``frame`` (a view)."""
    p = spec.pad
    return frame[p:p + spec.m, p:p + spec.n]
