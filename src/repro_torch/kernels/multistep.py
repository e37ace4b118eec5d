"""Temporal blocking: T fused sweeps per device-memory round trip.

PyTorch/CUDA twin of :mod:`repro.kernels.multistep`.  The TPU kernel
``_ms_kernel`` becomes the hand-written CUDA kernel of ``csrc/window.cuh``
(entry point ``csrc/multistep.cu``, built at first use by :mod:`._build`):
persistent CTAs walk output tiles of the kernel's own size
(:func:`~repro_torch.kernels.stencil2d.cta_tile`); each tile's (tm+2kT,
tn+2kT) window of the frame, and of every env field, is staged in shared
memory while the previous tile sweeps, T sweeps run there with the valid
region shrinking by k a side per sweep, ⊥ is re-asserted after every sweep,
the last sweep writes the tile's final values and folds ``measure(last,
second last)`` over the domain cells — per-CTA partials combined by the last
CTA in the same launch, as in :mod:`.stencil2d`.

* :func:`stencil2d_multistep_framed` — frame in (pad = k·T), frame out; on a
  CUDA tensor it launches the kernel (or raises), on a CPU tensor it runs
  the plain version.
* :func:`stencil2d_multistep_framed_ref` — the same function in torch ops,
  on the whole frame: T sweeps over a region that shrinks by k a side each
  sweep, ⊥ re-asserted in global frame coordinates after each.  Every cell's
  value depends only on its global coordinates, so this global realisation
  equals the tiled one on every output cell.
* :func:`stencil2d_multistep` — one-shot (m, n) → (m, n).

Env fields are full halo frames (:func:`repro_torch.core.frames.frame_env`
with ``halo=True``): intermediate sweeps evaluate ``f`` on ghost cells.  ⊥
is re-asserted against ``domain_bounds`` (frame rows [row_lo, row_hi) ×
cols [col_lo, col_hi)), by default the domain itself; a sharded caller
passes ±2^30 sentinels on interior sides, where ghost cells are real
neighbour cells.  zero/nan fill the cells outside, reflect mirrors rows then
columns, wrap does nothing.  Block round-up cells lie outside the domain and
are re-asserted too (the single-step kernel writes ``f`` there), so the two
kernels agree on the domain only.

Frames are float32 or bfloat16 and may be lane stacks with ``live`` flags,
as for :func:`repro_torch.kernels.stencil2d.stencil2d_fused_framed`.  The
kernel rounds every sweep's values to the frame's dtype as it stores them,
so a bf16 frame gives what T single-step launches give; against the plain
version (rounding after every torch op) bf16 agrees within 5e-2.
"""
from __future__ import annotations

import ctypes
from typing import Callable, Optional

import torch

from ..core.frames import (DEFAULT_BLOCK, FrameSpec, frame_env, frame_spec,
                           make_frame, unframe)
from ..core.reduce import resolve_monoid, tree_reduce
from ..core.semantics import Boundary
from . import stencil2d as _single
from .stencil2d import (DTYPE_IDS, MONOID_IDS, SMEM_BYTES, _check_frame,
                        _identity_scalar, check_kernel_operands,
                        check_pair_layout, decode_result, kernel_descriptor,
                        lanes_ref, launch_counts, live_pointer,
                        reduce_operands, resolve_tile)

# boundary names → ids of the ``BoundaryId`` enum in csrc/window.cuh
BOUNDARY_IDS = {"zero": 0, "nan": 1, "reflect": 2, "wrap": 3}
# the sharded deployment's "no edge on this side" bound
SENTINEL = 1 << 30


def window_bytes(spec: FrameSpec, n_env: int, tile, itemsize: int = 4,
                 boundary="zero", ring: int = 2) -> int:
    """Shared memory of one CTA of a T-sweep launch on ``spec`` (pad k·T)
    with the kernel's CTA ``tile`` (tm, tn): ``ring`` slots of the
    (tm+2kT, tn+2kT) window of the frame and of each env field (full halo
    frames), and a work buffer when T > 1 or the boundary reflects."""
    T = spec.pad // spec.k
    return _single.window_bytes(
        tile, spec.pad, n_env, itemsize, env_halo=True, ring=ring,
        work=T > 1 or Boundary(boundary) is Boundary.REFLECT)


def _bounds(spec: FrameSpec, domain_bounds) -> tuple:
    """(row_lo, row_hi, col_lo, col_hi) in frame coordinates.  Host ints
    pass straight through (the sharded engine's; a device tensor would cost
    a host sync a launch)."""
    if domain_bounds is None:
        p = spec.pad
        return p, p + spec.m, p, p + spec.n
    if isinstance(domain_bounds, (tuple, list)):
        b = [int(v) for v in domain_bounds]
    else:
        b = [int(v) for v in
             torch.as_tensor(domain_bounds).reshape(-1).tolist()]
    if len(b) != 4:
        raise ValueError(f"domain_bounds must hold 4 ints; got {b}")
    return tuple(b)


class _ShrinkTaps:
    """Taps over a frame-sized iterate for the region whose origin is
    (lo, lo) and whose size is (rows, cols)."""

    def __init__(self, cur, lo, rows, cols):
        self._c, self._lo, self._r, self._n = cur, lo, rows, cols

    def __call__(self, di, dj):
        r, c = self._lo + di, self._lo + dj
        return self._c[r:r + self._r, c:c + self._n]

    @property
    def center(self):
        return self(0, 0)


def fix_boundary_ref(new: torch.Tensor, base: int, bounds,
                     boundary: Boundary) -> torch.Tensor:
    """Re-assert ⊥ on the cells of ``new`` (a region whose [0, 0] sits at
    frame coordinates (base, base)) that lie outside ``bounds``.  Reflect
    takes a cell's mirror image only where it lies in the domain and in the
    region — always so for a cell that reaches an output tile; the kernel
    applies the same rule."""
    if boundary is Boundary.WRAP:
        return new
    row_lo, row_hi, col_lo, col_hi = bounds
    R, C = new.shape
    rows = base + torch.arange(R, device=new.device)
    cols = base + torch.arange(C, device=new.device)
    if boundary in (Boundary.ZERO, Boundary.NAN):
        inside = (((rows >= row_lo) & (rows < row_hi))[:, None]
                  & ((cols >= col_lo) & (cols < col_hi))[None, :])
        fill = 0.0 if boundary is Boundary.ZERO else float("nan")
        return torch.where(inside, new, torch.full((), fill, dtype=new.dtype,
                                                   device=new.device))

    def mirror_index(g, lo, hi, size):
        src = torch.where(g < lo, 2 * lo - g,
                          torch.where(g >= hi, 2 * (hi - 1) - g, g))
        take = ((g < lo) | (g >= hi)) & (src >= lo) & (src < hi) \
            & (src - base >= 0) & (src - base < size)
        return torch.where(take, src - base, g - base)

    new = new.index_select(0, mirror_index(rows, row_lo, row_hi, R))
    return new.index_select(1, mirror_index(cols, col_lo, col_hi, C))


def stencil2d_multistep_framed_ref(frame: torch.Tensor, f: Callable,
                                   spec: FrameSpec, *, T: int,
                                   env_framed=(), combine="sum",
                                   identity=None,
                                   measure: Optional[Callable] = None,
                                   boundary="zero", domain_bounds=None,
                                   acc_dtype=torch.float32,
                                   out: Optional[torch.Tensor] = None,
                                   live: Optional[torch.Tensor] = None):
    """Plain version of :func:`stencil2d_multistep_framed`: T sweeps on the
    whole frame in torch ops.  Returns ``(out, reduced)``; ``out``'s ghost
    ring is left as it was (zeros when ``out`` is allocated here).  A lane
    stack runs lane by lane."""
    _check_pad(spec, T)
    lanes = _check_frame(frame, spec, out)
    op, ident = resolve_monoid(combine, identity)
    if lanes is not None:
        return lanes_ref(
            lambda fr, env, o: stencil2d_multistep_framed_ref(
                fr, f, spec, T=T, env_framed=env, combine=combine,
                identity=identity, measure=measure, boundary=boundary,
                domain_bounds=domain_bounds, acc_dtype=acc_dtype, out=o),
            frame, env_framed, out, live,
            _identity_scalar(ident, acc_dtype, frame.device))
    b = Boundary(boundary)
    bounds = _bounds(spec, domain_bounds)
    k = spec.k
    H, W = spec.shape
    cur = prev = frame
    for s in range(T):
        lo = k * (s + 1)
        R, C = H - 2 * lo, W - 2 * lo
        envs = [e[lo:lo + R, lo:lo + C] for e in env_framed]
        new = f(_ShrinkTaps(cur, lo, R, C), *envs).to(frame.dtype)
        nxt = cur.clone()
        nxt[lo:lo + R, lo:lo + C] = fix_boundary_ref(new, lo, bounds, b)
        prev, cur = cur, nxt
    if out is None:
        out = torch.zeros_like(frame)
    p = spec.pad
    mi, ni = spec.interior
    last = cur[p:p + mi, p:p + ni]
    out[p:p + mi, p:p + ni] = last
    meas = measure(last, prev[p:p + mi, p:p + ni]) if measure is not None \
        else last
    red = tree_reduce(op, meas[:spec.m, :spec.n].to(acc_dtype), ident)
    return out, red


def _check_pad(spec: FrameSpec, T: int) -> None:
    if T < 1 or spec.pad != spec.k * T:
        raise ValueError(
            f"a {T}-sweep window needs a frame of pad k*T = {spec.k * T}; "
            f"got pad {spec.pad} (frame_spec(..., sweeps=T))")


def stencil2d_multistep_framed(frame: torch.Tensor, f: Callable,
                               spec: FrameSpec, *, T: int, env_framed=(),
                               combine="sum", identity=None,
                               measure: Optional[Callable] = None,
                               boundary="zero", domain_bounds=None,
                               acc_dtype=torch.float32,
                               out: Optional[torch.Tensor] = None,
                               scratch: Optional[tuple] = None,
                               live: Optional[torch.Tensor] = None,
                               tile: Optional[tuple] = None):
    """T fused sweeps on a persistent halo frame — frame in, frame out.

    ``spec`` must have ``pad == k*T``; ``env_framed`` are full halo frames
    (``frame_env(..., halo=True)``), stacked like the frame.  Returns
    ``(out, reduced)``: ``out`` (a second frame, allocated when not given)
    holds the T-th iterate in its interior and an unrefreshed ghost ring;
    ``reduced`` is ``/(⊕) : measure(last, second last)`` over the domain.
    ``domain_bounds`` (4 host ints, or a (1, 4) tensor, read to the host)
    overrides where ⊥ sees the domain edge.  ``scratch`` is
    :func:`repro_torch.kernels.stencil2d.alloc_scratch`'s.  ``tile`` forces
    the kernel's CTA tile, as for the single-step wrapper.

    On a CUDA tensor this launches the kernel — with the same requirements
    as the single-step kernel; the CTA tile shrinks until its window fits a
    block's shared memory (:func:`window_bytes`), which fails only past
    what an 8x32 tile can hold — or raises.  On a CPU tensor it runs
    :func:`stencil2d_multistep_framed_ref`.
    """
    _check_pad(spec, T)
    kw = dict(T=T, env_framed=env_framed, combine=combine,
              identity=identity, measure=measure, boundary=boundary,
              domain_bounds=domain_bounds, acc_dtype=acc_dtype, out=out,
              live=live)
    if frame.device.type == "cpu":
        return stencil2d_multistep_framed_ref(frame, f, spec, **kw)
    if frame.device.type != "cuda":
        raise ValueError(f"no kernel for device {frame.device}")
    el, mid, mname = kernel_descriptor(f, measure, combine, identity)
    lanes = _check_frame(frame, spec, out)
    check_kernel_operands(frame, env_framed, frame.shape, acc_dtype, out,
                          "halo frame")
    if el.k > spec.k:
        raise ValueError(
            f"elemental radius {el.k} exceeds the frame's k={spec.k}")
    if len(env_framed) != el.n_env:
        raise ValueError(
            f"{el.functor} reads {el.n_env} env fields; got "
            f"{len(env_framed)}")
    check_pair_layout(spec, frame, *env_framed)
    reflect = Boundary(boundary) is Boundary.REFLECT
    tm, tn, ring = resolve_tile(tile, spec, lanes, el, frame, env_halo=True,
                                work=T > 1 or reflect, T=T)
    need = window_bytes(spec, el.n_env, (tm, tn), frame.element_size(),
                        boundary, ring)
    if need > SMEM_BYTES:
        raise ValueError(
            f"the {tm + 2 * spec.pad}x{tn + 2 * spec.pad} window of a "
            f"{tm}x{tn} tile at k*T={spec.pad} with {el.n_env} env fields "
            f"needs {need} bytes of shared memory; a block has "
            f"{SMEM_BYTES}.  Lower unroll or the tile")
    if out is None:
        out = torch.empty_like(frame)
    live, live_ptr = live_pointer(live, lanes, frame.device)
    result, ptrs = reduce_operands(spec, lanes, frame.device, scratch)
    envs = [e.data_ptr() for e in env_framed] + [None] * (2 - el.n_env)
    params = (ctypes.c_float * max(len(el.params), 1))(*el.params)
    mi, ni = spec.interior

    from . import _build
    lib = _build.library()
    rc = lib.multistep_sweep(
        el.functor_id, el.k, DTYPE_IDS[frame.dtype], params,
        len(el.params), frame.data_ptr(), out.data_ptr(), envs[0], envs[1],
        spec.shape[1], lanes or 1, spec.k, T, mi, ni, spec.m, spec.n, tm, tn,
        ring, *_bounds(spec, domain_bounds),
        BOUNDARY_IDS[Boundary(boundary).value], MONOID_IDS[mname], mid,
        live_ptr, *ptrs,
        torch.cuda.current_stream(frame.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"multistep_sweep launch failed ({rc}): "
            f"{lib.stencil_error_string(rc).decode()}")
    launch_counts["multistep_sweep"] += 1
    return out, decode_result(result, mname)


def stencil2d_multistep(a: torch.Tensor, f: Callable, *, env=(), k: int = 1,
                        T: int = 4, combine="sum", identity=None,
                        measure: Optional[Callable] = None,
                        boundary: str = "zero", block=DEFAULT_BLOCK,
                        acc_dtype=torch.float32):
    """T fused sweeps over a 2-D array: frames it (pad k·T), runs
    :func:`stencil2d_multistep_framed` once and slices the domain back.
    Returns ``(array after T sweeps, /(⊕) of measure(last, second
    last))``."""
    m, n = a.shape
    spec = frame_spec(m, n, k=k, block=block, sweeps=T)
    frame = make_frame(a, spec, boundary)
    env_framed = tuple(frame_env(e, spec, boundary, halo=True) for e in env)
    out, red = stencil2d_multistep_framed(
        frame, f, spec, T=T, env_framed=env_framed, combine=combine,
        identity=identity, measure=measure, boundary=boundary,
        acc_dtype=acc_dtype)
    return unframe(out, spec).clone(), red
