"""Fused stencil + reduce sweep on a persistent halo frame (paper §3.3 core).

PyTorch/CUDA twin of :mod:`repro.kernels.stencil2d`.  The TPU kernel
``_stencil_kernel`` becomes the hand-written CUDA kernel in
``csrc/stencil2d.cu`` (built at first use by :mod:`._build`): one sweep of
an elemental functor over the frame's block-rounded interior, written into
the same layout of a second frame (ghost ring untouched), with the
measure folded over the in-domain cells to one ⊕ scalar by per-tile
partials and a last-CTA combine in the same launch (deterministic, no
float atomics).

* :func:`stencil2d_fused_framed` — the zero-copy loop body: frame in,
  frame out.  On a CUDA tensor it launches the kernel (or raises); on a
  CPU tensor it runs the plain version, :func:`stencil2d_fused_framed_ref`.
* :func:`stencil2d_fused_framed_ref` — the same function in torch ops:
  taps are slices of the whole block-rounded interior and the reduce is
  masked to the domain.  The tests use it, and ``chip_smoke.py`` holds the
  kernel against it on the card.
* :func:`stencil2d_fused` — one-shot (m, n) → (m, n): frame, one sweep,
  unframe.

Frames are float32 or bfloat16 (env fields share the frame's dtype; the
reduce accumulates in float32).  The kernel widens bf16 taps to float,
computes the functor in float and rounds once on store; the plain version
runs torch ops on bf16 tensors and rounds after every op, so on bf16 the
two agree within a tolerance (5e-2, the reference's bf16 tolerance), and
bit for bit on float32.

The framed wrappers also take a **lane stack**: frames of shape
``(lanes, *spec.shape)`` (env fields stacked the same way) are swept by one
launch, ``blockIdx.z`` being the lane, and the reduce comes back per lane,
shape ``(lanes,)``.  ``live`` (a ``(lanes,)`` bool tensor) marks the lanes
to sweep; any other lane is copied through unchanged and its reduce is ⊕'s
identity — the lane farm's frozen lanes
(:meth:`repro_torch.core.pattern.LoopOfStencilReduce.farm_run`).
"""
from __future__ import annotations

import ctypes
from typing import Callable, Optional

import torch

from ..core.frames import (DEFAULT_BLOCK, FrameSpec, frame_env, frame_spec,
                           make_frame, unframe)
from ..core.reduce import monoid_name, resolve_monoid, tree_reduce
from .ref import FUNCTOR_IDS, MEASURE_IDS, Elemental, Measure

# monoid names → ids of the ``MonoidId`` enum in csrc/stencil2d.cu
MONOID_IDS = {"sum": 0, "prod": 1, "max": 2, "min": 3, "any": 4, "all": 5}

# storage dtypes of the kernels → the ``dtype`` argument of the C entries
DTYPE_IDS = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches, counted by each wrapper where it launches (and nowhere
# else), for this kernel and for ``multistep.stencil2d_multistep_framed``;
# chip_smoke.py zeroes them before the main path and reads them after
launch_counts = {"stencil_sweep": 0, "multistep_sweep": 0}


class FrameTaps:
    """Tap accessor over the whole block-rounded interior of a frame (the
    plain twin of the kernel's per-cell ``Taps``)."""

    def __init__(self, frame: torch.Tensor, spec: FrameSpec):
        self._f, self._spec = frame, spec

    def __call__(self, di: int, dj: int) -> torch.Tensor:
        s = self._spec
        if abs(di) > s.k or abs(dj) > s.k:
            raise ValueError(f"offset out of stencil radius k={s.k}")
        mi, ni = s.interior
        p = s.pad
        return self._f[p + di:p + di + mi, p + dj:p + dj + ni]

    @property
    def center(self) -> torch.Tensor:
        return self(0, 0)


def _identity_scalar(ident, acc_dtype, device) -> torch.Tensor:
    """⊕'s identity typed like the sweep's reduce output."""
    dtype = torch.bool if isinstance(ident, bool) else acc_dtype
    return torch.full((), ident, dtype=dtype, device=device)


def _check_frame(frame, spec, out) -> Optional[int]:
    """Validate a frame (or lane stack of frames) and ``out``; return the
    lane count, None for a single frame."""
    shape = tuple(frame.shape)
    if shape != spec.shape and shape[1:] != spec.shape:
        raise ValueError(
            f"frame shape {shape} != spec shape {spec.shape} (or a lane "
            "stack of it)")
    if out is not None and (tuple(out.shape) != shape
                            or out.data_ptr() == frame.data_ptr()):
        raise ValueError("out must be a second frame of the spec's shape")
    return shape[0] if len(shape) == 3 else None


def lanes_ref(one, frame, env_framed, out, live, ident):
    """Plain lane form of a framed sweep: ``one(frame_l, env_l, out_l) ->
    (out_l, reduced_l)`` lane by lane; a lane whose ``live`` flag is False
    is copied through and reduces to ``ident``."""
    if out is None:
        out = torch.zeros_like(frame)
    reds = []
    for lane in range(frame.shape[0]):
        if live is not None and not bool(live[lane]):
            out[lane] = frame[lane]
            reds.append(ident)
            continue
        _, red = one(frame[lane], tuple(e[lane] for e in env_framed),
                     out[lane])
        reds.append(red)
    return out, torch.stack(reds)


def check_kernel_operands(frame, env_framed, env_shape, acc_dtype, out,
                          what) -> None:
    """Dtype, device, shape and layout checks shared by the kernel
    wrappers: float32 or bfloat16 frames, a float32 accumulator, env fields
    of ``env_shape`` and the frame's dtype, contiguous."""
    if frame.dtype not in DTYPE_IDS or acc_dtype != torch.float32:
        raise ValueError(
            f"the CUDA sweep takes float32 or bfloat16 frames and a "
            f"float32 accumulator; got {frame.dtype} / {acc_dtype}")
    if not frame.is_contiguous():
        raise ValueError("frame must be contiguous")
    for e in env_framed:
        if (e.device != frame.device or e.dtype != frame.dtype
                or tuple(e.shape) != tuple(env_shape)
                or not e.is_contiguous()):
            raise ValueError(
                f"env fields must be contiguous {frame.dtype} tensors of "
                f"the {what} shape {tuple(env_shape)} on {frame.device}")
    if out is not None and (not out.is_contiguous()
                            or out.dtype != frame.dtype
                            or out.device != frame.device):
        raise ValueError("out must be a contiguous frame like `frame`")


def reduce_operands(spec, lanes, device, scratch):
    """(partials, ticket, result) pointers of one launch: the reduce
    scratch (allocated when not given) and a fresh result of one float per
    lane."""
    partials, ticket = (scratch if scratch is not None
                        else alloc_scratch(spec, device, lanes or 1))
    if partials.numel() < (lanes or 1) * spec.gm * spec.gn \
            or ticket.numel() < (lanes or 1):
        raise ValueError("scratch too small for this frame geometry")
    result = torch.empty((lanes,) if lanes else (), dtype=torch.float32,
                         device=device)
    return result, (partials.data_ptr(), ticket.data_ptr(),
                    result.data_ptr())


def live_pointer(live, lanes, device):
    """The kernel's per-lane live flags (None: every lane is live)."""
    if live is None:
        return None, None
    if lanes is None:
        raise ValueError("live flags need a lane stack of frames")
    live = live.to(device=device, dtype=torch.bool).contiguous()
    if live.shape != (lanes,):
        raise ValueError(f"live must have shape ({lanes},)")
    return live, live.data_ptr()


def decode_result(result, mname):
    """The kernel's float result as the reduce the plain version returns
    (bool monoids ride as {0, 1})."""
    return result >= 0.5 if mname in ("any", "all") else result


def stencil2d_fused_framed_ref(frame: torch.Tensor, f: Callable,
                               spec: FrameSpec, *, env_framed=(),
                               combine="sum", identity=None,
                               measure: Optional[Callable] = None,
                               acc_dtype=torch.float32, do_reduce=True,
                               out: Optional[torch.Tensor] = None,
                               live: Optional[torch.Tensor] = None):
    """Plain version of :func:`stencil2d_fused_framed`: same frame in, same
    frame out, in torch ops.  Returns ``(out, reduced)``; ``out``'s ghost
    ring is left as it was (zeros when ``out`` is allocated here).  A lane
    stack runs lane by lane."""
    lanes = _check_frame(frame, spec, out)
    op, ident = resolve_monoid(combine, identity)
    if lanes is not None:
        return lanes_ref(
            lambda fr, env, o: stencil2d_fused_framed_ref(
                fr, f, spec, env_framed=env, combine=combine,
                identity=identity, measure=measure, acc_dtype=acc_dtype,
                do_reduce=do_reduce, out=o),
            frame, env_framed, out, live,
            _identity_scalar(ident, acc_dtype, frame.device))
    taps = FrameTaps(frame, spec)
    new = f(taps, *env_framed)
    if out is None:
        out = torch.zeros_like(frame)
    mi, ni = spec.interior
    p = spec.pad
    out[p:p + mi, p:p + ni] = new
    if not do_reduce:
        return out, _identity_scalar(ident, acc_dtype, frame.device)
    meas = measure(new, taps.center) if measure is not None else new
    # masking to the domain ≡ dropping the round-up cells
    red = tree_reduce(op, meas[:spec.m, :spec.n].to(acc_dtype), ident)
    return out, red


def alloc_scratch(spec: FrameSpec, device, lanes: int = 1) -> tuple:
    """Reduce scratch of one frame geometry: per-tile partials and the
    last-CTA ticket of each lane (zeroed; the kernel leaves them zeroed)."""
    return (torch.empty(lanes * spec.gm * spec.gn, dtype=torch.float32,
                        device=device),
            torch.zeros(lanes, dtype=torch.int32, device=device))


def kernel_descriptor(f, measure, combine, identity) -> tuple:
    """Validate that the sweep has a CUDA realisation; return
    ``(elemental, measure_id, monoid_name)``.  Raises ``ValueError`` —
    before any launch — for a function without a descriptor."""
    if not isinstance(f, Elemental):
        raise ValueError(
            f"backend 'cuda' needs an elemental function with a CUDA "
            f"functor; got {f!r}.  Registered functors: "
            f"{sorted(FUNCTOR_IDS)} (factories in repro_torch.kernels.ref); "
            "run other functions on backend='torch'")
    if measure is not None and not isinstance(measure, Measure):
        raise ValueError(
            f"backend 'cuda' needs a registered measure; got {measure!r}.  "
            f"Registered measures: {sorted(MEASURE_IDS)}")
    op, _ = resolve_monoid(combine, identity)
    name = monoid_name(op)
    if name is None:
        raise ValueError(
            f"backend 'cuda' folds the named monoids {sorted(MONOID_IDS)} "
            f"only; got combine={combine!r}")
    mid = 0 if measure is None else measure.measure_id
    return f, mid, name


def stencil2d_fused_framed(frame: torch.Tensor, f: Callable, spec: FrameSpec,
                           *, env_framed=(), combine="sum", identity=None,
                           measure: Optional[Callable] = None,
                           acc_dtype=torch.float32, do_reduce: bool = True,
                           out: Optional[torch.Tensor] = None,
                           scratch: Optional[tuple] = None,
                           live: Optional[torch.Tensor] = None):
    """One fused sweep on a persistent halo frame — frame in, frame out.

    ``frame`` has the layout of ``spec``, or is a lane stack of such frames
    (see the module docstring; ``live`` applies to a stack);
    ``env_framed`` are block-rounded interior-only fields
    (:func:`repro_torch.core.frames.frame_env`), stacked like the frame.
    Returns ``(out, reduced)``: ``out`` (a second frame, allocated when not
    given) holds the sweep in its interior and an unrefreshed ghost ring;
    ``reduced`` is ``/(⊕) : measure(new, old_center)`` over the domain (of
    ``new`` when measure is None), or ⊕'s identity with ``do_reduce=False``.
    ``scratch`` (:func:`alloc_scratch`) lets a loop reuse the reduce
    buffers.

    On a CUDA tensor this launches the kernel — ``f`` must be an
    :class:`~repro_torch.kernels.ref.Elemental`, ``measure`` None or a
    :class:`~repro_torch.kernels.ref.Measure`, ``combine`` a named monoid,
    the frame float32 or bfloat16 — or raises.  On a CPU tensor it runs
    :func:`stencil2d_fused_framed_ref`.
    """
    if frame.device.type == "cpu":
        return stencil2d_fused_framed_ref(
            frame, f, spec, env_framed=env_framed, combine=combine,
            identity=identity, measure=measure, acc_dtype=acc_dtype,
            do_reduce=do_reduce, out=out, live=live)
    if frame.device.type != "cuda":
        raise ValueError(f"no kernel for device {frame.device}")
    el, mid, mname = kernel_descriptor(f, measure, combine, identity)
    lanes = _check_frame(frame, spec, out)
    env_shape = spec.interior if lanes is None else (lanes, *spec.interior)
    check_kernel_operands(frame, env_framed, env_shape, acc_dtype, out,
                          "interior")
    if el.k > spec.k:
        raise ValueError(
            f"elemental radius {el.k} exceeds the frame's k={spec.k}")
    if len(env_framed) != el.n_env:
        raise ValueError(
            f"{el.functor} reads {el.n_env} env fields; got "
            f"{len(env_framed)}")
    if out is None:
        out = torch.empty_like(frame)
    live, live_ptr = live_pointer(live, lanes, frame.device)
    _, ident = resolve_monoid(combine, identity)
    if do_reduce:
        result, ptrs = reduce_operands(spec, lanes, frame.device, scratch)
    else:
        ptrs = (None, None, None)
    envs = [e.data_ptr() for e in env_framed] + [None] * (2 - el.n_env)
    params = (ctypes.c_float * max(len(el.params), 1))(*el.params)

    from . import _build
    lib = _build.library()
    rc = lib.stencil_sweep(
        el.functor_id, el.k, DTYPE_IDS[frame.dtype], params,
        len(el.params), frame.data_ptr(), out.data_ptr(), envs[0], envs[1],
        spec.shape[1], lanes or 1, spec.pad, spec.gm, spec.gn, spec.bm,
        spec.bn, spec.m, spec.n, MONOID_IDS[mname], mid, int(do_reduce),
        live_ptr, *ptrs,
        torch.cuda.current_stream(frame.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"stencil_sweep launch failed ({rc}): "
            f"{lib.stencil_error_string(rc).decode()}")
    launch_counts["stencil_sweep"] += 1
    if not do_reduce:
        red = _identity_scalar(ident, acc_dtype, frame.device)
        return out, red if lanes is None else red.expand(lanes).clone()
    return out, decode_result(result, mname)


def stencil2d_fused(a: torch.Tensor, f: Callable, *, env=(), k: int = 1,
                    combine="sum", identity=None,
                    measure: Optional[Callable] = None,
                    boundary: str = "zero", block=DEFAULT_BLOCK,
                    acc_dtype=torch.float32):
    """One fused stencil+reduce sweep over a 2-D array: frames the input
    (⊥ ring + block round-up), runs :func:`stencil2d_fused_framed` once,
    and slices the domain back.  Returns ``(new_array, reduced)``.
    Iterative callers hold the frame across sweeps instead
    (:class:`repro_torch.core.executor.StencilEngine`)."""
    m, n = a.shape
    spec = frame_spec(m, n, k=k, block=block)
    frame = make_frame(a, spec, boundary)
    env_framed = tuple(frame_env(e, spec, boundary) for e in env)
    out, red = stencil2d_fused_framed(
        frame, f, spec, env_framed=env_framed, combine=combine,
        identity=identity, measure=measure, acc_dtype=acc_dtype)
    return unframe(out, spec).clone(), red
