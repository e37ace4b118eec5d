"""Fused stencil + reduce sweep on a persistent halo frame (paper §3.3 core).

PyTorch/CUDA twin of :mod:`repro.kernels.stencil2d`.  The TPU kernel
``_stencil_kernel`` becomes the hand-written CUDA kernel of
``csrc/window.cuh`` at T = 1 (entry point ``csrc/stencil2d.cu``, built at
first use by :mod:`._build`): one sweep of an elemental functor over the
frame's block-rounded interior, written into the same layout of a second
frame (ghost ring untouched), with the measure folded over the in-domain
cells to one ⊕ scalar by per-CTA partials and a last-CTA combine in the
same launch (deterministic, no float atomics).  Persistent CTAs walk
tiles of the kernel's own size (:func:`cta_tile`, not the frame's block),
staging each window in shared memory while the previous one sweeps.

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
import functools
from typing import Callable, Optional

import torch

from ..core.frames import (DEFAULT_BLOCK, FrameSpec, frame_env, frame_spec,
                           make_frame, unframe)
from ..core.reduce import monoid_name, resolve_monoid, tree_reduce
from .ref import FUNCTOR_IDS, MEASURE_IDS, Elemental, Measure

# monoid names → ids of the ``MonoidId`` enum in csrc/fold.cuh
MONOID_IDS = {"sum": 0, "prod": 1, "max": 2, "min": 3, "any": 4, "all": 5}

# storage dtypes of the kernels → the ``dtype`` argument of the C entries
DTYPE_IDS = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches, counted by each wrapper where it launches (and nowhere
# else), for this kernel and for ``multistep.stencil2d_multistep_framed``;
# chip_smoke.py zeroes them before the main path and reads them after
launch_counts = {"stencil_sweep": 0, "multistep_sweep": 0}

# The kernel's CTA tiles and their shared memory (csrc/window.cuh).  A
# block may use 232,448 bytes of an H100 SM's 233,472 (the fold's static
# words come off them), and each CTA costs the system 1 KB more.
SMEM_BYTES = 232448 - 1024
SM_SMEM = 233472
CTA_SMEM = 1024 + 64     # reserved + the fold's static words, a CTA
N_SM = 132               # H100 SXM; tile choice only, the launch asks
MAX_GRID = 4096          # kMaxGrid: the persistent grid's cap
TILE_ROWS = (8, 16, 32, 64)
TILE_COLS = (32, 64, 128)
# measured on an H100 (chip_smoke.py phase 7): one CTA an SM, or two,
# leave latency that three hide
CTA_PENALTY = {1: 1.3, 2: 1.1, 3: 1.0}
# functors bound by operations (they sort up to 49 values a cell): their
# tiles are many and small, so the persistent CTAs share the work evenly
OPERATION_BOUND = frozenset({"amf_mask", "amf_repl"})


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
    """(partials, slots a lane, ticket, result) of one launch: the reduce
    scratch (allocated when not given) and a fresh result of one float per
    lane."""
    partials, ticket = (scratch if scratch is not None
                        else alloc_scratch(spec, device, lanes or 1))
    slots = partials.numel() // (lanes or 1)
    if slots < partial_slots(spec) or ticket.numel() < (lanes or 1):
        raise ValueError("scratch too small for this frame geometry")
    result = torch.empty((lanes,) if lanes else (), dtype=torch.float32,
                         device=device)
    return result, (partials.data_ptr(), slots, ticket.data_ptr(),
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


def check_pair_layout(spec: FrameSpec, *tensors) -> None:
    """The kernel stages element pairs, so every row of a frame or env
    field must start on an even element: the interior's width (gn·bn) must
    be even, as it is for every block of a whole number of 32 columns, and
    each tensor must start on a pair boundary."""
    if spec.interior[1] % 2:
        raise ValueError(
            f"the CUDA sweep needs an even interior width; got "
            f"{spec.interior[1]} (block {spec.bm}x{spec.bn})")
    for t in tensors:
        if t.data_ptr() % (2 * t.element_size()):
            raise ValueError("frames and env fields must start on an even "
                             "element (a view at an odd offset)")


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


def window_bytes(tile, pad: int, n_env: int, itemsize: int = 4, *,
                 env_halo: bool = False, work: bool = False,
                 ring: int = 2) -> int:
    """Dynamic shared memory of one CTA of the stencil kernel (``Layout``
    in csrc/window.cuh): ``ring`` slots, each the (tm+2·pad, tn+2·pad)
    window of the frame and one window per env field (the same, for full
    halo env frames, or the tile, for interior ones), and with ``work``
    one more frame window for the sweeps to ping-pong through; each buffer
    rounded up to 16 bytes."""
    tm, tn = tile
    wm, wn = tm + 2 * pad, tn + 2 * pad
    e = 0 if env_halo else pad

    def r16(b):
        return -(-b // 16) * 16

    win = r16(wm * wn * itemsize)
    env = r16((wm - 2 * e) * (wn - 2 * e) * itemsize)
    return ring * (win + n_env * env) + (win if work else 0)


def sweep_cells(tile, pad: int, T: int) -> float:
    """Lane-cells a CTA evaluates per useful cell and sweep: sweep s covers
    (tm + 2k(T-1-s)) rows of columns rounded up to warps of 32, k = pad/T
    (the recomputed halo and the idle lanes of a ragged chunk)."""
    tm, tn = tile
    k = pad // T
    lanes = 0
    for s in range(T):
        halo = 2 * k * (T - 1 - s)
        lanes += (tm + halo) * -(-(tn + halo) // 32) * 32
    return lanes / (T * tm * tn)


@functools.lru_cache(maxsize=256)
def cta_tile(mi: int, ni: int, *, lanes: int = 1, pad: int = 1, T: int = 1,
             n_env: int = 0, itemsize: int = 4, env_halo: bool = False,
             work: bool = False, heavy: bool = False) -> tuple:
    """The kernel's CTA tile for a (lanes, mi, ni) interior swept T times
    a launch: ``(tm, tn, ring)``, tm a multiple of 8 and tn of 32 (at most
    the interior rounded up to those), ``ring`` the window slots (2: the
    next window loads while this one sweeps).

    Among the tiles whose shared memory fits a CTA it keeps those that
    leave room for two CTAs an SM (if any do), and orders them by the
    lane-cells a useful cell costs (:func:`sweep_cells`, weighed by
    ``CTA_PENALTY`` for the CTAs an SM the shared memory allows), then two
    slots before one, then width (wider rows coalesce better), then the
    window's bytes a tile cell; it takes the first with enough tiles for the
    persistent CTAs to share them evenly (4 an SM, 32 for an
    operation-bound functor, ``heavy``, whose tiles are ordered smallest
    first), or, on a frame too small for that, the one with the most
    tiles.  Raises only when no tile fits (then no 8x32 tile does)."""
    rows = sorted({min(t, -(-mi // 8) * 8) for t in TILE_ROWS})
    cols = sorted({min(t, -(-ni // 32) * 32) for t in TILE_COLS})
    kw = dict(env_halo=env_halo, work=work)

    def nbytes(o):
        return window_bytes(o[:2], pad, n_env, itemsize, ring=o[2], **kw)

    fits = [(tm, tn, ring) for ring in (2, 1) for tm in rows for tn in cols
            if nbytes((tm, tn, ring)) <= SMEM_BYTES]
    if not fits:
        raise ValueError(
            f"no CTA tile's window fits {SMEM_BYTES} bytes of shared "
            f"memory at pad {pad} with {n_env} env fields; lower unroll")
    pool = [o for o in fits if 2 * (nbytes(o) + CTA_SMEM) <= SM_SMEM] or fits

    def tiles(o):
        return lanes * -(-mi // o[0]) * -(-ni // o[1])

    def cost(o):
        # lane-cells a useful cell, dearer with fewer CTAs an SM to hide
        # latency (shared memory's count, at most the 3 that the
        # registers allow)
        ctas = min(3, SM_SMEM // (nbytes(o) + CTA_SMEM))
        return round(sweep_cells(o[:2], pad, T) * CTA_PENALTY[ctas], 2)

    if heavy:
        pool.sort(key=lambda o: (o[0] * o[1], -o[2], -o[1]))
    else:
        pool.sort(key=lambda o: (cost(o), -o[2], -o[1],
                                 (o[0] + 2 * pad) * (o[1] + 2 * pad)
                                 / (o[0] * o[1])))
    want = N_SM * (32 if heavy else 4)
    for o in pool:
        if tiles(o) >= want:
            return o
    return max(pool, key=lambda o: (tiles(o), o[1]))


def partial_slots(spec: FrameSpec) -> int:
    """Reduce partials one lane may need: one per CTA that visits it, at
    most one per 8x32 piece of the interior or the grid's cap."""
    mi, ni = spec.interior
    return min(-(-mi // 8) * -(-ni // 32), MAX_GRID)


def alloc_scratch(spec: FrameSpec, device, lanes: int = 1) -> tuple:
    """Reduce scratch of one frame geometry: per-CTA partials and the
    last-CTA ticket of each lane (zeroed; the kernel leaves them zeroed)."""
    return (torch.empty(lanes * partial_slots(spec), dtype=torch.float32,
                        device=device),
            torch.zeros(lanes, dtype=torch.int32, device=device))


def resolve_tile(tile, spec: FrameSpec, lanes, el, frame, *, env_halo,
                 work, T=1) -> tuple:
    """``(tm, tn, ring)`` of a launch: ``tile`` as given ((tm, tn) takes
    two slots), or :func:`cta_tile`'s choice for this frame, functor and
    T."""
    if tile is None:
        mi, ni = spec.interior
        return cta_tile(mi, ni, lanes=lanes or 1, pad=spec.pad, T=T,
                        n_env=el.n_env, itemsize=frame.element_size(),
                        env_halo=env_halo, work=work,
                        heavy=el.functor in OPERATION_BOUND)
    tm, tn, ring = (tuple(tile) + (2,))[:3]
    if tm <= 0 or tn <= 0 or tm % 8 or tn % 32 or ring not in (1, 2):
        raise ValueError(f"a CTA tile is (tm, tn[, ring]) with tm a "
                         f"multiple of 8, tn of 32, ring 1 or 2; got {tile}")
    return tm, tn, ring


def last_launch() -> dict:
    """What the last stencil kernel launch chose (csrc/multistep.cu
    ``stencil_launch_info``): grid, CTAs an SM, shared memory a CTA,
    registers a thread, the tile and its window slots, (tile, lane)
    pairs."""
    from . import _build
    out = (ctypes.c_int * 8)()
    _build.library().stencil_launch_info(out)
    keys = ("grid", "ctas_per_sm", "smem_bytes", "registers", "tm", "tn",
            "ring", "tiles")
    return dict(zip(keys, out))


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
                           live: Optional[torch.Tensor] = None,
                           tile: Optional[tuple] = None):
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
    buffers.  ``tile`` forces the kernel's CTA tile ((tm, tn) or (tm, tn,
    ring), see :func:`cta_tile`, which chooses it otherwise).

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
    check_pair_layout(spec, frame, *env_framed)
    tm, tn, ring = resolve_tile(tile, spec, lanes, el, frame,
                                env_halo=False, work=False)
    need = window_bytes((tm, tn), spec.pad, el.n_env, frame.element_size(),
                        ring=ring)
    if need > SMEM_BYTES:
        raise ValueError(
            f"the window of a {tm}x{tn} tile at pad {spec.pad} with "
            f"{el.n_env} env fields and {ring} slots needs {need} bytes of "
            f"shared memory; a block has {SMEM_BYTES}")
    if out is None:
        out = torch.empty_like(frame)
    live, live_ptr = live_pointer(live, lanes, frame.device)
    _, ident = resolve_monoid(combine, identity)
    if do_reduce:
        result, ptrs = reduce_operands(spec, lanes, frame.device, scratch)
    else:
        ptrs = (None, 0, None, None)
    envs = [e.data_ptr() for e in env_framed] + [None] * (2 - el.n_env)
    params = (ctypes.c_float * max(len(el.params), 1))(*el.params)
    mi, ni = spec.interior

    from . import _build
    lib = _build.library()
    rc = lib.stencil_sweep(
        el.functor_id, el.k, DTYPE_IDS[frame.dtype], params,
        len(el.params), frame.data_ptr(), out.data_ptr(), envs[0], envs[1],
        spec.shape[1], lanes or 1, spec.pad, mi, ni, spec.m, spec.n, tm, tn,
        ring, MONOID_IDS[mname], mid, int(do_reduce), live_ptr, *ptrs,
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
