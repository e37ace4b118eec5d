"""Carry state across from the JAX package to the port.

This system has no weights: its state is the grid, the env fields and the
loop state.  The helpers here take that state as numpy arrays (what the
reference's arrays convert to) and rebuild it in the port's layout:

* :func:`frame_from_numpy` — a reference halo frame, re-tiled into the
  port's :class:`~repro_torch.core.frames.FrameSpec` (the two packages pick
  different tiles, so the domain is copied and the ghost ring re-asserted);
* :func:`lane_frames_from_numpy` — the same for a reference lane stack
  (``farm_run``'s carry), into the port's lane layout;
* :func:`loop_result_from_numpy` — a reference ``LoopResult``;
* :func:`elemental_from_reference` — a reference elemental-function factory
  name and its parameters → the port's :class:`~repro_torch.kernels.ref.
  Elemental` (or :class:`~repro_torch.kernels.ref.Measure`).

Nothing here imports the JAX package: names and arrays are the interface.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.frames import FrameSpec, make_frame, make_lane_frames
from .core.pattern import LoopResult
from .device import resolve_device
from .kernels import ref as R

_FACTORIES = {
    "jacobi_taps": R.jacobi_taps,
    "helmholtz_jacobi_taps": R.helmholtz_jacobi_taps,
    "sobel_taps": R.sobel_taps,
    "gol_taps": R.gol_taps,
    "median3_taps": R.median3_taps,
    "amf_detect_taps": R.amf_detect_taps,
    "restore_taps": R.restore_taps,
    "heat_taps": R.heat_taps,
    "conv_taps": R.conv_taps,
}


def frame_from_numpy(frame_np, *, m: int, n: int, pad: int, boundary,
                     spec: FrameSpec, device=None) -> torch.Tensor:
    """Re-tile a reference frame (domain at ``[pad:pad+m, pad:pad+n]``)
    into a frame of the port's ``spec`` on ``device``."""
    if (spec.m, spec.n) != (m, n):
        raise ValueError(
            f"spec domain {(spec.m, spec.n)} != frame domain {(m, n)}")
    frame_np = np.asarray(frame_np)
    dom = frame_np[pad:pad + m, pad:pad + n]
    if dom.shape != (m, n):
        raise ValueError(
            f"frame of shape {frame_np.shape} holds no {m}x{n} domain at "
            f"pad {pad}")
    a = torch.tensor(dom, device=resolve_device(device))
    return make_frame(a, spec, boundary)


def loop_result_from_numpy(a, reduced, iters, health=None, state=None, *,
                           device=None) -> LoopResult:
    """A reference ``LoopResult``'s arrays as the port's ``LoopResult``."""
    dev = resolve_device(device)
    return LoopResult(
        a=torch.tensor(np.asarray(a), device=dev),
        reduced=torch.tensor(np.asarray(reduced), device=dev),
        iters=torch.tensor(np.asarray(iters), dtype=torch.int32,
                           device=dev),
        state=state,
        health=None if health is None else torch.tensor(
            np.asarray(health), dtype=torch.int32, device=dev))


def elemental_from_reference(name: str, **params):
    """The port's elemental function for the reference factory ``name``
    (e.g. ``"helmholtz_jacobi_taps"``, ``alpha=.., dx=..``);
    ``"abs_delta"`` gives the measure.  ``amf_detect_taps`` returns the
    ``(mask, repl)`` pair, as the reference does."""
    if name == "abs_delta":
        if params:
            raise TypeError("abs_delta takes no parameters")
        return R.abs_delta
    if name not in _FACTORIES:
        raise ValueError(
            f"no port counterpart for {name!r}; known: "
            f"{sorted(_FACTORIES) + ['abs_delta']}")
    return _FACTORIES[name](**params)


def lane_frames_from_numpy(frames_np, *, m: int, n: int, pad: int, boundary,
                           spec: FrameSpec, device=None) -> torch.Tensor:
    """Re-tile a reference lane stack of frames ((lanes, H, W), each domain
    at ``[pad:pad+m, pad:pad+n]``) into the port's lane layout
    (:class:`~repro_torch.core.frames.LaneFrameSpec` of ``spec``) on
    ``device``."""
    if (spec.m, spec.n) != (m, n):
        raise ValueError(
            f"spec domain {(spec.m, spec.n)} != frame domain {(m, n)}")
    frames_np = np.asarray(frames_np)
    dom = frames_np[:, pad:pad + m, pad:pad + n]
    if frames_np.ndim != 3 or dom.shape[1:] != (m, n):
        raise ValueError(
            f"lane stack of shape {frames_np.shape} holds no {m}x{n} "
            f"domains at pad {pad}")
    a = torch.tensor(dom, device=resolve_device(device))
    return make_lane_frames(a, spec, boundary)
