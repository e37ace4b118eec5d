"""Public wrappers around the execution engine (paper §4 apps).

PyTorch twin of :mod:`repro.kernels.ops`.  Every app instantiates the
Loop-of-stencil-reduce through the engine's backend axis
(:mod:`repro_torch.device`):

* ``backend="torch"`` — the shift-algebra path;
* ``backend="cuda"``  — the hand-written fused kernel iterated on a
  persistent halo frame;
* ``backend="cuda-multistep"`` — temporal blocking: ``unroll`` sweeps fused
  into one launch of the multistep kernel (``jacobi_solve``, ``restore``
  and ``fused_sweep`` take ``unroll=T``; the loops check their condition
  every T sweeps).

``use_kernel`` is the boolean shorthand (True → "cuda", False → "torch",
None → by device: "cuda" on a CUDA device, "torch" on the CPU); an
explicit ``backend=`` wins.  ``device=None`` means the CUDA card.

``part=`` (a :class:`repro_torch.sharding.GridPartition`) on the iterative
apps selects the sharded 1:n deployment, ``backend="cuda-sharded"``: one
frame per shard of the partition's mesh, the grid scattered once and
gathered onto the mesh's lead device (``device=None`` then means that
device).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.executor import sweep_once
from ..core.frames import DEFAULT_BLOCK
from ..core.pattern import LoopOfStencilReduce
from ..device import resolve_device, to_device
from . import ref as R


def _resolve_backend(use_kernel: Optional[bool],
                     backend: Optional[str]) -> Optional[str]:
    if backend:
        return backend
    if use_kernel is None:
        return None
    return "cuda" if use_kernel else "torch"


def _resolve_sharded_backend(use_kernel: Optional[bool],
                             backend: Optional[str], part) -> Optional[str]:
    """Backend resolution for the iterative apps: a mesh partition means
    the 1:n deployment — refuse a conflicting single-device backend rather
    than silently ignoring ``part``."""
    if part is None:
        return _resolve_backend(use_kernel, backend)
    if backend not in (None, "cuda-sharded"):
        raise ValueError(
            f"part= selects the sharded 1:n deployment; backend="
            f"{backend!r} conflicts (pass backend='cuda-sharded' or drop "
            "it)")
    return "cuda-sharded"


def fused_sweep(a, f, *, env=(), k=1, combine="sum", identity=None,
                measure=None, boundary="zero", block=DEFAULT_BLOCK,
                use_kernel=True, backend=None, unroll=1, device=None):
    """One fused stencil+reduce sweep: returns (new, reduced)."""
    return sweep_once(
        a, f, env=env, k=k, combine=combine, identity=identity,
        measure=measure, boundary=boundary, block=block,
        backend=_resolve_backend(use_kernel, backend), unroll=unroll,
        device=device)


def jacobi_solve(u0, fxy, *, alpha=0.5, dx=1.0 / 512, tol=1e-4,
                 max_iters=1000, use_kernel=None, backend=None, unroll=1,
                 part=None, device=None):
    """Full Helmholtz Jacobi solve as one device-resident loop (fused
    sweep + max|Δu| reduce; the grid is a persistent halo frame on the
    kernel backend, one frame per shard under ``part=``).  Returns ``(u,
    max|Δu|, iters)``."""
    loop = LoopOfStencilReduce(
        f=R.helmholtz_jacobi_taps(alpha, dx), k=1, combine="max",
        cond=lambda r: r < tol, delta=R.abs_delta, boundary="zero",
        max_iters=max_iters, unroll=unroll,
        backend=_resolve_sharded_backend(use_kernel, backend, part),
        partition=part, device=device)
    res = loop.run(u0, env=(fxy,))
    return res.a, res.reduced, res.iters


def sobel(img, *, use_kernel=None, backend=None, device=None):
    """Single-iteration stencil (the paper's worst case for accelerators):
    Sobel magnitude + fused max-response reduce."""
    return sweep_once(img, R.sobel_taps(), k=1, combine="max",
                      identity=float("-inf"), boundary="reflect",
                      backend=_resolve_backend(use_kernel, backend),
                      device=device)


def restore(frame, noisy_mask, *, beta=2.0, tol=1e-3, max_iters=64,
            use_kernel=None, backend=None, unroll=1, part=None,
            device=None):
    """Restoration phase (§4.3): iterate the regularisation sweep until
    the mean absolute update over noisy pixels converges.  Returns
    ``(restored, mean |Δ| over noisy pixels, iters)``.  ``part`` selects
    the sharded 1:n deployment, as in :func:`jacobi_solve`."""
    # under part= the loop runs on the partition's lead device
    dev = part.lead if part is not None and device is None \
        else resolve_device(device)
    frame, noisy_mask = to_device(frame, dev), to_device(noisy_mask, dev)
    npx = torch.clamp(noisy_mask.sum(), min=1.0)
    loop = LoopOfStencilReduce(
        f=R.restore_taps(beta), k=1, combine="sum",
        cond=lambda r: r / npx < tol, delta=R.abs_delta,
        boundary="reflect", max_iters=max_iters, unroll=unroll,
        backend=_resolve_sharded_backend(use_kernel, backend, part),
        partition=part, device=dev)
    res = loop.run(frame, env=(frame, noisy_mask))
    return res.a, res.reduced / npx, res.iters


def adaptive_median_detect(frame, *, kmax=3, use_kernel=None, backend=None,
                           device=None):
    """Detection phase (§4.3): adaptive median filter with window
    escalation 3×3 → … → (2·kmax+1)².  Returns ``(noise_mask,
    repaired_frame)``: flagged pixels replaced by the AMF median, the
    restoration phase's initial guess."""
    be = _resolve_backend(use_kernel, backend)
    dev = resolve_device(device)
    frame = to_device(frame, dev)
    f_mask, f_repl = R.amf_detect_taps(kmax)
    mask, _ = sweep_once(frame, f_mask, k=kmax, combine="sum",
                         identity=0.0, boundary="reflect", backend=be,
                         device=dev)
    repl, _ = sweep_once(frame, f_repl, k=kmax, combine="sum",
                         identity=0.0, boundary="reflect", backend=be,
                         device=dev)
    repaired = torch.where(mask > 0, repl, frame)
    return mask, repaired
