"""Production stencil application: the α(f)∘σ_k of the paper, as shifts.

PyTorch twin of :mod:`repro.core.stencil`.  Two strategies, both equal
to :func:`repro_torch.core.semantics.stencil`:

* :func:`stencil_windows` — materialise the window tensor (general; memory
  ×(2k+1)^n), for elemental functions that need the whole window;
* :func:`stencil_taps` — ``f`` receives a tap accessor ``get(*offsets)``
  returning the array shifted by the offsets.  This is the protocol the
  hand-written CUDA kernel implements (one tap = one offset load).
"""
from __future__ import annotations

import itertools
from typing import Callable, Sequence

import torch

from .semantics import Boundary, indexed_neighborhoods, neighborhoods


class TapAccessor:
    """Shifted-array accessor handed to tap-style elemental functions.

    ``get(d1, ..., dn)`` returns the array whose item at position i is
    ``a'[i + d]`` — the neighbour at relative offset d, ⊥ filled by the
    boundary model.  Offsets must lie in [-k, k].
    """

    def __init__(self, a: torch.Tensor, k: int, boundary: Boundary,
                 axes: Sequence[int] | None = None):
        self._k = k
        self._axes = tuple(axes) if axes is not None else tuple(range(a.ndim))
        self._p = Boundary(boundary).pad(a, k, axes=self._axes)
        self._shape = a.shape

    def __call__(self, *offsets: int) -> torch.Tensor:
        if len(offsets) != len(self._axes):
            raise ValueError(
                f"expected {len(self._axes)} offsets, got {len(offsets)}")
        if any(abs(o) > self._k for o in offsets):
            raise ValueError(f"offset out of stencil radius k={self._k}")
        idx = [slice(None)] * self._p.ndim
        for ax, off in zip(self._axes, offsets):
            start = self._k + off
            idx[ax] = slice(start, start + self._shape[ax])
        return self._p[tuple(idx)]

    @property
    def center(self) -> torch.Tensor:
        return self(*([0] * len(self._axes)))


def stencil_taps(f: Callable[[TapAccessor], torch.Tensor], a: torch.Tensor,
                 k: int, boundary: Boundary | str = Boundary.ZERO,
                 axes: Sequence[int] | None = None) -> torch.Tensor:
    """Apply a tap-style elemental function.  ``f(get) -> new array``."""
    return f(TapAccessor(a, k, Boundary(boundary), axes))


def stencil_windows(f: Callable[[torch.Tensor], torch.Tensor],
                    a: torch.Tensor, k: int,
                    boundary: Boundary | str = Boundary.ZERO
                    ) -> torch.Tensor:
    """Apply a window-style elemental function (materialised σ_k)."""
    return f(neighborhoods(a, k, Boundary(boundary)))


def stencil_indexed(f: Callable, a: torch.Tensor, k: int,
                    boundary: Boundary | str = Boundary.ZERO
                    ) -> torch.Tensor:
    """-i variant: f receives (windows, absolute-index tensor) — σ̄_k."""
    w, idx = indexed_neighborhoods(a, k, Boundary(boundary))
    return f(w, idx)


def conv_taps(weights, boundary: Boundary | str = Boundary.ZERO) -> Callable:
    """Tap-style linear-stencil elemental function from a weight window of
    shape (2k+1,)*n — the convolution special case.  (For the CUDA kernel
    use :func:`repro_torch.kernels.ref.conv_taps`, which carries the
    kernel descriptor.)"""
    weights = torch.as_tensor(weights)
    win = weights.shape[0]
    k = (win - 1) // 2
    n = weights.ndim

    def f(get: TapAccessor):
        acc = None
        for offs in itertools.product(range(win), repeat=n):
            term = get(*[o - k for o in offs]) * weights[offs]
            acc = term if acc is None else acc + term
        return acc

    f.k = k  # type: ignore[attr-defined]
    return f
