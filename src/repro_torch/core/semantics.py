"""Executable formal semantics of the Loop-of-stencil-reduce pattern (paper §3.1).

PyTorch twin of :mod:`repro.core.semantics`: a direct transcription of
the paper's definitions, the oracle the production paths are held
against.  Clarity over speed.

    α(f) : a   apply-to-all       -> :func:`apply_to_all`
    /(⊕) : a   reduce             -> :func:`reduce_all`
    σ_k^n : a  stencil operator   -> :func:`neighborhoods`
    σ̄_k^n : a  indexed stencil    -> :func:`indexed_neighborhoods`
    stencil(σ_k, f) = α(f) ∘ σ_k  -> :func:`stencil`

The paper's ⊥ (out-of-range access) is realised as a boundary model
(:class:`Boundary`): the fill the padded array carries outside the domain.
"""
from __future__ import annotations

import enum
import itertools
from typing import Callable

import torch


def _pad_axis(a: torch.Tensor, ax: int, k: int, mode: str) -> torch.Tensor:
    """Extend ``a`` by ``k`` cells per side along ``ax`` (numpy pad modes
    'reflect' — no edge repeat — and 'wrap')."""
    size = a.shape[ax]
    if mode == "reflect":
        if k > size - 1:
            raise ValueError(
                f"reflect padding of width {k} needs an axis longer than "
                f"{k}; axis {ax} has {size}")
        lo = a.narrow(ax, 1, k).flip(ax)
        hi = a.narrow(ax, size - 1 - k, k).flip(ax)
    else:
        if k > size:
            raise ValueError(
                f"wrap padding of width {k} exceeds axis {ax} of size "
                f"{size}")
        lo = a.narrow(ax, size - k, k)
        hi = a.narrow(ax, 0, k)
    return torch.cat([lo, a, hi], dim=ax)


class Boundary(str, enum.Enum):
    """How σ_k realises the paper's ⊥ outside the array domain."""

    ZERO = "zero"        # ⊥ := 0
    NAN = "nan"          # ⊥ := NaN  (caller's f/⊕ must absorb it)
    REFLECT = "reflect"  # ⊥ := mirrored value (jnp.pad 'reflect')
    WRAP = "wrap"        # ⊥ := periodic value

    def pad(self, a: torch.Tensor, k: int, axes=None) -> torch.Tensor:
        """Extend ``a`` by ``k`` ⊥-cells per side along ``axes`` (default:
        every axis).  Axes are padded one after the other, so corners
        compose axis by axis exactly like ``jnp.pad``."""
        axes = range(a.ndim) if axes is None else sorted(set(axes))
        if k == 0:
            return a
        for ax in axes:
            if self in (Boundary.ZERO, Boundary.NAN):
                shape = list(a.shape)
                shape[ax] = k
                fill = torch.full(shape, 0.0 if self is Boundary.ZERO
                                  else float("nan"),
                                  dtype=a.dtype, device=a.device)
                a = torch.cat([fill, a, fill], dim=ax)
            elif self is Boundary.REFLECT:
                a = _pad_axis(a, ax, k, "reflect")
            else:
                a = _pad_axis(a, ax, k, "wrap")
        return a


def apply_to_all(f: Callable, a: torch.Tensor) -> torch.Tensor:
    """α(f) : a — ``f`` is elementwise and applied to the whole array."""
    return f(a)


def reduce_all(op: Callable, a: torch.Tensor, identity) -> torch.Tensor:
    """/(⊕) : a — a balanced reduction tree over all items, padded to a
    power of two with the identity."""
    flat = a.reshape(-1)
    n = flat.shape[0]
    size = 1 if n == 0 else 1 << (n - 1).bit_length()
    flat = torch.cat([flat, torch.full((size - n,), identity,
                                       dtype=flat.dtype, device=flat.device)])
    while flat.shape[0] > 1:
        flat = op(flat[0::2], flat[1::2])
    return flat[0]


def neighborhoods(a: torch.Tensor, k: int,
                  boundary: Boundary | str = Boundary.ZERO) -> torch.Tensor:
    """σ_k^n : a — ``w`` of shape ``a.shape + (2k+1,)*n`` with
    ``w[i, j] = a'[i - k + j]`` and ``a'`` the ⊥-extended array."""
    boundary = Boundary(boundary)
    n = a.ndim
    padded = boundary.pad(a, k)
    win = 2 * k + 1
    tiles = []
    for offsets in itertools.product(range(win), repeat=n):
        sl = tuple(slice(o, o + d) for o, d in zip(offsets, a.shape))
        tiles.append(padded[sl])
    w = torch.stack(tiles, dim=-1)
    return w.reshape(a.shape + (win,) * n)


def indexed_neighborhoods(a: torch.Tensor, k: int,
                          boundary: Boundary | str = Boundary.ZERO):
    """σ̄_k^n : a — ``(w, idx)`` where ``idx`` (``a.shape + (2k+1,)*n +
    (n,)``) holds the absolute coordinates of every window element
    (out-of-range indexes delivered as-is)."""
    n = a.ndim
    w = neighborhoods(a, k, boundary)
    win = 2 * k + 1
    dev = a.device
    centres = torch.stack(torch.meshgrid(
        *[torch.arange(d, device=dev) for d in a.shape], indexing="ij"),
        dim=-1)
    offs = torch.stack(torch.meshgrid(
        *[torch.arange(-k, k + 1, device=dev)] * n, indexing="ij"), dim=-1)
    idx = (centres.reshape(a.shape + (1,) * n + (n,))
           + offs.reshape((1,) * n + (win,) * n + (n,)))
    return w, idx


def stencil(f: Callable, a: torch.Tensor, k: int,
            boundary: Boundary | str = Boundary.ZERO) -> torch.Tensor:
    """stencil(σ_k, f) : a = α(f) ∘ σ_k : a (``f`` reduces the trailing
    window axes)."""
    return apply_to_all(f, neighborhoods(a, k, boundary))


# ---------------------------------------------------------------------------
# Reference (python-loop) pattern interpreters — the paper's pseudocode.
# ---------------------------------------------------------------------------

def loop_of_stencil_reduce_ref(k, f, op, c, a, *, identity,
                               boundary=Boundary.ZERO, max_iters=1000):
    """repeat a = stencil(σ_k, f): a  until c(/⊕ : a)  (do-while)."""
    for it in range(1, max_iters + 1):
        a = stencil(f, a, k, boundary)
        r = reduce_all(op, a, identity)
        if bool(c(r)):
            break
    return a, r, it


def loop_of_stencil_reduce_d_ref(k, f, delta, op, c, a, *, identity,
                                 boundary=Boundary.ZERO, max_iters=1000):
    """-D variant: reduce over δ(new, old)."""
    for it in range(1, max_iters + 1):
        b = stencil(f, a, k, boundary)
        d = delta(b, a)
        a = b
        r = reduce_all(op, d, identity)
        if bool(c(r)):
            break
    return a, r, it


def loop_of_stencil_reduce_s_ref(k, f, op, c, a, *, identity, init, update,
                                 boundary=Boundary.ZERO, max_iters=1000):
    """-S variant: a global loop state takes part in the condition."""
    s = init()
    for it in range(1, max_iters + 1):
        a = stencil(f, a, k, boundary)
        s = update(s)
        r = reduce_all(op, a, identity)
        if bool(c(r, s)):
            break
    return a, r, it, s
