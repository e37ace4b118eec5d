"""Plain PyTorch oracles and the application elemental functions.

PyTorch twin of :mod:`repro.kernels.ref`.  Every factory returns an
:class:`Elemental`: callable as ``f(get, *env)`` with a torch body (so the
plain paths use it exactly as the reference uses its taps functions), and
carrying the descriptor of its CUDA functor in ``csrc/elementals.cuh``
(functor name, float params, radius k, env count).  The kernel backend
accepts only elemental functions that carry a descriptor; a user lambda
runs on the ``"torch"`` backend.

Bodies keep the reference's operation order (e.g. ``(dx²·f + s) / denom``)
so that the CUDA functors, which repeat it, agree bit for bit with the
plain version on the card.  Divisions by a constant divide by a 0-d tensor
on the operand's device: PyTorch's CUDA ``x / python_float`` multiplies by
a rounded reciprocal instead, which is one ulp away from the IEEE division
the reference and the kernel perform.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Optional

import torch

from ..core.reduce import resolve_monoid, tree_reduce
from ..core.stencil import stencil_taps

# functor names → ids of the ``FunctorId`` enum in csrc/elementals.cuh
FUNCTOR_IDS = {
    "jacobi": 0,
    "helmholtz_jacobi": 1,
    "heat": 2,
    "sobel": 3,
    "gol": 4,
    "median3": 5,
    "amf_mask": 6,
    "amf_repl": 7,
    "restore": 8,
    "conv": 9,
}
# measure names → ids of the ``MeasureId`` enum in csrc/fold.cuh
MEASURE_IDS = {"none": 0, "abs_delta": 1}
MAX_PARAMS = 49          # 7×7 conv weights — ``Params`` in elementals.cuh
MAX_ENV = 2


@dataclasses.dataclass(frozen=True, eq=False)
class Elemental:
    """A taps-style elemental function with its CUDA functor descriptor."""

    functor: str                  # key of FUNCTOR_IDS
    body: Callable                # torch body f(get, *env)
    k: int = 1                    # stencil radius the functor reads
    n_env: int = 0                # env fields the functor reads
    params: tuple = ()            # float params, in the functor's order

    def __post_init__(self):
        if self.functor not in FUNCTOR_IDS:
            raise ValueError(f"unknown functor {self.functor!r}")
        if len(self.params) > MAX_PARAMS or self.n_env > MAX_ENV:
            raise ValueError("descriptor exceeds the kernel's limits")

    def __call__(self, get, *env):
        return self.body(get, *env)

    @property
    def functor_id(self) -> int:
        return FUNCTOR_IDS[self.functor]


@dataclasses.dataclass(frozen=True, eq=False)
class Measure:
    """A two-argument ``measure(new, old_center)`` with its kernel id."""

    name: str                     # key of MEASURE_IDS
    body: Callable

    def __call__(self, new, old):
        return self.body(new, old)

    @property
    def measure_id(self) -> int:
        return MEASURE_IDS[self.name]


def _f32(x: float) -> float:
    """``x`` rounded to float32, as the reference's weak-typed scalars are."""
    return float(torch.tensor(x, dtype=torch.float32))


def _div(x: torch.Tensor, v: float) -> torch.Tensor:
    """IEEE ``x / v`` on every device (see module docstring)."""
    return x / torch.full((), v, dtype=x.dtype, device=x.device)


def stencil2d_fused_ref(a, f, *, env=(), k=1, combine="sum", identity=None,
                        measure: Optional[Callable] = None,
                        boundary="zero", acc_dtype=torch.float32):
    """Oracle for :func:`repro_torch.kernels.stencil2d.stencil2d_fused`."""
    op, ident = resolve_monoid(combine, identity)
    new = stencil_taps(lambda get: f(get, *env), a, k, boundary)
    meas = measure(new, a) if measure is not None else new
    red = tree_reduce(op, meas.to(acc_dtype), ident)
    return new, red


# ---------------------------------------------------------------------------
# Application elemental functions (taps-style, with CUDA descriptors).
# ---------------------------------------------------------------------------

def jacobi_taps(rhs_scale: float = 0.25) -> Elemental:
    """Jacobi sweep for the Laplace problem: 4-point average."""
    def f(get, *_):
        return rhs_scale * (get(-1, 0) + get(1, 0) + get(0, -1) + get(0, 1))
    return Elemental("jacobi", f, params=(_f32(rhs_scale),))


def helmholtz_jacobi_taps(alpha: float, dx: float) -> Elemental:
    """Jacobi iteration for (∇² - α)u = -f:
    u' = (dx²·f + Σ_4-neighbours u) / (4 + α·dx²); f enters through env."""
    denom = 4.0 + alpha * dx * dx

    def f(get, fxy):
        s = get(-1, 0) + get(1, 0) + get(0, -1) + get(0, 1)
        return _div(dx * dx * fxy + s, denom)
    return Elemental("helmholtz_jacobi", f, n_env=1,
                     params=(_f32(dx * dx), _f32(denom)))


def sobel_taps() -> Elemental:
    """Sobel edge detector: gradient magnitude of the 3×3 neighbourhood."""
    def f(get, *_):
        gx = (get(-1, 1) + 2 * get(0, 1) + get(1, 1)
              - get(-1, -1) - 2 * get(0, -1) - get(1, -1))
        gy = (get(1, -1) + 2 * get(1, 0) + get(1, 1)
              - get(-1, -1) - 2 * get(-1, 0) - get(-1, 1))
        return torch.sqrt(gx * gx + gy * gy)
    return Elemental("sobel", f)


def gol_taps() -> Elemental:
    """Conway's Game of Life (the paper's running example, Fig. 1)."""
    def f(get, *_):
        n = sum(get(di, dj) for di in (-1, 0, 1) for dj in (-1, 0, 1)
                if (di, dj) != (0, 0))
        c = get(0, 0)
        return ((n == 3) | ((c > 0) & (n == 2))).to(c.dtype)
    return Elemental("gol", f)


def median3_taps() -> Elemental:
    """3×3 median (NaN sorts last, as in ``jnp.sort``)."""
    def f(get, *_):
        w = torch.stack([get(di, dj) for di in (-1, 0, 1)
                         for dj in (-1, 0, 1)])
        return torch.sort(w, dim=0).values[4]
    return Elemental("median3", f)


def amf_detect_taps(kmax: int = 3):
    """Adaptive median filter detection (§4.3 phase 1): windows escalate
    3×3 → … → (2·kmax+1)²; at each level, if the window median lies
    strictly between the window min and max the decision is made there
    (noise iff the pixel is not strictly between them); pixels undecided
    at kmax are flagged and take the last level's median.  NaN sorts last,
    so a NaN in the window is its max.

    Returns ``(f_mask, f_repl)``: 1.0 where noise, and the median
    replacement (two planes, two sweeps)."""
    def core(get):
        x = get(0, 0)
        decided = torch.zeros_like(x, dtype=torch.bool)
        noise = torch.zeros_like(x, dtype=torch.bool)
        repl = x
        for k in range(1, kmax + 1):
            w = torch.stack([get(di, dj)
                             for di in range(-k, k + 1)
                             for dj in range(-k, k + 1)])
            srt = torch.sort(w, dim=0).values
            mn, med, mx = srt[0], srt[w.shape[0] // 2], srt[-1]
            level_a = (med > mn) & (med < mx)
            is_noise_here = ~((x > mn) & (x < mx))
            newly = level_a & ~decided
            noise = torch.where(newly, is_noise_here, noise)
            repl = torch.where(newly & is_noise_here, med, repl)
            decided = decided | level_a
        noise = noise | ~decided
        repl = torch.where(~decided, med, repl)
        return noise.to(x.dtype), repl

    def f_mask(get, *_):
        return core(get)[0]

    def f_repl(get, *_):
        return core(get)[1]
    return (Elemental("amf_mask", f_mask, k=kmax, params=()),
            Elemental("amf_repl", f_repl, k=kmax, params=()))


def restore_taps(beta: float = 2.0) -> Elemental:
    """Regularisation sweep of the two-phase restoration (§4.3): pixels
    flagged noisy move toward a weighted combination of the
    4-neighbourhood median and mean; clean pixels are pinned to the
    observation.  ``env = (noisy_observation, noise_mask)``."""
    def f(get, noisy, mask):
        a, b, c, d = get(-1, 0), get(1, 0), get(0, -1), get(0, 1)
        srt = torch.sort(torch.stack([a, b, c, d]), dim=0).values
        med4 = 0.5 * (srt[1] + srt[2])
        mean4 = (a + b + c + d) / 4.0          # exact: a power of two
        prop = _div(beta * med4 + mean4, beta + 1.0)
        return torch.where(mask > 0, prop, noisy)
    return Elemental("restore", f, n_env=2,
                     params=(_f32(beta), _f32(beta + 1.0)))


def heat_taps(nu: float = 0.1) -> Elemental:
    """Explicit heat equation step (generic iterative stencil)."""
    def f(get, *_):
        lap = (get(-1, 0) + get(1, 0) + get(0, -1) + get(0, 1)
               - 4.0 * get(0, 0))
        return get(0, 0) + nu * lap
    return Elemental("heat", f, params=(_f32(nu),))


def conv_taps(weights) -> Elemental:
    """Linear 2-D stencil from a (2k+1, 2k+1) weight window, k ≤ 3 (the
    convolution special case of :func:`repro_torch.core.stencil.
    conv_taps`, with a kernel descriptor)."""
    w = torch.as_tensor(weights, dtype=torch.float32).cpu()
    win = w.shape[0]
    if w.ndim != 2 or w.shape != (win, win) or win % 2 == 0 or win > 7:
        raise ValueError(
            f"conv weights must be a square odd window of side <= 7; got "
            f"shape {tuple(w.shape)}")
    k = (win - 1) // 2
    vals = tuple(float(v) for v in w.reshape(-1))

    def f(get, *_):
        acc = None
        for (oi, oj), wv in zip(itertools.product(range(win), repeat=2),
                                vals):
            term = get(oi - k, oj - k) * wv
            acc = term if acc is None else acc + term
        return acc
    return Elemental("conv", f, k=k, params=vals)


# the -d variant's δ for convergence-on-change monitoring
abs_delta = Measure("abs_delta", lambda new, old: torch.abs(new - old))
