"""The Loop-of-stencil-reduce pattern — production implementation.

PyTorch twin of :mod:`repro.core.pattern` (single-device part).  Pattern
semantics (paper §3.1, all variants, composable):

    repeat
        a = stencil(σ_k, f) : a          # -i: f also sees absolute indexes
        [d = α(δ) : ⟨a_new, a_old⟩]      # -d: measure the change
        [s = update(s, ...)]             # -s: global loop state
    until c(/⊕ : a_or_d [, s])

The reference lowers the loop into one ``lax.while_loop``.  Here it is a
**host loop over device-resident tensors**: the grid, the reduce value,
the condition flag and the health word stay on the device, and the only
host read per check is the done flag.  On ``backend="cuda"`` the loop body
is the hand-written kernel on a persistent halo frame
(:class:`repro_torch.core.executor.StencilEngine`); on ``"torch"`` it is
the shift algebra.

``farm_run``, ``lane_segment`` and ``segmented_while`` (the lane farm) come
with the farm slice of the port (ROADMAP.md queue A6).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from ..device import resolve_backend, resolve_device, to_device
from .executor import check_unroll_feasible
from .frames import DEFAULT_BLOCK
from .reduce import (HEALTH_STALL_MASK, health_update, resolve_monoid,
                     tree_reduce)
from .semantics import Boundary
from .stencil import stencil_indexed, stencil_taps, stencil_windows


@dataclasses.dataclass
class LoopResult:
    """Final state of a Loop-of-stencil-reduce run (tensors on the run's
    device)."""
    a: Any                 # the converged array (or pytree in step mode)
    reduced: torch.Tensor  # last /⊕ value (what the condition saw)
    iters: torch.Tensor    # number of stencil iterations executed (int32)
    state: Any = None      # final loop state (-s variant), None otherwise
    health: Any = None     # packed health word (int32) — decode with
                           # repro_torch.core.reduce.health_status


@dataclasses.dataclass
class LoopOfStencilReduce:
    """Loop-of-stencil-reduce(k, f, ⊕, c, a) with -i / -d / -s variants.

    Parameters as in :class:`repro.core.pattern.LoopOfStencilReduce`:

    f:        elemental function; by ``mode``: taps — f(get, *env);
              windows — f(w); indexed — f(w, idx); step — f(a) -> a.
              On ``backend="cuda"`` an :class:`~repro_torch.kernels.ref.
              Elemental` (the factories of :mod:`repro_torch.kernels.ref`).
    k:        stencil radius (halo depth).  Ignored in step mode.
    combine:  ⊕ — a monoid name ('sum','max','min','any','all','prod') or a
              binary associative callable (then ``identity`` is required;
              ``"torch"`` backend only).
    cond:     c(reduced) or c(reduced, state) when ``state_init`` is given.
              The loop stops when it returns True (repeat/until: the body
              runs at least once).
    delta:    δ(a_new, a_old) — the -d variant.
    measure:  map from the post-step value to what the reduce folds.
    state_init / state_update: the -s variant; ``state_update(s, a, it)``
              runs after the stencil, before the condition.
    boundary: ⊥ model at the domain edge (zero/nan/reflect/wrap).
    max_iters: hard iteration cap.
    unroll:   check the condition every ``unroll`` stencil applications
              (may overshoot convergence by < unroll iterations);
              ``"auto"`` resolves to 1 on the single-step backends.
    backend:  ``None`` (``"cuda"`` on a CUDA device, ``"torch"`` on the
              CPU), ``"torch"`` or ``"cuda"`` (taps mode, 2-D arrays).
    block:    the kernel's CTA tile (rows, cols).
    sentinel: a :class:`~repro_torch.core.reduce.Sentinel` health policy,
              or None (only the CONVERGED bit is tracked).
    device:   ``None`` (the CUDA card) or an explicit device.
    """

    f: Callable
    k: int = 1
    combine: Any = "sum"
    identity: Any = None
    cond: Callable = None
    mode: str = "taps"
    delta: Optional[Callable] = None
    measure: Optional[Callable] = None
    state_init: Optional[Callable] = None
    state_update: Optional[Callable] = None
    boundary: Boundary | str = Boundary.ZERO
    max_iters: int = 10_000
    unroll: Any = 1
    backend: Optional[str] = None
    block: tuple = DEFAULT_BLOCK
    sentinel: Optional[Any] = None
    device: Any = None

    def __post_init__(self):
        self._op, self._id = resolve_monoid(self.combine, self.identity)
        self.boundary = Boundary(self.boundary)
        if self.cond is None:
            raise ValueError("a termination condition c is required")
        if self.mode not in ("taps", "windows", "indexed", "step"):
            raise ValueError(f"unknown mode {self.mode!r}")
        self.device = resolve_device(self.device)
        self.backend = resolve_backend(self.backend, self.device)
        if self.unroll != "auto" and (not isinstance(self.unroll, int)
                                      or self.unroll < 1):
            raise ValueError(
                f"unroll must be a positive int or 'auto'; "
                f"got {self.unroll!r}")
        if self.sentinel is not None and not (
                0 <= self.sentinel.patience <= HEALTH_STALL_MASK):
            raise ValueError(
                f"sentinel patience {self.sentinel.patience} outside "
                f"[0, {HEALTH_STALL_MASK}] (the health word's stall "
                "counter width)")

    # -- single stencil application ------------------------------------
    def _apply(self, a, env=()):
        f = self.f if not env else (lambda *args: self.f(*args, *env))
        if self.mode == "taps":
            return stencil_taps(f, a, self.k, self.boundary)
        if self.mode == "windows":
            return stencil_windows(f, a, self.k, self.boundary)
        if self.mode == "indexed":
            return stencil_indexed(f, a, self.k, self.boundary)
        return f(a)  # step mode

    def _measure(self, a_new, a_old):
        if self.delta is not None:
            m = self.delta(a_new, a_old)
        elif self.measure is not None:
            m = self.measure(a_new)
        else:
            m = a_new
        if not isinstance(m, torch.Tensor):
            raise TypeError(
                "reduce input must be a tensor; supply `measure` for "
                "pytrees")
        return m

    def _reduce(self, m):
        return tree_reduce(self._op, m, self._id)

    def _cond_value(self, r, s) -> torch.Tensor:
        c = self.cond(r, s) if self.state_init is not None else self.cond(r)
        if isinstance(c, torch.Tensor):
            return c.to(device=self.device, dtype=torch.bool).reshape(())
        # a host-side answer becomes a fill on the device, not a copy
        return torch.full((), bool(c), dtype=torch.bool, device=self.device)

    # -- the loop --------------------------------------------------------
    def run(self, a0, state0=None, *, env=()) -> LoopResult:
        """Execute the pattern on ``a0`` (tensors, or numpy arrays, moved
        to the loop's device once); ``env`` holds read-only per-cell
        fields passed to ``f`` after its positional arguments."""
        a0 = to_device(a0, self.device)
        env = tuple(to_device(e, self.device) for e in env)
        if self.state_init is not None and state0 is None:
            state0 = self.state_init()
        resolved = self._resolve_unroll(getattr(a0, "shape", None))
        if resolved is not self:
            return resolved.run(a0, state0, env=env)
        if self.backend == "cuda":
            if self.mode != "taps" or getattr(a0, "ndim", None) != 2:
                raise ValueError(
                    "backend 'cuda' requires mode='taps' and a 2-D array; "
                    f"got mode={self.mode!r}, "
                    f"ndim={getattr(a0, 'ndim', None)}")
            return self._run_persistent(a0, state0, env)

        def one_iter(a):
            """unroll× stencil applications + the measure/reduce of the
            final one (against the second to last iterate)."""
            a_prev = a
            for _ in range(self.unroll):
                a_prev, a = a, self._apply(a, env)
            return a, self._reduce(self._measure(a, a_prev))

        return self._drive(a0, state0, step=one_iter,
                           state_view=lambda a: a, finalize=lambda a: a)

    # -- unroll resolution -----------------------------------------------
    def _resolve_unroll(self, shape) -> "LoopOfStencilReduce":
        """Resolve ``unroll="auto"`` (1 on the single-step backends of this
        slice) and fail loudly on an infeasible halo.  Returns ``self``
        when nothing changes, else a resolved copy."""
        if self.unroll == "auto":
            return dataclasses.replace(self, unroll=1)
        if shape is not None and len(shape) >= 2 and self.backend == "cuda":
            check_unroll_feasible(shape[-2], shape[-1], 1, k=self.k)
        return self

    # -- the persistent-halo loop ("cuda" backend) -----------------------
    def _run_persistent(self, a0, state0, env) -> LoopResult:
        """Zero-copy realisation: the halo frame is the loop carry.
        Framing happens once in ``prepare``; the body is kernel sweeps +
        the O(m+n) ghost refresh; the domain is sliced out once at the
        end.  (The -s variant's ``state_update`` sees a copy of the (m, n)
        domain each check — avoid it on hot paths.)"""
        from .executor import StencilEngine

        eng = StencilEngine(
            f=self.f, k=self.k, boundary=self.boundary,
            combine=self.combine, identity=self.identity, delta=self.delta,
            measure=self.measure, block=self.block, unroll=self.unroll)
        frame0, env_frames, spec = eng.prepare(a0, env)
        return self._drive(frame0, state0,
                           step=lambda fr: eng.sweeps(fr, env_frames, spec),
                           state_view=lambda fr: eng.unframe(fr, spec),
                           finalize=lambda fr: eng.unframe(fr, spec))

    # -- the repeat/until driver (all backends) --------------------------
    def _drive(self, a0, state0, *, step, state_view, finalize
               ) -> LoopResult:
        """The repeat/until driver: ``step(a) -> (a_new, reduced)`` does
        ``unroll`` stencil applications in whatever representation the
        backend carries (array or halo frame).  The body runs while the
        loop is not done and ``it < max_iters``; ``it`` advances by
        ``unroll`` (a host integer: it never needs reading back).  Reduce,
        condition and health word stay on the device; the one host read
        per check is the done flag."""
        dev = self.device
        a, s = a0, state0
        r = torch.full((), self._id, device=dev)
        it = 0
        hw = torch.zeros((), dtype=torch.int32, device=dev)
        while it < self.max_iters:
            a, r_new = step(a)
            it_new = it + self.unroll
            if self.state_update is not None:
                s = self.state_update(s, state_view(a), it_new)
            done = self._cond_value(r_new, s)
            hw, quar = health_update(hw, r_new, r, True, done, it,
                                     self.sentinel)
            r, it = r_new, it_new
            if bool(done | quar):
                break
        return LoopResult(a=finalize(a), reduced=r,
                          iters=torch.tensor(it, dtype=torch.int32,
                                             device=dev),
                          state=s, health=hw)


# ---------------------------------------------------------------------------
# Functional front-ends (match the paper's procedure signatures).
# ---------------------------------------------------------------------------

def loop_of_stencil_reduce(k, f, combine, c, a, *, identity=None,
                           boundary="zero", max_iters=10_000, mode="taps",
                           unroll=1, backend=None, env=(),
                           device=None) -> LoopResult:
    """LOOP-OF-STENCIL-REDUCE(k, f, ⊕, c, a) — base variant."""
    return LoopOfStencilReduce(
        f=f, k=k, combine=combine, identity=identity, cond=c, mode=mode,
        boundary=boundary, max_iters=max_iters, unroll=unroll,
        backend=backend, device=device).run(a, env=env)


def loop_of_stencil_reduce_d(k, f, delta, combine, c, a, *, identity=None,
                             boundary="zero", max_iters=10_000,
                             mode="taps", unroll=1, backend=None,
                             env=(), device=None) -> LoopResult:
    """-D variant: convergence measured on δ between successive iterates."""
    return LoopOfStencilReduce(
        f=f, k=k, combine=combine, identity=identity, cond=c, delta=delta,
        mode=mode, boundary=boundary, max_iters=max_iters,
        unroll=unroll, backend=backend, device=device).run(a, env=env)


def loop_of_stencil_reduce_s(k, f, combine, c, a, *, init, update,
                             identity=None, boundary="zero",
                             max_iters=10_000, mode="taps",
                             unroll=1, backend=None, env=(),
                             device=None) -> LoopResult:
    """-S variant: a global state participates in the condition."""
    return LoopOfStencilReduce(
        f=f, k=k, combine=combine, identity=identity, cond=c,
        state_init=init, state_update=update, mode=mode, boundary=boundary,
        max_iters=max_iters, unroll=unroll, backend=backend,
        device=device).run(a, env=env)
