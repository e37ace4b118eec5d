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
host read per check is the done flag.  On the kernel backends
(``"cuda"``, ``"cuda-multistep"``) the loop body is a hand-written kernel
on a persistent halo frame (:class:`repro_torch.core.executor.
StencilEngine`); on ``"torch"`` it is the shift algebra.

:meth:`LoopOfStencilReduce.farm_run` runs a farm of such loops (the
paper's 1:1 streaming mode) as one done-masked host loop over a
lane-stacked carry, one kernel launch per sweep for every lane.
:meth:`LoopOfStencilReduce.lane_segment` (on :func:`segmented_while`)
runs a bounded slice of that loop, the continuous-refill primitive of the
streaming :class:`repro_torch.core.streaming.FarmEngine`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from ..device import KERNEL_BACKENDS, resolve_backend, resolve_device, \
    to_device
from .executor import AUTO_UNROLL_BLOCK, auto_unroll, check_unroll_feasible
from .frames import DEFAULT_BLOCK
from .reduce import (HEALTH_STALL_MASK, health_update, resolve_monoid,
                     tree_reduce)
from .semantics import Boundary
from .stencil import stencil_indexed, stencil_taps, stencil_windows


def segmented_while(body, carry, *, finished, segment, early_exit=True):
    """Bounded early-exit slice of a done-masked lane loop (twin of
    :func:`repro.core.pattern.segmented_while`).

    Runs ``body`` (carry → carry) until any lane **newly** satisfies
    ``finished(carry)`` (a (lanes,) bool tensor), no unfinished lane
    remains, or ``segment`` body steps have run.  Lanes finished at entry
    do not trigger the exit — only a 0→1 transition does.  Returns
    ``(carry', steps)`` with ``steps`` a host int.

    The reference's on-device ``while_loop`` becomes a host loop: one host
    read of the exit test before each body step, and one after the last
    step unless the segment ran its full ``segment`` steps — so it exits at
    the same step as the reference.  ``early_exit=False`` runs exactly
    ``segment`` done-masked steps and reads nothing.
    """
    if not early_exit:
        for _ in range(segment):
            carry = body(carry)
        return carry, segment
    fin0 = finished(carry)
    fin, steps = fin0, 0
    while steps < segment:
        newly = (fin & ~fin0).any()
        if not bool((~fin).any() & ~newly):
            break
        carry = body(carry)
        steps += 1
        fin = finished(carry)
    return carry, steps


def segment_reads(steps: int, segment: int) -> int:
    """Host reads :func:`segmented_while` made for a segment of ``steps``
    body steps (early exit on)."""
    return steps + (steps < segment)


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
              On the kernel backends an :class:`~repro_torch.kernels.
              ref.Elemental` (the factories of
              :mod:`repro_torch.kernels.ref`).
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
              ``"auto"`` resolves to 1 on the single-step backends and by
              :func:`~repro_torch.core.executor.auto_unroll` (with this
              loop's ``block``, or the reference's default where it is
              None) on ``"cuda-multistep"``, where ``unroll`` is the
              number of sweeps fused into one launch.
    backend:  ``None`` (``"cuda"`` on a CUDA device, ``"torch"`` on the
              CPU), ``"torch"``, ``"cuda"`` or ``"cuda-multistep"`` (the
              kernel backends: taps mode, 2-D arrays).
    block:    the frame's block (rows, cols): its round-up (the kernels
              choose their own CTA tile); None lays frames out by
              ``frames.DEFAULT_BLOCK``.
    sentinel: a :class:`~repro_torch.core.reduce.Sentinel` health policy,
              or None (only the CONVERGED bit is tracked).
    device:   ``None`` (the CUDA card) or an explicit device.
    fault_hook: fault-injection seam of the lane paths: ``hook(r, it) ->
              r`` intercepts the (lanes,) reduce after each step, before the
              condition (see :mod:`repro_torch.resilience.faults`); None in
              production.
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
    block: Optional[tuple] = None
    sentinel: Optional[Any] = None
    device: Any = None
    fault_hook: Optional[Callable] = None

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
        if self.backend in KERNEL_BACKENDS:
            if self.mode != "taps" or getattr(a0, "ndim", None) != 2:
                raise ValueError(
                    f"backend {self.backend!r} requires mode='taps' and a "
                    f"2-D array; got mode={self.mode!r}, "
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
    def _resolve_unroll(self, shape,
                        segment=None) -> "LoopOfStencilReduce":
        """Resolve ``unroll="auto"`` against the grid shape and fail loudly
        on an infeasible halo.  Returns ``self`` when nothing changes, else
        a resolved copy.  ``segment`` (continuous farms: body steps per
        dispatch) folds the per-dispatch cost into the tuning, as in the
        reference (:func:`~repro_torch.core.executor.auto_unroll`)."""
        if shape is None or len(shape) < 2:
            if self.unroll == "auto":
                return dataclasses.replace(self, unroll=1)
            return self
        m, n = shape[-2], shape[-1]
        if self.unroll == "auto":
            T = (auto_unroll(m, n, k=self.k,
                             block=self.block or AUTO_UNROLL_BLOCK,
                             segment=segment)
                 if self.backend == "cuda-multistep" else 1)
            return dataclasses.replace(self, unroll=T)
        if self.backend in KERNEL_BACKENDS:
            sweeps = self.unroll if self.backend == "cuda-multistep" else 1
            check_unroll_feasible(m, n, sweeps, k=self.k)
        return self

    def _engine(self):
        """The persistent-frame engine of this loop: temporal blocking on
        ``"cuda-multistep"``, single sweeps otherwise."""
        from .executor import StencilEngine

        return StencilEngine(
            f=self.f, k=self.k, boundary=self.boundary,
            combine=self.combine, identity=self.identity, delta=self.delta,
            measure=self.measure, block=self.block or DEFAULT_BLOCK,
            unroll=self.unroll,
            backend=("cuda-multistep" if self.backend == "cuda-multistep"
                     else "cuda"))

    # -- the persistent-halo loop (kernel backends) ----------------------
    def _run_persistent(self, a0, state0, env) -> LoopResult:
        """Zero-copy realisation: the halo frame is the loop carry.
        Framing happens once in ``prepare``; the body is kernel launches +
        the O(m+n) ghost refresh; the domain is sliced out once at the
        end.  (The -s variant's ``state_update`` sees a copy of the (m, n)
        domain each check — avoid it on hot paths.)"""
        eng = self._engine()
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

    # -- the lane-stacked loop (1:1 farm) --------------------------------
    def farm_run(self, a0, *, env=(), done0=None) -> LoopResult:
        """Run a FARM of convergence loops as one done-masked loop over a
        stacked (lanes, m, n) carry — the paper's 1:1 streaming mode.

        ``a0`` carries a leading lane axis, and so does every ``env`` field
        (each item brings its own).  On the kernel backends the lane frames
        are staged once and each launch sweeps every lane (``blockIdx.z``
        is the lane); each lane runs to its own trip count, and a lane that
        is done keeps its value while the others sweep.  ``done0`` (a
        (lanes,) bool) pre-masks lanes.  Results match ``run`` lane by lane;
        ordering is positional.  ``cond`` is applied to the (lanes,) reduce
        vector and must act elementwise (``lambda r: r < tol`` does); a
        ``cond`` that answers with a scalar is applied lane by lane.
        On ``"torch"`` the step mode takes a tensor carry.
        """
        if self.state_init is not None:
            raise ValueError(
                "the -s variant is not supported on farm_run "
                "(per-lane states do not compose with a shared loop "
                "state)")
        if self.backend == "cuda-sharded":
            raise ValueError(
                "backend='cuda-sharded' lanes are driven by the streaming "
                "FarmEngine (they need a mesh carrying both the lane and "
                "the spatial axes; ROADMAP.md queue A6/A7)")
        a0 = to_device(a0, self.device)
        env = tuple(to_device(e, self.device) for e in env)
        shape = getattr(a0, "shape", None)
        resolved = self._resolve_unroll(shape and shape[1:])
        if resolved is not self:
            return resolved.farm_run(a0, env=env, done0=done0)
        if self.backend in KERNEL_BACKENDS:
            if self.mode != "taps" or getattr(a0, "ndim", None) != 3:
                raise ValueError(
                    f"backend {self.backend!r} farm_run requires "
                    f"mode='taps' and a (lanes, m, n) stack; got mode="
                    f"{self.mode!r}, ndim={getattr(a0, 'ndim', None)}")
            eng = self._engine()
            frames, env_frames, lspec = eng.prepare_lanes(a0, env)
            return self._drive_lanes(
                frames,
                step=lambda fr, live: eng.sweeps(fr, env_frames,
                                                 lspec.frame, live),
                finalize=lambda fr: eng.unframe(fr, lspec.frame),
                done0=done0)
        return self._drive_lanes(a0, step=self._lane_step_torch(env),
                                 finalize=lambda a: a, done0=done0)

    def _lane_step_torch(self, env):
        """The ``unroll``-deep step over a lane-stacked carry on the
        ``"torch"`` backend, lane by lane (``env`` fields lane-stacked
        alongside); lanes that are not live come back unchanged."""
        def one(a1, e):
            a_prev = a1
            for _ in range(self.unroll):
                a_prev, a1 = a1, self._apply(a1, e)
            return a1, self._reduce(self._measure(a1, a_prev))

        def step(a, live):
            outs = [one(a[i], tuple(e[i] for e in env))
                    for i in range(a.shape[0])]
            a_new = torch.stack([o[0] for o in outs])
            keep = live.reshape((-1,) + (1,) * (a.ndim - 1))
            return (torch.where(keep, a_new, a),
                    torch.stack([o[1] for o in outs]))
        return step

    def _lane_cond(self, r) -> torch.Tensor:
        """The condition per lane, as a (lanes,) bool tensor: ``cond`` sees
        one lane's reduce at a time, as under the reference's vmap, so a
        condition that is not elementwise gives the same answer here."""
        return torch.stack([self._cond_value(r[i], None)
                            for i in range(r.shape[0])])

    def _lane_body(self, step, carry):
        """One done-masked step of the lane loop.  ``carry = (a, r, it,
        done, hw)``; ``step(a, live)`` sweeps the live lanes and leaves the
        others as they are.  A lane whose flag (or iteration cap) has fired
        keeps its reduce, count and health word while the others run on;
        the sentinel folds each live lane's reduce into its health word and
        a POISONED or DIVERGED lane is masked done on the spot."""
        a, r, it, done, hw = carry
        live = ~done & (it < self.max_iters)
        a, r_new = step(a, live)
        if self.fault_hook is not None:
            r_new = self.fault_hook(r_new, it)
        done_new = self._lane_cond(r_new)
        hw_new, quar = health_update(hw, r_new, r, live, done_new, it,
                                     self.sentinel)
        retire = done_new | quar
        return (a,
                torch.where(live, r_new, r.to(r_new.dtype)),
                torch.where(live, it + self.unroll, it),
                torch.where(live, done | retire, done),
                torch.where(live, hw_new, hw))

    def _lane_finished(self, carry) -> torch.Tensor:
        """Per-lane mask of lanes that need no more sweeps: condition fired
        (or quarantined) or iteration cap hit."""
        it, done = carry[2], carry[3]
        return done | (it >= self.max_iters)

    def _drive_lanes(self, a0, *, step, finalize, done0=None
                     ) -> LoopResult:
        """Lane-stacked repeat/until: each lane owns a done flag and an
        iteration count on the device, and the loop runs while any lane is
        live — the one host read per check.  Lane for lane the same as
        :meth:`_drive` (the same reduce, condition and health word)."""
        dev = self.device
        lanes = a0.shape[0]
        carry = (a0,
                 torch.full((lanes,), self._id, device=dev),
                 torch.zeros((lanes,), dtype=torch.int32, device=dev),
                 (torch.zeros((lanes,), dtype=torch.bool, device=dev)
                  if done0 is None else
                  torch.as_tensor(done0, device=dev).to(torch.bool)
                  .reshape((lanes,))),
                 torch.zeros((lanes,), dtype=torch.int32, device=dev))
        while not bool(self._lane_finished(carry).all()):
            carry = self._lane_body(step, carry)
        a, r, it, _, hw = carry
        return LoopResult(a=finalize(a), reduced=r, iters=it, state=None,
                          health=hw)

    def lane_segment(self, carry, *, step, segment: int,
                     early_exit: bool = True):
        """One bounded slice of the lane loop — the continuous-refill tier.

        Runs the done-masked body of :meth:`_drive_lanes` (``step(a,
        live)`` as there) until a lane newly finishes (condition fired or
        iteration cap hit), after at most ``segment`` body steps, or at once
        when no live lane remains (:func:`segmented_while`).  ``carry = (a,
        r, it, done, hw)`` keeps its shapes, so a streaming executor refills
        the finished lanes' slots in place and resumes the same carry.
        Returns ``(carry', steps)``, each step ``unroll`` sweeps deep."""
        return segmented_while(lambda c: self._lane_body(step, c), carry,
                               finished=self._lane_finished,
                               segment=segment, early_exit=early_exit)


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
