"""The Loop-of-stencil-reduce pattern — production implementation.

PyTorch twin of :mod:`repro.core.pattern`.  Pattern semantics (paper §3.1,
all variants, composable):

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
StencilEngine`); on ``"torch"`` it is the shift algebra.  On
``"cuda-sharded"`` (the 1:n deployment) the carry is one frame per shard of
a device mesh (:class:`repro_torch.core.executor.ShardedStencilEngine`)
and the reduce the condition reads is the fold of the shards' partials.

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

from .. import obs
from ..device import KERNEL_BACKENDS, resolve_backend, resolve_device, \
    to_device
from ..sharding.specs import normalise_device
from .executor import AUTO_UNROLL_BLOCK, auto_unroll, check_unroll_feasible
from .frames import DEFAULT_BLOCK
from .reduce import (HEALTH_STALL_MASK, health_update, resolve_monoid,
                     tree_reduce)
from .semantics import Boundary
from .stencil import stencil_indexed, stencil_taps, stencil_windows


def segmented_while(body, carry, *, finished, segment, early_exit=True,
                    shards=None):
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

    ``shards`` splits the lanes into that many equal lane shards, each
    running its own segment, as the reference's ``shard_map`` does: a shard
    stops on its own exit test, the others step on.  One host loop steps
    them in lockstep with one read a step of every shard's test;
    ``body(carry, active)`` gets the host list of shards that step, and
    ``steps`` is a list, one count a shard.
    """
    P = shards or 1
    call = body if shards is not None else (lambda c, active: body(c))
    steps = [0] * P
    if not early_exit:
        for _ in range(segment):
            with obs.span("loop.step", device=True):
                carry = call(carry, [True] * P)
        steps = [segment] * P
    else:
        fin0 = fin = finished(carry)
        active = [True] * P
        while True:
            cand = [a and n < segment for a, n in zip(active, steps)]
            if not any(cand):
                break
            with obs.span("loop.exit_read"):
                go = ((~fin).reshape(P, -1).any(1)
                      & ~(fin & ~fin0).reshape(P, -1).any(1)).tolist()
            active = [c and g for c, g in zip(cand, go)]
            if not any(active):
                break
            with obs.span("loop.step", device=True):
                carry = call(carry, active)
                fin = finished(carry)
            steps = [n + a for n, a in zip(steps, active)]
    return carry, (steps if shards is not None else steps[0])


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
              CPU), ``"torch"``, ``"cuda"``, ``"cuda-multistep"`` or
              ``"cuda-sharded"`` (the kernel backends: taps mode, 2-D
              arrays).  ``"cuda-sharded"`` is the 1:n deployment: per-shard
              frames, edge-strip exchange, a fold of the partial reduces;
              ``unroll=T`` > 1 runs T fused sweeps a shard per exchange
              (``"auto"`` resolves on the local extents).
    partition: a :class:`repro_torch.sharding.GridPartition` — required by
              (and only read on) ``"cuda-sharded"``.
    block:    the frame's block (rows, cols): its round-up (the kernels
              choose their own CTA tile); None lays frames out by
              ``frames.DEFAULT_BLOCK``.
    sentinel: a :class:`~repro_torch.core.reduce.Sentinel` health policy,
              or None (only the CONVERGED bit is tracked).
    device:   ``None`` (the CUDA card; on ``"cuda-sharded"`` the
              partition's lead device) or an explicit device.
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
    partition: Optional[Any] = None
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
        if self.backend == "cuda-sharded":
            if self.partition is None:
                raise ValueError(
                    "backend='cuda-sharded' needs a partition= "
                    "(repro_torch.sharding.GridPartition)")
            lead = self.partition.lead
            if self.device is None:
                self.device = lead
            elif normalise_device(self.device) != lead:
                raise ValueError(
                    f"backend='cuda-sharded' runs its loop on the "
                    f"partition's lead device {str(lead)!r}; got "
                    f"device={str(self.device)!r}")
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
            if self.backend == "cuda-sharded":
                return self._run_sharded(a0, state0, env)
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
        reference (:func:`~repro_torch.core.executor.auto_unroll`).  On
        ``"cuda-sharded"`` both count on the partition's local extents."""
        if shape is None or len(shape) < 2:
            if self.unroll == "auto":
                return dataclasses.replace(self, unroll=1)
            return self
        m, n = shape[-2], shape[-1]
        part = self.partition if self.backend == "cuda-sharded" else None
        if self.unroll == "auto":
            deep = self.backend in ("cuda-multistep", "cuda-sharded")
            T = (auto_unroll(m, n, k=self.k,
                             block=self.block or AUTO_UNROLL_BLOCK,
                             part=part, segment=segment) if deep else 1)
            return dataclasses.replace(self, unroll=T)
        if self.backend in KERNEL_BACKENDS:
            sweeps = self.unroll if self.backend != "cuda" else 1
            check_unroll_feasible(m, n, sweeps, k=self.k, part=part)
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

    # -- the sharded persistent loop (1:n deployment) --------------------
    def _run_sharded(self, a0, state0, env) -> LoopResult:
        """The 1:n realisation: the carry is one halo frame per shard (a
        list in mesh order, each on its device); a check is a launch a
        shard, one edge-strip exchange and one fold of the partials on the
        lead device, where the condition and health word live — the one
        host read a check stays the done flag.  The grid is scattered once
        and gathered once, after convergence."""
        from ..sharding.specs import check_even, gather_grid, scatter_grid
        from .executor import ShardedStencilEngine

        if self.state_init is not None or state0 is not None:
            raise ValueError(
                "the -s variant is not supported on backend="
                "'cuda-sharded' (per-shard state views are ambiguous)")
        part = self.partition
        check_even(a0.shape, part)
        eng = ShardedStencilEngine(
            f=self.f, part=part, k=self.k, boundary=self.boundary,
            combine=self.combine, identity=self.identity, delta=self.delta,
            measure=self.measure, block=self.block or DEFAULT_BLOCK,
            unroll=self.unroll)
        frames0, env_frames, sspec = eng.prepare(
            scatter_grid(a0, part), [scatter_grid(e, part) for e in env])
        gather = lambda frs: gather_grid(eng.unframe(frs, sspec), part)
        return self._drive(
            frames0, None,
            step=lambda frs: eng.sweeps(frs, env_frames, sspec),
            state_view=gather, finalize=gather)

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
                "backend='cuda-sharded' lanes are driven by "
                "repro_torch.core.streaming.FarmEngine (they need a mesh "
                "carrying both the lane and the spatial axes)")
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

    def _lane_body(self, step, carry, shards=None, active=None):
        """One done-masked step of the lane loop.  ``carry = (a, r, it,
        done, hw)``; ``step(a, live)`` sweeps the live lanes and leaves the
        others as they are.  A lane whose flag (or iteration cap) has fired
        keeps its reduce, count and health word while the others run on;
        the sentinel folds each live lane's reduce into its health word and
        a POISONED or DIVERGED lane is masked done on the spot.

        With ``shards`` (lane shards of equal size) ``active`` is the host
        list of shards that step: the others' lanes are held, ``step(a,
        live, active)`` skips them, and the fault hook sees each shard's
        (local lanes,) vectors, as under the reference's ``shard_map``."""
        a, r, it, done, hw = carry
        live = ~done & (it < self.max_iters)
        if shards is None:
            a, r_new = step(a, live)
        else:
            if not all(active):
                live = live & torch.tensor(active, device=live.device) \
                    .repeat_interleave(live.shape[0] // shards)
            a, r_new = step(a, live, active)
        if self.fault_hook is not None:
            r_new = (self.fault_hook(r_new, it) if shards is None else
                     torch.cat([self.fault_hook(x, y) for x, y in
                                zip(r_new.chunk(shards), it.chunk(shards))]))
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

    def _drive_lanes(self, a0, *, step, finalize, done0=None,
                     cond_fold=None, shards=None) -> LoopResult:
        """Lane-stacked repeat/until: each lane owns a done flag and an
        iteration count on the device, and the loop runs while any lane is
        live — the one host read per check.  Lane for lane the same as
        :meth:`_drive` (the same reduce, condition and health word).

        ``shards`` splits the lanes into lane shards that each run their
        own loop, as under the reference's ``shard_map`` (see
        :meth:`_lane_body`): a shard whose lanes are all finished stops.
        ``cond_fold`` maps the (shards,) per-shard any-live vector to the
        shards that step: the composed lanes × spatial farm passes an
        ``any`` over it, so every shard runs to the slowest lane anywhere
        (the reference's lane-axis ``pmax``); None lets each stop on its
        own."""
        dev = self.device
        lanes = a0.shape[0] if done0 is None else len(done0)
        carry = (a0,
                 torch.full((lanes,), self._id, device=dev),
                 torch.zeros((lanes,), dtype=torch.int32, device=dev),
                 (torch.zeros((lanes,), dtype=torch.bool, device=dev)
                  if done0 is None else
                  torch.as_tensor(done0, device=dev).to(torch.bool)
                  .reshape((lanes,))),
                 torch.zeros((lanes,), dtype=torch.int32, device=dev))
        while True:
            run = (~self._lane_finished(carry)).reshape(shards or 1, -1) \
                .any(1)
            if cond_fold is not None:
                run = cond_fold(run)
            active = run.tolist()
            if not any(active):
                break
            carry = self._lane_body(step, carry, shards, active)
        a, r, it, _, hw = carry
        return LoopResult(a=finalize(a), reduced=r, iters=it, state=None,
                          health=hw)

    def lane_segment(self, carry, *, step, segment: int,
                     early_exit: bool = True, shards=None):
        """One bounded slice of the lane loop — the continuous-refill tier.

        Runs the done-masked body of :meth:`_drive_lanes` (``step(a,
        live)`` as there) until a lane newly finishes (condition fired or
        iteration cap hit), after at most ``segment`` body steps, or at once
        when no live lane remains (:func:`segmented_while`).  ``carry = (a,
        r, it, done, hw)`` keeps its shapes, so a streaming executor refills
        the finished lanes' slots in place and resumes the same carry.
        Returns ``(carry', steps)``, each step ``unroll`` sweeps deep.
        ``early_exit=False`` runs exactly ``segment`` done-masked steps (the
        composed farm's uniform schedule).  ``shards``: lane shards that
        each exit on their own (``steps`` then has one count a shard)."""
        if shards is None:
            body = lambda c: self._lane_body(step, c)
        else:
            body = lambda c, active: self._lane_body(step, c, shards, active)
        return segmented_while(body, carry, finished=self._lane_finished,
                               segment=segment, early_exit=early_exit,
                               shards=shards)


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
