"""Deterministic fault injection for Loop-of-stencil-reduce farms.

PyTorch twin of :mod:`repro.resilience.faults`: the same plans from the
same seeds (``seeded`` draws with numpy's ``default_rng`` exactly as the
reference does), and a torch ``reduce_hook``.

A :class:`FaultPlan` is a STATIC, seeded schedule of faults, attached to
a loop through the ``fault_hook`` seam in
:class:`repro_torch.core.pattern.LoopOfStencilReduce`: the hook
intercepts the fused per-lane reduce value inside the lane body — after
the real stencil+reduce, before the convergence condition and the
sentinel — so an injected fault exercises exactly the detection path a
real NaN-ed or non-converging item would, at zero cost to the fault-free
loop (no hook, no extra ops).

Faults address LANES (device slots), not stream items: a NaN event on
lane 2 poisons WHATEVER item occupies slot 2 when the trigger sweep
arrives, exactly like flaky hardware or a corrupted resident frame
would.  That is what makes retry-into-a-fresh-slot a meaningful
recovery: the retried item escapes the fault, and the slot keeps
failing occupants until the engine's ``slot_patience`` retires it.
On a farm over a mesh (``FarmEngine(mesh=...)``) the hook sees each lane
shard's own (local lanes,) vectors, as under the reference's
``shard_map``: a plan's lane indexes a lane within every lane shard.

Stream-item corruption (``corrupt_indices``) is the complementary axis:
the fault follows the ITEM (a NaN planted in its input array), so it is
caught by the admission-time finite check however often it is retried.

Everything is pure numpy/static-python at plan-build time and (lanes,)
tensor masking inside the hook — the same plan replays bit-identically
on every run and backend (the chaos tests' foundation).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A static fault schedule over ``lanes`` device slots.

    ``nan_events``       — ``(lane, from_sweep)`` pairs: the lane's
                           reduce value reads NaN from that sweep on
                           (the sentinel's poison detector must fire).
    ``stall_events``     — ``(lane, until_sweep)`` pairs: the lane's
                           reduce value is pinned at ``stall_value``
                           while ``it < until_sweep`` — it cannot
                           converge, so it either trips the sentinel's
                           divergence patience or exhausts the
                           iteration budget (``until_sweep`` beyond
                           ``max_iters`` = a permanent stall).
    ``corrupt_indices``  — stream positions whose ITEMS get a NaN
                           planted at the prep boundary
                           (:meth:`corrupt_stream`) — admission-check
                           fodder.
    ``preempt_at_segment`` — a PROCESS fault: the dispatcher is killed
                           after completing this many segments (1-based)
                           via the ``on_segment`` seam in
                           ``FarmEngine.run_continuous``.  See
                           :meth:`preempt_hook`.
    """
    lanes: int
    nan_events: Tuple[Tuple[int, int], ...] = ()
    stall_events: Tuple[Tuple[int, int], ...] = ()
    corrupt_indices: Tuple[int, ...] = ()
    stall_value: float = 1e9
    preempt_at_segment: "int | None" = None

    def __post_init__(self):
        for lane, _ in (*self.nan_events, *self.stall_events):
            if not 0 <= lane < self.lanes:
                raise ValueError(
                    f"fault lane {lane} outside [0, lanes={self.lanes})")

    @classmethod
    def seeded(cls, seed: int, lanes: int, *, n_nan: int = 1,
               n_stall: int = 1, nan_from_max: int = 4,
               stall_until: int = 1 << 20, n_corrupt: int = 0,
               n_items: int = 0, stall_value: float = 1e9,
               preempt_within: int = 0) -> "FaultPlan":
        """Draw a reproducible plan: ``n_nan`` + ``n_stall`` DISTINCT
        victim lanes (never more than ``lanes - 1`` total — at least one
        lane always stays healthy, so every chaos test has a clean
        control group), NaN triggers in ``[1, nan_from_max]``, and
        ``n_corrupt`` corrupted stream positions out of ``n_items``.
        ``preempt_within > 0`` additionally draws a kill point
        ``preempt_at_segment`` uniformly from ``[1, preempt_within]``.
        Same seed → same plan, bit for bit."""
        rng = np.random.default_rng(seed)
        n_victims = min(n_nan + n_stall, max(lanes - 1, 0))
        victims = rng.choice(lanes, size=n_victims, replace=False)
        n_nan = min(n_nan, n_victims)
        nan_events = tuple(
            (int(l), int(rng.integers(1, nan_from_max + 1)))
            for l in victims[:n_nan])
        stall_events = tuple((int(l), int(stall_until))
                             for l in victims[n_nan:])
        corrupt: Tuple[int, ...] = ()
        if n_corrupt and n_items:
            corrupt = tuple(int(i) for i in np.sort(rng.choice(
                n_items, size=min(n_corrupt, n_items), replace=False)))
        preempt = (int(rng.integers(1, preempt_within + 1))
                   if preempt_within > 0 else None)
        return cls(lanes=lanes, nan_events=nan_events,
                   stall_events=stall_events, corrupt_indices=corrupt,
                   stall_value=stall_value, preempt_at_segment=preempt)

    # -- the device-side seam ---------------------------------------------
    def reduce_hook(self):
        """The ``(r, it) -> r`` hook for
        ``LoopOfStencilReduce.fault_hook``: per-lane masked overwrites
        of the fused reduce value (a handful of (lanes,) ops on the
        device — nothing touches the grid).  ``r`` and ``it`` are
        (lanes,) tensors."""
        import torch

        nan_events, stall_events = self.nan_events, self.stall_events
        stall_value = self.stall_value

        def hook(r, it):
            lanes = torch.arange(r.shape[0], device=r.device)
            for lane, from_sweep in nan_events:
                mask = (lanes == lane) & (it >= from_sweep)
                r = torch.where(mask, torch.full_like(r, float("nan")), r)
            for lane, until in stall_events:
                mask = (lanes == lane) & (it < until)
                r = torch.where(mask, torch.full_like(r, stall_value), r)
            return r
        return hook

    def instrument(self, loop):
        """A copy of ``loop`` carrying this plan's hook (the original is
        untouched — run both to compare faulted vs fault-free)."""
        return dataclasses.replace(loop, fault_hook=self.reduce_hook())

    # -- the process-fault seam -------------------------------------------
    def preempt_hook(self, mode: str = "exit"):
        """An ``on_segment(segments_done)`` callback that preempts the
        process once ``segments_done`` reaches ``preempt_at_segment``.

        ``mode="exit"`` dies via ``os._exit(PREEMPTED_EXIT)`` — no
        ``finally`` blocks, no atexit, no flushing: the closest a test
        gets to SIGKILL-on-spot-reclaim while staying portable.  The
        ``recovery.run_to_completion`` harness respawns on that exit
        code.  ``mode="raise"`` raises
        :class:`~repro.resilience.recovery.PreemptionError` instead, for
        in-process tests that resume inside the same interpreter (the
        engine's ``finally`` DOES run — strictly gentler than a kill, so
        subprocess tests stay the authority on crash-hardness).

        Fires at most once per process (a resumed run that passes the
        same plan again is not re-killed unless it re-reaches the
        threshold counting from ITS OWN segment 0 — pass ``None``
        recovery-side to disarm instead)."""
        if self.preempt_at_segment is None:
            return None
        import os as _os

        from .recovery import PREEMPTED_EXIT, PreemptionError
        threshold = self.preempt_at_segment
        fired = []

        def hook(segments_done: int):
            if fired or segments_done < threshold:
                return
            fired.append(segments_done)
            if mode == "raise":
                raise PreemptionError(
                    f"seeded preemption at segment {segments_done}")
            _os._exit(PREEMPTED_EXIT)
        return hook

    # -- the prep-boundary seam -------------------------------------------
    def corrupt_item(self, item):
        """Plant one NaN in the main leaf of ``item`` (a copy; a tensor
        stays a tensor, anything else becomes a numpy array)."""
        import torch

        if isinstance(item, tuple):
            return (self.corrupt_item(item[0]), *item[1:])
        if isinstance(item, torch.Tensor):
            t = item.clone()
            if t.is_floating_point() and t.numel():
                t.view(-1)[t.numel() // 2] = float("nan")
            return t
        arr = np.array(item, copy=True)
        if np.issubdtype(arr.dtype, np.floating) and arr.size:
            arr.flat[arr.size // 2] = np.nan
        return arr

    def corrupt_stream(self, items):
        """Lazily yield ``items`` with the planned positions corrupted —
        drop-in for a FarmEngine source."""
        bad = set(self.corrupt_indices)
        for i, item in enumerate(items):
            yield self.corrupt_item(item) if i in bad else item
