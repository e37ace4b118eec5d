"""Stream-parallel tier: pipe / farm / ofarm on the persistent engine.

PyTorch twin of :mod:`repro.core.streaming` (single-device part).  The
paper's two-tier model: data-parallel patterns (stencil, reduce,
Loop-of-stencil-reduce) nest inside stream-parallel ones (pipe, farm).
The experiments use exactly two compositions:

    pipe(read, sobel, write)                       (§4.2)
    pipe(read, detect, ofarm(restore), write)      (§4.3)

Two tiers, as in the reference:

* the *generic* tier — :func:`pipe`, :func:`farm`, :func:`ofarm`,
  :class:`StreamRunner` — maps arbitrary workers over stream items.  The
  reference vmaps a pure worker; here :func:`farm` calls the worker once
  per item and stacks the results.  :class:`StreamRunner` drains batch
  i−1 after dispatching batch i, riding CUDA's asynchronous launch queue.

* the *engine* tier — :class:`FarmEngine` — the persistent-device farm
  for workers that are a Loop-of-stencil-reduce.  L lane *slots* hold
  persistent halo frames (:mod:`repro_torch.core.frames`) allocated once,
  from the first item's shapes; the farm advances as one done-masked
  loop over the stacked carry, and finished slots are refilled in place
  (``copy_`` into the interior view, ghost ring re-asserted) — no frame
  is re-allocated or re-framed across the stream.  Round mode runs each
  batch to its slowest lane; continuous mode runs bounded early-exit
  segments (:meth:`~repro_torch.core.pattern.LoopOfStencilReduce.
  lane_segment`) and hands finished slots to the next items mid-flight,
  emitting :class:`StreamResult` in completion order — classic (per-slot
  refills) or chained (the default: a device staging ring, seating by a
  device-side cursor, one packed metadata read per drained segment).

Where the reference runs an on-device ``while_loop``, the port runs a host
loop over device tensors with one host read per body step.  Results leave
the device once per emission (round mode: once per round) and reach the
sink as CPU tensors.  :func:`sharded_farm` spreads a generic farm's lanes
over a mesh axis.  ``FarmEngine(mesh=...)`` spreads the engine's slots over
a mesh axis (each lane shard its own loop), and with a ``"cuda-sharded"``
loop each lane's frame is split over the partition's axes of the same mesh
too (the composed lanes × spatial farm); one host loop drives every shard,
as the reference's single controller does.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from itertools import islice
from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch

from .. import obs
from ..device import resolve_backend, resolve_device, to_device
from ..sharding.specs import (axis_devices, check_even, gather_grid,
                              local_slot, scatter_grid, slice_partition)
from .executor import _on, local_extents
from .frames import DEFAULT_BLOCK, alloc_stage_ring, stage_ring_write, unframe
from .pattern import LoopResult, segment_reads
from .reduce import HEALTH_CONVERGED, HEALTH_DIVERGED, HEALTH_POISONED

# the engine's spans (repro_torch.obs); the device ones record CUDA events
FARM_SPANS = ("farm.stage", "farm.check", "farm.upload", "farm.prep",
              "farm.dispatch", "farm.drain", "farm.emit", "farm.payload",
              "farm.sink", "loop.step", "loop.exit_read")
FARM_DEVICE_SPANS = ("farm.upload", "farm.prep", "farm.dispatch",
                     "farm.payload", "loop.step")


class NonFiniteItemError(ValueError):
    """A stream item carried NaN/Inf leaves at the prep boundary.  Round
    mode raises it (loudly, at admission — not as an opaque NaN cascade
    ten sweeps downstream); continuous mode routes the item to the
    dead-letter list with ``status="rejected"`` and keeps streaming."""


def item_status(hw: int, iters: int, max_iters: int) -> str:
    """The streaming status taxonomy of one finished item, from its
    packed health word + trip count: ``ok`` (condition fired, no fault),
    ``poisoned`` (NaN/Inf reduce), ``nonconverged`` (sentinel divergence
    quarantine), ``timed_out`` (iteration budget exhausted)."""
    hw = int(hw)
    if hw & HEALTH_POISONED:
        return "poisoned"
    if hw & HEALTH_DIVERGED:
        return "nonconverged"
    if hw & HEALTH_CONVERGED:
        return "ok"
    return "timed_out" if int(iters) >= max_iters else "nonconverged"


# ---------------------------------------------------------------------------
# trees of tensors (the port's stand-in for jax.tree over worker results)
# ---------------------------------------------------------------------------


def _tree_map(fn, *trees):
    t = trees[0]
    if isinstance(t, (tuple, list)):
        return type(t)(_tree_map(fn, *xs) for xs in zip(*trees))
    if isinstance(t, dict):
        return {k: _tree_map(fn, *(x[k] for x in trees)) for k in t}
    if dataclasses.is_dataclass(t) and not isinstance(t, type):
        return dataclasses.replace(t, **{
            f.name: _tree_map(fn, *(getattr(x, f.name) for x in trees))
            for f in dataclasses.fields(t)})
    if t is None:
        return None
    return fn(*trees)


def _tree_leaves(t) -> list:
    out = []
    _tree_map(lambda x: out.append(x), t)
    return out


def _stack(*xs):
    return torch.stack([torch.as_tensor(x) for x in xs])


# ---------------------------------------------------------------------------
# the generic tier
# ---------------------------------------------------------------------------


def pipe(*stages: Callable) -> Callable:
    """pipe(a, b, ...) — functional composition b∘a, per stream item."""
    def run(x):
        for s in stages:
            x = s(x)
        return x
    return run


def farm(worker: Callable, *, lanes_axis: int = 0) -> Callable:
    """1:1 mode, generic tier — apply ``worker`` to every item of a
    stacked stream batch: once per item along ``lanes_axis``, the results
    stacked along it (the reference vmaps a pure worker; a worker that
    drives its own host loop, as AMF detection does, cannot be vmapped).

    For a farm of convergence loops on the persistent engine use
    :meth:`~repro_torch.core.pattern.LoopOfStencilReduce.farm_run` or
    :class:`FarmEngine` instead."""
    def run(batch):
        n = _tree_leaves(batch)[0].shape[lanes_axis]
        outs = [worker(_tree_map(
            lambda x: torch.as_tensor(x).select(lanes_axis, i), batch))
            for i in range(n)]
        return _tree_map(lambda *xs: torch.stack(
            [torch.as_tensor(x) for x in xs], dim=lanes_axis), *outs)
    return run


def ofarm(worker: Callable, *, lanes_axis: int = 0) -> Callable:
    """Order-preserving farm: :func:`farm` keeps positions, so this is
    ``farm`` with the paper's ordering contract made explicit."""
    return farm(worker, lanes_axis=lanes_axis)


def sharded_farm(worker: Callable, mesh: Any, axis: str = "data"):
    """Generic-tier farm whose lanes are spread over mesh axis ``axis``
    (a :class:`repro_torch.sharding.Mesh`).

    A batch's lanes split evenly over the devices along ``axis`` (the other
    mesh axes at their first device), in order; each chunk moves to its
    device and runs through :func:`farm` there, and the results are
    stacked on the mesh's first device in lane order.  Every batch
    re-enters the worker from the host, as in the reference; the engine
    tier over a mesh is ``FarmEngine(mesh=...)``.
    """
    devices = axis_devices(mesh, axis)
    inner = farm(worker)

    def run(batch):
        lanes = _tree_leaves(batch)[0].shape[0]
        if lanes % len(devices):
            raise ValueError(
                f"a batch of {lanes} lanes must divide evenly over mesh "
                f"axis {axis!r} (size {len(devices)})")
        per = lanes // len(devices)
        outs = [inner(_tree_map(
                    lambda x: torch.as_tensor(x)[c * per:(c + 1) * per]
                    .to(dev), batch))
                for c, dev in enumerate(devices)]
        return _tree_map(lambda *xs: torch.cat(
            [torch.as_tensor(x).to(devices[0]) for x in xs]), *outs)
    return run


@dataclasses.dataclass
class StreamRunner:
    """Host-side stream loop: feeds batches of stream items through a
    worker with double-buffered dispatch — batch i+1 is read and
    dispatched (CUDA launches return before the device finishes) before
    the sink consumes batch i.

    Generic tier: the worker re-enters from the host per batch.  Farms of
    convergence loops should ride :class:`FarmEngine`, which shares this
    host protocol but keeps the loop state (the halo frames) on the device
    between batches."""

    worker: Callable                  # device stage, takes a stacked batch
    source: Callable[[], Iterator]    # read stage: yields host items
    sink: Callable[[Any], None]       # write stage: consumes results
    batch: int = 1

    def run(self) -> int:
        it = self.source()
        n = 0
        inflight = None
        while True:
            chunk = []
            for _ in range(self.batch):
                try:
                    chunk.append(next(it))
                except StopIteration:
                    break
            if not chunk and inflight is None:
                break
            nxt = None
            if chunk:
                stacked = (_tree_map(_stack, *chunk) if len(chunk) > 1
                           else _tree_map(lambda x: torch.as_tensor(x)[None],
                                          chunk[0]))
                nxt = self.worker(stacked)
            if inflight is not None:
                for item in self._unstack(inflight):
                    self.sink(item)
                    n += 1
            inflight = nxt
            if not chunk:
                break
        if inflight is not None:
            for item in self._unstack(inflight):
                self.sink(item)
                n += 1
        return n

    @staticmethod
    def _unstack(batched) -> Iterator:
        """Yield per-item views of a stacked result lazily — the sink runs
        on item i before item i+1 is sliced."""
        leaves = _tree_leaves(batched)
        if not leaves:
            return
        for i in range(leaves[0].shape[0]):
            yield _tree_map(lambda x: x[i], batched)


# ---------------------------------------------------------------------------
# FarmEngine — the lane-resident streaming engine (engine tier).
# ---------------------------------------------------------------------------


def _default_prep(item):
    """Identity prep.  A bare array IS the loop input; a TUPLE stream
    item carries its own read-only env fields along — ``(a, *env)``."""
    if isinstance(item, tuple):
        return item[0], tuple(item[1:])
    return item, ()


def _leaf(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.asarray(x))


def _as_item(item):
    """Normalise one stream item to tensor leaves (numpy arrays are
    wrapped without a copy; tuple items keep their env leaves)."""
    if isinstance(item, (tuple, list)):
        return tuple(_leaf(leaf) for leaf in item)
    return _leaf(item)


def _item_leaves(item) -> tuple:
    return item if isinstance(item, tuple) else (item,)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _item_nbytes(item) -> int:
    return sum(_nbytes(leaf) for leaf in _item_leaves(item))


def _stack_items(batch: list):
    """Stack a list of stream items leaf-wise."""
    batch = [_as_item(it) for it in batch]
    if isinstance(batch[0], tuple):
        return tuple(torch.stack([it[j] for it in batch])
                     for j in range(len(batch[0])))
    return torch.stack(batch)


def _item_at(items, i):
    """Item ``i`` of a stacked batch (a tensor, or a tuple of stacks)."""
    if isinstance(items, tuple):
        return tuple(leaf[i] for leaf in items)
    return items[i]


def _nonfinite(leaf: torch.Tensor) -> bool:
    return leaf.is_floating_point() and not bool(torch.isfinite(leaf).all())


def _put(vec: torch.Tensor, idx: int, value) -> torch.Tensor:
    """``vec`` with entry ``idx`` set to ``value`` (a copy: the old vector
    may still be referenced by an in-flight drain)."""
    vec = vec.clone()
    vec[idx] = value
    return vec


def _dev_key(dev: torch.device):
    """A device as (type, index), the index of a bare "cuda" being 0."""
    return dev.type, dev.index or 0


def _cat(rs: list) -> torch.Tensor:
    """Per-shard (local lanes,) vectors as one (lanes,) vector; a shard
    that did not step (None) gets zeros, which the lane body masks out."""
    fill = next(r for r in rs if r is not None)
    rs = [torch.zeros_like(fill) if r is None else r for r in rs]
    return rs[0] if len(rs) == 1 else torch.cat(rs)


class _TorchSlots:
    """The lane slots of a ``"torch"`` loop: plain (lanes, m, n) stacks,
    swept by the shift algebra lane by lane."""

    def __init__(self, loop, lanes, a0, envs, device):
        self.loop = loop
        self.frames = torch.zeros((lanes, *a0.shape), dtype=a0.dtype,
                                  device=device)
        self.env_frames = tuple(
            torch.zeros((lanes, *e.shape), dtype=e.dtype, device=device)
            for e in envs)

    def pointers(self) -> tuple:
        return (self.frames.data_ptr(),)

    def step(self, env_frames):
        return self.loop._lane_step_torch(env_frames)

    def domains(self, frames):
        return frames

    def write_first(self, frames, env_frames, count, a0s, envs):
        frames[:count] = a0s
        for ef, e in zip(env_frames, envs):
            ef[:count] = e

    def write_slot(self, frames, env_frames, idx, a0, envs):
        frames[idx] = a0
        for ef, e in zip(env_frames, envs):
            ef[idx] = e

    def write_masked(self, frames, env_frames, take, interiors, env_sel):
        keep = take.reshape(-1, 1, 1)
        frames.copy_(torch.where(keep, interiors, frames))
        for ef, e in zip(env_frames, env_sel):
            ef.copy_(torch.where(keep, e, ef))


class _KernelSlots:
    """The lane slots of a kernel-backend loop: persistent halo frames
    of its :class:`~repro_torch.core.executor.StencilEngine`, which
    allocates them with its ping-pong pair and scratch and refills them in
    place."""

    def __init__(self, loop, lanes, a0, envs, device):
        self.eng = loop._engine()
        self.lspec = self.eng.lane_spec(lanes, *a0.shape)
        self.frames, self.env_frames = self.eng.alloc_lanes(
            self.lspec, a0.dtype, tuple(e.dtype for e in envs), device)

    def pointers(self) -> tuple:
        return self.eng.buffer_pointers()

    def step(self, env_frames):
        return lambda fr, live: self.eng.sweeps(fr, env_frames,
                                                self.lspec.frame, live)

    def domains(self, frames):
        return unframe(frames, self.lspec.frame)

    def write_first(self, frames, env_frames, count, a0s, envs):
        self.eng.refill_lanes(frames[:count],
                              tuple(ef[:count] for ef in env_frames), a0s,
                              envs, self.lspec)

    def write_slot(self, frames, env_frames, idx, a0, envs):
        self.eng.refill_slot(frames, env_frames, idx, a0, envs, self.lspec)

    def write_masked(self, frames, env_frames, take, interiors, env_sel):
        self.eng.refill_masked(frames, env_frames, take, interiors, env_sel,
                               self.lspec)


class _LaneShards:
    """The slots of a farm on single-device loops, over the lane shards of
    a mesh axis (one shard without a mesh): one ``_TorchSlots`` or
    ``_KernelSlots`` a shard, on its device, with ``lanes / shards`` slots.
    The carry is a list, one entry a shard; the per-lane vectors (reduce,
    count, flag, health) stay global on the lead device, so a step moves
    each shard's live flags to its device and its reduces back, and
    nothing else crosses between shards.  A shard whose loop is not
    stepping launches nothing."""

    def __init__(self, cls, loop, lanes, a0, envs, devices, lead):
        self.lead, self.devices = lead, devices
        self.local = lanes // len(devices)
        self.parts = [cls(loop, self.local, a0, envs, d) for d in devices]
        self.frames = [p.frames for p in self.parts]
        self.env_frames = [p.env_frames for p in self.parts]

    def _span(self, s: int) -> slice:
        return slice(s * self.local, (s + 1) * self.local)

    def pointers(self) -> tuple:
        return tuple(x for p in self.parts for x in p.pointers())

    def env_pointers(self) -> tuple:
        return tuple(e.data_ptr() for envs in self.env_frames for e in envs)

    def step(self, env_frames):
        steps = [p.step(e) for p, e in zip(self.parts, env_frames)]

        def step(frames, live, active):
            new, rs = list(frames), [None] * len(frames)
            for s, (st, dev) in enumerate(zip(steps, self.devices)):
                if active[s]:
                    with _on(dev):
                        new[s], r = st(frames[s], live[self._span(s)].to(dev))
                    rs[s] = r.to(self.lead)
            return new, _cat(rs)
        return step

    def capture(self, frames) -> list:
        """Every lane's domain, copied: one (local lanes, m, n) tensor a
        shard, on its device."""
        return [p.domains(fr).clone() for p, fr in zip(self.parts, frames)]

    def gather(self, frames) -> torch.Tensor:
        return _cat([x.to(self.lead) for x in self.capture(frames)])

    def lane(self, frames, idx: int) -> torch.Tensor:
        s, li = divmod(idx, self.local)
        return self.parts[s].domains(frames[s])[li].clone()

    def write_first(self, frames, env_frames, count, a0s, envs):
        for s, (p, dev) in enumerate(zip(self.parts, self.devices)):
            sl = self._span(s)
            c = max(0, min(count, sl.stop) - sl.start)
            if c:
                p.write_first(frames[s], env_frames[s], c,
                              a0s[sl][:c].to(dev),
                              tuple(e[sl][:c].to(dev) for e in envs))

    def write_slot(self, frames, env_frames, idx, a0, envs):
        s, li = divmod(idx, self.local)
        dev = self.devices[s]
        self.parts[s].write_slot(frames[s], env_frames[s], li, a0.to(dev),
                                 tuple(e.to(dev) for e in envs))

    def write_masked(self, frames, env_frames, take, pos, rings):
        for s, (p, dev) in enumerate(zip(self.parts, self.devices)):
            ring, ring_envs = rings[_dev_key(dev)]
            at = pos[self._span(s)].to(dev)
            p.write_masked(frames[s], env_frames[s],
                           take[self._span(s)].to(dev), ring[at],
                           tuple(re_[at] for re_ in ring_envs))


class _ComposedSlots:
    """The slots of the composed lanes × spatial farm (a ``"cuda-sharded"``
    loop over a mesh): one :class:`~repro_torch.core.executor.
    ShardedStencilEngine` a lane shard, on that shard's slice of the
    partition (:func:`~repro_torch.sharding.slice_partition`), holding a
    lane stack of its block of every local lane on each spatial shard.
    ``prep`` ran on the whole item on the lead device; a write scatters the
    item's blocks to the owner lane shard's spatial shards and re-asserts
    that lane's ghosts through the exchange.  A step is one launch a
    spatial shard over its lane stack, the lane-batched exchange and the
    per-lane fold, for every lane shard."""

    def __init__(self, loop, lanes, lane_axis, a0, envs, lead, nshards):
        from .executor import ShardedStencilEngine

        self.lead = lead
        self.local = lanes // nshards
        self.parts = [slice_partition(loop.partition, lane_axis, d)
                      for d in range(nshards)]
        self.engines = [ShardedStencilEngine(
            f=loop.f, part=part, k=loop.k, boundary=loop.boundary,
            combine=loop.combine, identity=loop.identity, delta=loop.delta,
            measure=loop.measure, block=loop.block or DEFAULT_BLOCK,
            unroll=loop.unroll) for part in self.parts]
        lm, ln = local_extents(*a0.shape, loop.partition)
        self.sspec = self.engines[0].lane_sspec(lm, ln)
        self.frames, self.env_frames = [], []
        for eng in self.engines:
            fr, ef = eng.alloc_lanes(self.sspec, self.local, a0.dtype,
                                     tuple(e.dtype for e in envs))
            self.frames.append(fr)
            self.env_frames.append(ef)

    def pointers(self) -> tuple:
        return tuple(x for eng in self.engines
                     for x in eng.buffer_pointers())

    def env_pointers(self) -> tuple:
        return tuple(e.data_ptr() for group in self.env_frames
                     for envs in group for e in envs)

    def step(self, env_frames):
        def step(frames, live, active):
            new, rs = list(frames), [None] * len(frames)
            for d, eng in enumerate(self.engines):
                if active[d]:
                    sl = slice(d * self.local, (d + 1) * self.local)
                    new[d], r = eng.sweeps(frames[d], env_frames[d],
                                           self.sspec, live[sl])
                    rs[d] = r.to(self.lead)
            return new, _cat(rs)
        return step

    def _blocks(self, d, x, batch):
        return scatter_grid(x, self.parts[d], batch=batch)

    def gather(self, frames) -> torch.Tensor:
        return _cat([
            gather_grid(eng.unframe(frames[d], self.sspec), self.parts[d],
                        device=self.lead, batch=1)
            for d, eng in enumerate(self.engines)])

    def lane(self, frames, idx: int) -> torch.Tensor:
        d, li = divmod(idx, self.local)
        sp = self.sspec.local
        p = sp.pad
        return gather_grid([fr[li, p:p + sp.m, p:p + sp.n]
                            for fr in frames[d]], self.parts[d],
                           device=self.lead)

    def write_first(self, frames, env_frames, count, a0s, envs):
        for d, eng in enumerate(self.engines):
            lo = d * self.local
            c = max(0, min(count, lo + self.local) - lo)
            if c:
                eng.refill_lanes(
                    [fr[:c] for fr in frames[d]],
                    [tuple(e[:c] for e in ef) for ef in env_frames[d]],
                    self._blocks(d, a0s[lo:lo + c], 1),
                    [self._blocks(d, e[lo:lo + c], 1) for e in envs],
                    self.sspec)

    def write_slot(self, frames, env_frames, idx, a0, envs):
        for d, eng in enumerate(self.engines):
            owns, li = local_slot(idx, self.local, d)
            if owns:
                eng.refill_slot(frames[d], env_frames[d], li,
                                self._blocks(d, a0, 0),
                                [self._blocks(d, e, 0) for e in envs],
                                self.sspec)


@dataclasses.dataclass
class StreamResult:
    """One continuous-mode emission: the item's stream position plus the
    fields of :class:`~repro_torch.core.pattern.LoopResult` (CPU
    tensors).  Continuous farms emit in COMPLETION order, so the index
    carries the ofarm identity.

    ``status`` is the failure-semantics verdict (:func:`item_status`, plus
    ``"rejected"`` for items that failed the admission-time finite check
    and ``"failed"`` for results a raising sink degraded); ``attempts``
    counts slot occupations (> 1: retried on a fresh slot after a non-ok
    finish); ``error`` carries the host-side exception text of a degraded
    result."""
    index: int
    a: Any
    reduced: Any
    iters: Any
    status: str = "ok"
    attempts: int = 1
    error: Optional[str] = None


@dataclasses.dataclass
class FarmEngine:
    """Lane-resident streaming farm: persistent-frame lane slots refilled
    in place, on one device (twin of :class:`repro.core.streaming.
    FarmEngine`, single-device deployment).

    ``loop`` is the per-item worker (a :class:`~repro_torch.core.pattern.
    LoopOfStencilReduce`); ``lanes`` is the number of device-resident
    slots, allocated once, from the first item's shapes.

    * **Round mode** (:meth:`run`, :meth:`round`): up to L items are
      written into the slots, the farm runs as one done-masked loop to
      each lane's own trip count, and the (m, n) results are sliced out.
      A round ends when its slowest lane does; the fast lanes' idle sweeps
      are counted in ``stats["wasted_lane_steps"]``.
    * **Continuous mode** (``run(..., continuous=True)``): the loop runs
      in segments that return as soon as a lane finishes (at most
      ``segment`` body steps); only the finished slots are refilled, and
      the same carry resumes.  Results are emitted as
      :class:`StreamResult` in completion order.  ``chained=True`` (the
      default) stages items ahead of need in a device ring of depth
      ``stage_depth or max(2*lanes, 2)`` and seats finished slots from it
      inside the segment's dispatch, draining segment t after segment t+1
      is dispatched, with one packed int32 metadata read per drained
      segment; ``chained=False`` is the classic dispatch → read →
      per-slot refill loop.  On a fault-free stream both are bit-identical.

    ``prep`` maps a stream item (its leaves on the device) to ``(a0,
    env_tuple)`` — the farm's per-item read stage, e.g. the §4.3 AMF
    detection feeding restoration.  It runs once per item (the reference
    vmaps it in round mode).  Stream items may be TUPLES ``(a,
    *env_items)``; the default prep splits them.  Every leaf is guarded
    against mid-stream shape/dtype drift.  Items arrive as numpy arrays or
    CPU tensors; the finite check runs on the host before the upload.

    Failure semantics: ``max_attempts`` slot occupations per item (a
    non-ok item is retried into a fresh slot), ``slot_patience``
    consecutive non-ok occupants retire a slot (never the last one),
    ``check_finite`` rejects NaN/Inf items at admission, and
    ``dead_letter`` lists every non-ok emission.  Recovery: see
    :meth:`run_continuous`.

    ``device`` defaults to the CUDA card and must be the loop's device:
    the per-lane vectors, ``prep`` and the fold live there (the lead).

    Deployments (the reference's three):

    * ``mesh=None`` — one device.
    * ``mesh=`` (a :class:`repro_torch.sharding.Mesh`) with a
      single-device backend (``"torch"``, ``"cuda"``, ``"cuda-multistep"``)
      — the slots spread over ``mesh[lane_axis]``: each lane shard owns
      lanes/P slots on its device and runs its own loop (its own trip
      count in round mode, its own early-exit segment in continuous mode);
      nothing crosses the lane axis.  The chained path's staging ring has
      one copy on each lane shard's device.
    * a ``"cuda-sharded"`` loop — the composed lanes × spatial farm: lanes
      over ``lane_axis``, each lane's frame split over the partition's
      axes of the same ``mesh``.  Every lane shard runs to the slowest lane
      anywhere (round mode) or exactly ``segment`` done-masked steps a
      segment (continuous mode, always the classic loop), as in the
      reference.  ``prep`` runs on the whole item before the split.
    """

    loop: Any                          # LoopOfStencilReduce worker
    lanes: int = 4
    prep: Optional[Callable] = None    # item -> (a0, env tuple), on device
    mesh: Any = None                   # lanes over a device mesh
    lane_axis: str = "data"            # the mesh axis the lanes lie over
    segment: int = 16                  # continuous mode: max body steps
                                       # between dispatcher check-ins
    max_attempts: int = 1              # slot occupations per item
    slot_patience: int = 3             # consecutive non-ok finishes on
                                       # one slot before it is retired
    check_finite: bool = True          # admission-time NaN/Inf guard
    chained: bool = True               # continuous mode: staging ring +
                                       # device-side seating (False: the
                                       # classic per-slot refill loop)
    stage_depth: Optional[int] = None  # staging-ring depth K (chained
                                       # mode); None = max(2*lanes, 2)
    device: Any = None

    def __post_init__(self):
        loop = self.loop
        if self.mesh is not None:
            if self.lane_axis not in self.mesh.axis_names:
                raise ValueError(
                    f"lane_axis {self.lane_axis!r} not in mesh axes "
                    f"{self.mesh.axis_names}")
            if self.lanes % self.mesh.shape[self.lane_axis]:
                raise ValueError(
                    f"lanes={self.lanes} must divide evenly over mesh "
                    f"axis {self.lane_axis!r} "
                    f"(size {self.mesh.shape[self.lane_axis]})")
            for dev in self.mesh.devices.flat:
                # a kernel backend on a mesh that holds a CPU device
                # raises here rather than run the plain versions there
                resolve_backend(loop.backend, dev)
        if loop.backend == "cuda-sharded":
            if self.mesh is None:
                raise ValueError(
                    "backend='cuda-sharded' lanes need mesh= (carrying the "
                    "lane axis AND the partition's spatial axes)")
            for name in loop.partition.axis_names:
                if name == self.lane_axis:
                    raise ValueError(
                        f"partition axis {name!r} collides with "
                        f"lane_axis; use distinct mesh axes for lanes "
                        "and the spatial decomposition")
                if name not in self.mesh.axis_names:
                    raise ValueError(
                        f"partition axis {name!r} missing from mesh "
                        f"axes {self.mesh.axis_names}")
        if loop.state_init is not None:
            raise ValueError("FarmEngine does not support the -s variant "
                             "(per-lane loop states are ambiguous)")
        if loop.mode != "taps" and loop.backend != "torch":
            raise ValueError("FarmEngine needs mode='taps' on the kernel "
                             f"backends; got mode={loop.mode!r}")
        if self.lanes < 1:
            raise ValueError(f"lanes must be >= 1; got {self.lanes}")
        if self.segment < 1:
            raise ValueError(f"segment must be >= 1; got {self.segment}")
        if self.max_attempts < 1:
            raise ValueError(
                f"max_attempts must be >= 1; got {self.max_attempts}")
        if self.slot_patience < 1:
            raise ValueError(
                f"slot_patience must be >= 1; got {self.slot_patience}")
        if self.stage_depth is not None and self.stage_depth < 1:
            raise ValueError(
                f"stage_depth must be >= 1; got {self.stage_depth}")
        self.device = resolve_device(self.device)
        if _dev_key(self.device) != _dev_key(loop.device):
            raise ValueError(
                f"the loop runs on {loop.device}, the engine on "
                f"{self.device}; pass the loop's device")
        self.dead_letter: list = []     # non-ok emissions (retries
                                        # exhausted, rejected, failed)
        self._prep1 = self.prep or _default_prep
        self._bound = False
        self._mode = None               # "round" | "continuous" once used
        self._composed = loop.backend == "cuda-sharded"
        self._nshards = (1 if self.mesh is None
                         else self.mesh.shape[self.lane_axis])
        self._frames = None
        self._env_frames = ()
        self._rings = {}                # device -> (ring, ring env
                                        # leaves), chained mode
        self._cont_carry = None
        self.bound_pointers = {}        # buffer_pointers() at allocation
        self._waste_buf: list = []      # (iters, hw, count) of rounds,
                                        # folded into the stats lazily
        self.stats = {"items": 0, "rounds": 0, "h2d_bytes": 0,
                      "d2h_bytes": 0, "segments": 0, "refills": 0,
                      "lane_steps": 0, "wasted_lane_steps": 0,
                      "quarantined_lane_steps": 0, "retries": 0,
                      "rejected": 0, "quarantined_slots": 0,
                      "sink_errors": 0, "snapshots": 0,
                      "replayed_items": 0, "recovered_occupants": 0,
                      "recovery_seconds": 0.0, "host_reads": 0,
                      **obs.stats_keys(FARM_SPANS, device=FARM_DEVICE_SPANS,
                                       other="farm.other")}
        self._resume_state = None       # staged by restore()
        self._rt_capture = None         # live snapshot closure, set by
                                        # run_continuous for snapshot()

    @property
    def _chain(self) -> bool:
        """Continuous mode takes the chained path: ``chained``, except on
        the composed farm, which always runs the classic loop (its
        fixed-step segments have no early exit to chain past), as in the
        reference."""
        return self.chained and not self._composed

    # -- geometry (the first item binds the shapes) ----------------------
    def _bind(self, item):
        """Allocate the slots from the first item's prepped shapes — the
        only allocation of frames and env slots in the engine's life.
        (``prep`` runs once here on the probe item.)"""
        L, dev = self.lanes, self.device
        item = _as_item(item)
        self._item_avals = tuple((tuple(leaf.shape), leaf.dtype)
                                 for leaf in _item_leaves(item))
        a0, envs = self._prep(self._upload(item))
        if a0.ndim != 2:
            raise ValueError(f"stream items must be 2-D grids; prep "
                             f"produced {tuple(a0.shape)}")
        m, n = a0.shape
        # continuous mode folds the segment length into unroll="auto"
        self._loop = self.loop._resolve_unroll(
            (m, n),
            segment=self.segment if self._mode == "continuous" else None)
        loop = self._loop
        self._prep_avals = ((tuple(a0.shape), a0.dtype),
                            tuple((tuple(e.shape), e.dtype) for e in envs))
        if self._composed:
            check_even((m, n), loop.partition)
            self._slots = _ComposedSlots(loop, L, self.lane_axis, a0, envs,
                                         dev, self._nshards)
        else:
            devices = ([dev] if self.mesh is None
                       else axis_devices(self.mesh, self.lane_axis))
            self._slots = _LaneShards(
                _TorchSlots if loop.backend == "torch" else _KernelSlots,
                loop, L, a0, envs, devices, dev)
        self._frames = self._slots.frames
        self._env_frames = self._slots.env_frames
        self._bound = True
        self.bound_pointers = self.buffer_pointers()

    def buffer_pointers(self) -> dict:
        """``data_ptr()`` of every device buffer the stream lives in: the
        frame pair, the env slots and the staging ring.  Equal to
        ``bound_pointers`` at the end of a stream on the kernel backends:
        nothing was re-allocated."""
        return {"frames": self._slots.pointers(),
                "env": self._slots.env_pointers(),
                "ring": tuple(x.data_ptr() for ring, envs in
                              self._rings.values() for x in (ring, *envs))}

    def _upload(self, item):
        """A stream item's leaves on the engine's device."""
        with obs.span("farm.upload", device=self.device):
            return to_device(item, self.device)

    def _prep(self, item):
        """``prep`` on one item (its leaves on the device)."""
        with obs.span("farm.prep", device=self.device):
            return self._prep1(item)

    def _prep_items(self, items: list):
        """``prep`` on each item (leaves already on the device), stacked:
        ``(a0s, env stacks)``."""
        preps = [self._prep(it) for it in items]
        return (torch.stack([p[0] for p in preps]),
                tuple(torch.stack([p[1][j] for p in preps])
                      for j in range(len(preps[0][1]))))

    # -- one round: refill slots, run the farm, slice results ------------
    def _round_impl(self, frames, env_frames, items: list, count: int):
        """The round: prep, in-place refill of the first ``count`` slots
        (the others are masked done and never swept), ONE done-masked lane
        loop, the (m, n) results sliced out.  Returns ``(outs, reduced,
        iters, health)`` for every lane, on the device."""
        slots = self._slots
        a0s, envs = self._prep_items(items)
        done0 = torch.arange(self.lanes, device=self.device) >= count
        slots.write_first(frames, env_frames, count, a0s, envs)
        res = self._loop._drive_lanes(
            frames, step=slots.step(env_frames), finalize=slots.gather,
            done0=done0, cond_fold=self._lane_cond_fold(),
            shards=self._nshards)
        return res.a, res.reduced, res.iters, res.health

    def _lane_cond_fold(self):
        """The composed farm's barrier: every lane shard steps while any
        lane anywhere is live (the reference folds its any-live predicate
        over the lane axis, so the spatial exchanges of the shards stay in
        step).  Lane farms on single-device loops keep their per-shard trip
        counts (None)."""
        if not self._composed:
            return None
        return lambda run: run.any().expand_as(run)

    @obs.collected("farm.other")
    def round(self, items, count: Optional[int] = None):
        """Push one stacked (≤ lanes, ...) batch through the slots.

        ``items`` is a stacked array or tensor, a LIST of stream items, or
        — for tuple stream items ``(a, *env)`` — a TUPLE of per-leaf
        stacks.  Returns per-item ``(a, reduced, iters, health)`` stacks of
        length ``count`` on the device (decode ``health`` with
        :func:`repro_torch.core.reduce.health_status`).
        """
        if isinstance(items, list):
            items = _stack_items(items)
        elif isinstance(items, tuple):
            items = tuple(_leaf(leaf) for leaf in items)
        else:
            items = _leaf(items)
        leaves = _item_leaves(items)
        B = leaves[0].shape[0]
        if any(leaf.shape[0] != B for leaf in leaves):
            raise ValueError(
                f"per-leaf stacks of a tuple batch must share the "
                f"leading batch dim; got "
                f"{tuple(leaf.shape[0] for leaf in leaves)} (a tuple "
                "argument is read as (main, *env) per-leaf stacks — "
                "pass a list of items to stack leaf-wise)")
        count = B if count is None else count
        if count > self.lanes:
            raise ValueError(f"batch of {count} items exceeds "
                             f"lanes={self.lanes}")
        if self._mode == "continuous":
            raise ValueError("engine already streamed in continuous mode;"
                             " build a fresh FarmEngine for rounds")
        self._mode = "round"
        rep = _item_at(items, 0)
        if not self._bound:
            self._bind(rep)
        else:
            self._check_item(rep)
        if self.check_finite:
            # the whole stack: round mode has no per-slot quarantine to
            # catch a poisoned lane later
            for i, leaf in enumerate(leaves):
                if _nonfinite(leaf[:count]):
                    which = ("stream batch" if i == 0
                             else f"env stream batch (leaf {i - 1})")
                    raise NonFiniteItemError(
                        f"{which} carries NaN/Inf input values — "
                        "rejected at the prep boundary before any lane "
                        "is dirtied (pass check_finite=False to admit "
                        "it anyway under sentinel quarantine)")
        self.stats["h2d_bytes"] += \
            sum(_nbytes(leaf) // B for leaf in leaves) * count
        self.stats["rounds"] += 1
        self.stats["items"] += count
        dev_items = [self._upload(_item_at(items, i)) for i in range(count)]
        outs, red, iters, hw = self._round_impl(
            self._frames, self._env_frames, dev_items, count)
        self._waste_buf.append((iters, hw, count))
        return outs[:count], red[:count], iters[:count], hw[:count]

    # -- lane-step/waste accounting of round mode ------------------------
    def _flush_waste(self):
        """Fold the buffered rounds' (iters, health) into the stats: the
        barrier runs every lane to the round's slowest trip count, so a
        lane that finished at ``it_i`` idled ``max(it) - it_i`` sweeps
        (padding lanes idle the whole round).  A non-ok lane's sweeps are
        also booked as ``quarantined_lane_steps``."""
        # the barrier is each lane shard's own, or mesh-wide when composed
        groups = 1 if self._composed else self._nshards
        while self._waste_buf:
            iters, hw, count = self._waste_buf.pop(0)
            it_h = iters.cpu().numpy().astype(np.int64)
            hw_h = hw.cpu().numpy()
            for it_g in it_h.reshape(groups, -1):
                busy = int(it_g.max()) * len(it_g)
                self.stats["wasted_lane_steps"] += busy - int(it_g.sum())
                self.stats["lane_steps"] += busy
            top = int(it_h.max())
            # _drive_lanes read its flag once a check, and once more
            self.stats["host_reads"] += top // self._loop.unroll + 1
            for i in range(count):
                if item_status(hw_h[i], it_h[i],
                               self._loop.max_iters) != "ok":
                    self.stats["quarantined_lane_steps"] += int(it_h[i])

    @property
    def wasted_lane_steps(self) -> int:
        """Total done-masked / idle-slot lane sweeps executed so far —
        the straggler-barrier metric continuous mode exists to shrink."""
        self._flush_waste()
        return self.stats["wasted_lane_steps"]

    @property
    def lane_steps(self) -> int:
        """Total lane sweeps executed (useful + wasted)."""
        self._flush_waste()
        return self.stats["lane_steps"]

    @property
    def quarantined_lane_steps(self) -> int:
        """Lane sweeps burned on occupants that finished non-ok."""
        self._flush_waste()
        return self.stats["quarantined_lane_steps"]

    # -- continuous mode: segmented loop + per-slot refill ---------------
    def _segment_body(self, frames, env_frames, r, it, done, hw):
        """One bounded slice of the resident lane loop: early exit a lane
        shard, or, composed, exactly ``segment`` done-masked steps (the
        reference's uniform schedule: its spatial exchanges must stay in
        step).  Returns the resumed carry plus the body-step counts, one a
        lane shard."""
        early = not self._composed
        (a, r, it, done, hw), steps = self._loop.lane_segment(
            (frames, r, it, done, hw), step=self._slots.step(env_frames),
            segment=self.segment, early_exit=early, shards=self._nshards)
        if early:
            self.stats["host_reads"] += segment_reads(max(steps),
                                                      self.segment)
        return a, env_frames, r, it, done, hw, steps

    def _refill_impl(self, frames, env_frames, r, it, done, hw, idx,
                     item):
        """Hand ONE finished slot to the next stream item (its leaves on
        the device) and re-arm its carry: ``prep``, then O(interior)
        writes in place.  The health word re-arms to 0: a slot's faults do
        not follow it onto the next occupant."""
        with obs.span("farm.prep", device=self.device):
            a0, envs = self._prep1(item)
            return self._slot_write(frames, env_frames, r, it, done, hw, idx,
                                    a0, envs, self._loop._id, 0, 0)

    def _restore_impl(self, frames, env_frames, r, it, done, hw, idx,
                      item, a_mid, rv, iv, hv):
        """Re-seat a snapshotted in-flight occupant into a (possibly
        different) slot: its saved mid-flight interior ``a_mid`` takes the
        place of a fresh item's ``a0`` and the carry re-arms with the saved
        ``(reduce, iter, health)`` — the loop continues from iteration
        ``iv``.  Ghost cells are re-derived from the interior, which is
        what makes snapshots topology-free; ``prep`` re-derives the env
        fields from the raw item (prep must be deterministic)."""
        with obs.span("farm.prep", device=self.device):
            _, envs = self._prep1(item)
            return self._slot_write(frames, env_frames, r, it, done, hw, idx,
                                    a_mid, envs, rv, iv, hv)

    def _slot_write(self, frames, env_frames, r, it, done, hw, idx,
                    a0, envs, rv, iv, hv):
        self._slots.write_slot(frames, env_frames, idx, a0, envs)
        return (frames, env_frames, _put(r, idx, rv), _put(it, idx, iv),
                _put(done, idx, False), _put(hw, idx, hv))

    def _extract_impl(self, frames, idx: int) -> torch.Tensor:
        """ONE lane's (m, n) domain, as a device tensor of its own (on the
        lead device when its frame is split)."""
        return self._slots.lane(frames, idx)

    # -- chained dispatch: segment + ring refill + capture ---------------
    def _unframe_all(self, frames) -> list:
        """Every lane's (m, n) domain, copied — the chained path's emission
        payload, taken before the refill: one (local lanes, m, n) tensor a
        lane shard."""
        return self._slots.capture(frames)

    def _chain_refill(self, frames, env_frames, take, pos):
        """Masked batch refill of every taken slot at once from ring
        positions ``pos``, each lane shard from its device's ring copy (the
        gathers carry junk rows where ``~take``, masked out by the
        select)."""
        self._slots.write_masked(frames, env_frames, take, pos, self._rings)
        return frames, env_frames

    def _chain_entry(self, frames, env_frames, r, it, done, hw, rd, wr,
                     live):
        """ONE dispatch of the chained path: run a segment, capture the
        finished lanes' payloads (domains, reduce/iter/health — all
        pre-refill), then seat every finished live slot's next occupant
        from the staging ring by the device-side cursor ``rd`` — a masked
        batch refill, no per-slot step on the host.

        ``rd`` (a device int32) is threaded call to call; ``wr`` is the
        host's staged-count watermark.  ``live`` masks retired slots out of
        the seating — it lags one in-flight dispatch behind the host's
        quarantine decisions (as in the reference: a slot just retired may
        be seated once more).  Seating follows lane order over the finished
        live slots, the order the classic loop's ascending admission
        produces.  Returns the resumed carry plus ``(meta, r_pre, outs)``
        for the host's drain; ``meta`` is one packed int32 vector (fin | it
        | hw | take | steps), with one step count a lane shard.  Under a
        lane mesh the seating runs over the global lane order, as the
        reference's does over its sharded vectors."""
        with obs.span("farm.dispatch", device=self.device):
            loop = self._loop
            (frames, env_frames, r, it, done, hw,
             steps) = self._segment_body(frames, env_frames, r, it, done, hw)
            fin = done | (it >= loop.max_iters)
            outs = self._unframe_all(frames)
            r_pre, it_pre, hw_pre = r, it, hw
            elig = fin & live
            e32 = elig.to(torch.int32)
            rank = torch.cumsum(e32, 0) - e32
            take = elig & (rank < (wr - rd))
            K = self._ring_depth
            pos = torch.where(take, (rd + rank) % K, torch.zeros_like(rank))
            frames, env_frames = self._chain_refill(frames, env_frames, take,
                                                    pos)
            r = torch.where(take, torch.full_like(r, loop._id), r)
            it = torch.where(take, torch.zeros_like(it), it)
            done = done & ~take
            hw = torch.where(take, torch.zeros_like(hw), hw)
            rd = rd + take.sum(dtype=torch.int32)
            meta = torch.cat([
                fin.to(torch.int32), it_pre.to(torch.int32),
                hw_pre.to(torch.int32), take.to(torch.int32),
                *(torch.full((1,), n, dtype=torch.int32, device=self.device)
                  for n in steps)])
            return (frames, env_frames, r, it, done, hw, rd, meta, r_pre, outs)

    def _stage_impl(self, pos: int, item):
        """Write one stream item's PREPPED interior/env fields (``prep``
        runs once, on the lead device) into every ring copy at ``pos`` —
        the read stage running ahead of need."""
        with obs.span("farm.prep", device=self.device):
            a0, envs = self._prep1(item)
            for ring, ring_envs in self._rings.values():
                stage_ring_write(ring, a0.to(ring.device), pos)
                for re_, e in zip(ring_envs, envs):
                    stage_ring_write(re_, e.to(re_.device), pos)

    def _meta_read(self, *arrs):
        """The metadata read of one chained-segment drain: every read of
        a drained segment's packed metadata funnels through here (the
        emitted payloads and the segment's reduce vector are pulled apart,
        on first need)."""
        with obs.span("farm.drain"):
            return tuple(a.cpu().numpy() for a in arrs)

    def _check_item(self, item):
        """Guard EVERY leaf of a stream item — the main array AND any env
        leaves — against mid-stream shape/dtype drift, then (with
        ``check_finite``) against NaN/Inf values, on the host."""
        leaves = _item_leaves(item)
        if len(leaves) != len(self._item_avals):
            raise ValueError(
                f"stream item arity changed mid-stream: slots are bound "
                f"to {len(self._item_avals)} leaves (main + env), got "
                f"{len(leaves)} (build a fresh FarmEngine per item "
                "geometry)")
        for i, (leaf, (shape, dtype)) in enumerate(
                zip(leaves, self._item_avals)):
            if tuple(leaf.shape) != shape or leaf.dtype != dtype:
                which = ("stream item" if i == 0
                         else f"env stream item {i - 1}")
                raise ValueError(
                    f"{which} shape changed mid-stream: slots are bound "
                    f"to {shape}/{dtype}, got {tuple(leaf.shape)}/"
                    f"{leaf.dtype} (build a fresh FarmEngine per item "
                    "geometry)")
        if self.check_finite:
            for i, leaf in enumerate(leaves):
                if _nonfinite(leaf):
                    which = ("stream item" if i == 0
                             else f"env stream item {i - 1}")
                    raise NonFiniteItemError(
                        f"{which} carries NaN/Inf input values — "
                        "rejected at the prep boundary (a non-finite "
                        "item poisons its lane; pass check_finite=False "
                        "to admit it anyway under sentinel quarantine)")

    def _bind_continuous(self):
        """Allocate the continuous carry around the bound slots: the
        staging ring (chained mode; one copy on each lane shard's device)
        and the per-lane (r, it, done, hw) vectors — all slots start
        retired (done, unoccupied)."""
        loop, L, dev = self._loop, self.lanes, self.device
        if self._chain and not self._rings:
            (a_shape, a_dtype), env_avals = self._prep_avals
            K = self._ring_depth = self.stage_depth or max(2 * L, 2)
            for d in self._slots.devices:
                if _dev_key(d) not in self._rings:
                    self._rings[_dev_key(d)] = (
                        alloc_stage_ring(K, a_shape, a_dtype, d),
                        tuple(alloc_stage_ring(K, s, t, d)
                              for s, t in env_avals))
            self.bound_pointers = self.buffer_pointers()
        if self._cont_carry is not None:
            return          # slots + carry persist across streams: the
                            # end state (all lanes retired) is a valid
                            # start state for the next stream
        self._cont_carry = (
            torch.full((L,), loop._id, device=dev),
            torch.zeros((L,), dtype=torch.int32, device=dev),
            torch.ones((L,), dtype=torch.bool, device=dev),
            torch.zeros((L,), dtype=torch.int32, device=dev))

    # -- snapshot / restore (preemption recovery) ------------------------
    def snapshot(self) -> dict:
        """The in-flight continuous-stream state as ONE logical tree:
        every occupied slot's mid-flight interior, its ``(reduce, iter,
        health)`` carry and raw item, the retry queue (ring-staged entries
        included), and the source cursor (``next_index``).  Topology-free:
        it restores onto any lane count.  Slot quarantine is not captured
        (it describes the old process's slots, not the stream).  Only
        meaningful at a segment boundary — call it from ``on_segment`` or
        pass ``recovery=`` to :meth:`run_continuous`."""
        if self._rt_capture is None:
            raise ValueError(
                "snapshot() captures continuous-stream state; nothing "
                "has streamed yet — run run_continuous (pass recovery= "
                "to persist snapshots automatically)")
        return self._rt_capture()

    def restore(self, state: dict) -> "FarmEngine":
        """Stage a :meth:`snapshot` tree (this package's or the
        reference's); the next :meth:`run_continuous` resumes from it.
        The engine's lane count may differ from the snapshotting engine's
        (elastic resume); the item geometry may not."""
        if self._mode == "round":
            raise ValueError("engine already streamed in round mode; "
                             "build a fresh FarmEngine to restore into")
        if not isinstance(state, dict) or state.get("kind") != "farm":
            raise ValueError("not a FarmEngine snapshot tree")
        if int(state.get("version", -1)) != 1:
            raise ValueError("unsupported FarmEngine snapshot version "
                             f"{state.get('version')!r}")
        self._resume_state = state
        return self

    @obs.collected("farm.other")
    def run_continuous(self, source, sink, *, recovery=None,
                       resume: bool = False,
                       on_segment: Optional[Callable] = None) -> int:
        """Drive a whole stream with continuous per-lane refill.

        ``sink`` receives one :class:`StreamResult` per stream item —
        EXACTLY once each, in COMPLETION order (``.index`` is the stream
        position).  The farm advances in bounded segments; the moment a
        lane's loop finishes, its (m, n) result is extracted, the next
        item takes over the slot in place, and the same carry resumes.

        Failure semantics: a lane the sentinel quarantined (poisoned /
        diverged) or that exhausted its iteration budget finishes with a
        non-ok ``status``.  With ``max_attempts > 1`` such an item is
        re-admitted into a FRESH slot; once its attempts are exhausted it
        is emitted with its final status and recorded on ``dead_letter``.
        A slot that fails ``slot_patience`` consecutive occupants is
        retired (``stats["quarantined_slots"]``) unless it is the last
        slot.  Items failing the admission-time finite check emit
        ``status="rejected"`` without touching a slot.  A raising sink
        degrades the result to ``dead_letter`` (``status="failed"``)
        instead of killing the stream.

        Preemption recovery: with ``recovery=`` (a :class:`repro_torch.
        resilience.recovery.RecoveryConfig`) every result is journaled
        (fsync'd, CRC-framed) BEFORE it reaches the sink, and the
        in-flight state (:meth:`snapshot`) is published atomically every
        ``snapshot_every`` segments.  ``resume=True`` restarts a killed
        run: the journal replays pre-crash results to the sink (each
        index then suppressed), the source is fast-forwarded past the
        snapshot's cursor (it must re-yield the same items from position
        0), and occupants continue mid-iteration, on any lane count.
        ``on_segment`` is called with the cumulative segment count at
        every segment boundary — the seam ``FaultPlan.preempt_hook``
        kills through.
        """
        if self._mode == "round":
            raise ValueError("engine already streamed in round mode; "
                             "build a fresh FarmEngine for continuous")
        self._mode = "continuous"
        dev = self.device

        t_resume0 = time.perf_counter()
        state = None
        if self._resume_state is not None:
            state, self._resume_state = self._resume_state, None
        elif recovery is not None and resume:
            from ..resilience.recovery import load_snapshot
            state = load_snapshot(recovery.snap_dir)

        journal = None
        emitted_pre: set = set()
        n_out = 0

        def deliver(res, journal_rec=True):
            """WAL-ordered emission: journal (fsync'd) FIRST, then the
            sink.  A raising sink degrades the result to ``dead_letter``
            with its error attached; the journal already holds the
            payload, so a resumed run re-delivers it."""
            nonlocal n_out
            if journal is not None and journal_rec:
                journal.append({
                    "index": int(res.index), "status": res.status,
                    "attempts": int(res.attempts),
                    "iters": int(res.iters), "reduced": res.reduced,
                    "a": res.a, "error": res.error})
            try:
                with obs.span("farm.sink"):
                    sink(res)
            except Exception as e:
                self.stats["sink_errors"] += 1
                res = dataclasses.replace(
                    res,
                    status="failed" if res.status == "ok" else res.status,
                    error=f"sink raised: {type(e).__name__}: {e}")
            if res.status != "ok":
                self.dead_letter.append(res)
            n_out += 1

        if recovery is not None and resume:
            from ..resilience.recovery import Journal
            for rec in Journal.replay(recovery.journal_path):
                ridx = int(rec["index"])
                if ridx in emitted_pre:
                    continue
                emitted_pre.add(ridx)
                deliver(StreamResult(
                    index=ridx, a=rec.get("a"),
                    reduced=rec.get("reduced"),
                    iters=torch.tensor(int(rec.get("iters") or 0),
                                       dtype=torch.int32),
                    status=rec.get("status", "ok"),
                    attempts=int(rec.get("attempts") or 1),
                    error=rec.get("error")), journal_rec=False)
                self.stats["replayed_items"] += 1
        if recovery is not None:
            from ..resilience.recovery import Journal
            journal = Journal(recovery.journal_path, fsync=recovery.fsync)

        if state is not None and state.get("complete"):
            # the preempted run had drained its stream; the replay above
            # re-delivered every result
            self.stats["segments"] = int(state.get("segments", 0))
            if journal is not None:
                journal.close()
            self.stats["items"] += n_out
            self.stats["recovery_seconds"] += (
                time.perf_counter() - t_resume0)
            return n_out

        stream = iter(source() if callable(source) else source)
        pending = None
        saved_occ = list(state.get("occupants") or ()) if state else []
        saved_retry = list(state.get("retry") or ()) if state else []
        if state is not None:
            # fast-forward the source cursor: positions below next_index
            # were pulled pre-crash — each is in the snapshot or the
            # journal
            next_index = int(state["next_index"])
            stream = islice(stream, next_index, None)
            probe = None
            if saved_occ or saved_retry:
                probe = _as_item((saved_occ + saved_retry)[0]["item"])
            else:
                first = next(stream, None)
                if first is not None:
                    pending = probe = _as_item(first)
        else:
            next_index = 0
            probe = None
            first = next(stream, None)
            if first is not None:
                pending = probe = _as_item(first)
        if probe is None:      # nothing in flight AND stream drained
            if journal is not None:
                journal.close()
            self.stats["items"] += n_out
            return n_out
        if not self._bound:
            self._bind(probe)
        self._bind_continuous()
        loop = self._loop
        L, unroll = self.lanes, loop.unroll
        Ll = L // self._nshards           # slots a lane shard
        frames, env_frames = self._frames, self._env_frames
        r, itv, done, hw = self._cont_carry
        occupants: list = [None] * L      # slot -> in-flight entry
        slot_dead = [False] * L           # quarantined slots
        slot_fails = [0] * L              # consecutive non-ok finishes
        retry_q: list = []
        staged: deque = deque()           # entries resident in the ring
        pending_entries: deque = deque()  # pulled, unstaged entries
        prev_it = np.zeros((L,), np.int64)

        if state is not None:
            # restored occupants re-enter through the retry-first
            # admission path with their saved mid-flight state (a resumed
            # engine with FEWER lanes keeps the excess queued)
            self.stats["segments"] = int(state.get("segments", 0))
            for e in saved_occ:
                retry_q.append({
                    "index": int(e["index"]), "item": _as_item(e["item"]),
                    "attempts": int(e["attempts"]), "bad_slots": set(),
                    "carry": (e["a"], e["r"], int(e["it"]),
                              int(e["hw"]))})
            for e in saved_retry:
                retry_q.append({
                    "index": int(e["index"]), "item": _as_item(e["item"]),
                    "attempts": int(e["attempts"]), "bad_slots": set()})

        def pull_stream():
            """Next stream item as an in-flight entry (index assigned at
            pull time)."""
            nonlocal pending, next_index
            if pending is not None:
                x, pending = pending, None
            else:
                x = next(stream, None)
                x = None if x is None else _as_item(x)
            if x is None:
                return None
            entry = {"index": next_index, "item": x, "attempts": 0,
                     "bad_slots": set()}
            next_index += 1
            return entry

        def next_entry(slot):
            """Retry entries first (fresh slots only), then the stream.  A
            retry whose bad-slot set covers this slot re-enters it only as
            a last resort (stream drained, no other live slot)."""
            for i, e in enumerate(retry_q):
                if slot not in e["bad_slots"]:
                    return retry_q.pop(i)
            if pending_entries:     # unstaged ring entries precede the
                return pending_entries.popleft()   # stream cursor
            e = pull_stream()
            if e is not None:
                return e
            others_live = any(
                occupants[s] is not None and not slot_dead[s]
                for s in range(L) if s != slot)
            if retry_q and not others_live:
                return retry_q.pop(0)
            return None

        def emit(entry, status, a=None, reduced=None, iters=0):
            deliver(StreamResult(index=entry["index"], a=a,
                                 reduced=reduced,
                                 iters=torch.tensor(int(iters),
                                                    dtype=torch.int32),
                                 status=status,
                                 attempts=entry["attempts"]))

        def refill(slot, entry):
            nonlocal frames, env_frames, r, itv, done, hw
            carry = entry.pop("carry", None)
            item = self._upload(entry["item"])
            if carry is None:
                entry["attempts"] += 1
                frames, env_frames, r, itv, done, hw = self._refill_impl(
                    frames, env_frames, r, itv, done, hw, slot, item)
                prev_it[slot] = 0
            else:
                # a snapshotted occupant continues its SAME occupation
                # (attempts unchanged) from its saved iteration
                a_mid, rs, its, hws = carry
                frames, env_frames, r, itv, done, hw = self._restore_impl(
                    frames, env_frames, r, itv, done, hw, slot, item,
                    self._upload(_leaf(a_mid)), float(rs), its, hws)
                prev_it[slot] = int(its)
                self.stats["recovered_occupants"] += 1
            occupants[slot] = entry
            self.stats["h2d_bytes"] += _item_nbytes(entry["item"])
            self.stats["refills"] += 1

        def admit(slot):
            """Fill one free slot, skipping items the admission guard
            rejects (they emit + dead-letter without consuming the slot;
            drift errors still raise) and items whose result was
            journaled pre-crash."""
            with obs.span("farm.stage"):
                while True:
                    entry = next_entry(slot)
                    if entry is None:
                        return
                    if entry["index"] in emitted_pre:
                        continue
                    try:
                        with obs.span("farm.check"):
                            self._check_item(entry["item"])
                    except NonFiniteItemError:
                        self.stats["rejected"] += 1
                        emit(entry, "rejected")
                        continue
                    refill(slot, entry)
                    return

        def capture(complete=None):
            """Build the :meth:`snapshot` tree from the live run state
            (interiors copied out; the resident frames stay untouched)."""
            r_cur, it_cur, hw_cur = r.cpu(), itv.cpu(), hw.cpu()
            occ = []
            for s in range(L):
                e = occupants[s]
                if e is None:
                    continue
                occ.append({"index": int(e["index"]),
                            "attempts": int(e["attempts"]),
                            "item": e["item"],
                            "a": self._extract_impl(frames, s).cpu(),
                            "r": r_cur[s], "it": int(it_cur[s]),
                            "hw": int(hw_cur[s])})
            queued = list(retry_q) + list(staged) + list(pending_entries)
            if complete is None:
                complete = not occ and not queued
            return {"kind": "farm", "version": 1,
                    "segments": int(self.stats["segments"]),
                    "next_index": int(next_index), "n_out": int(n_out),
                    "occupants": occ,
                    # retries first, then ring-staged / unstaged entries in
                    # stream order — a staged-but-unseated item is queued
                    # work the resumed run must not lose
                    "retry": [{"index": int(e["index"]),
                               "attempts": int(e["attempts"]),
                               "item": e["item"]} for e in queued],
                    "complete": bool(complete)}

        self._rt_capture = capture

        def persist(complete=None):
            if recovery is None:
                return
            from ..resilience.recovery import save_snapshot
            save_snapshot(recovery.snap_dir, self.stats["segments"],
                          capture(complete), keep=recovery.keep)
            self.stats["snapshots"] += 1

        def account(steps, it_h):
            """Lane-step accounting of one segment: every body step of a
            lane shard advances (or idles) each of its lanes by ``unroll``
            sweeps; ``steps`` holds one count a lane shard."""
            for s, n in enumerate(steps):
                sl = slice(s * Ll, (s + 1) * Ll)
                total = int(n) * unroll * Ll
                self.stats["lane_steps"] += total
                self.stats["wasted_lane_steps"] += total - int(
                    (it_h[sl] - prev_it[sl]).sum())

        def finish(slot, entry, status, it_s, payload):
            """Book one finished occupant: retry it, or emit it (pulling
            its payload from the device), then retire its slot if it has
            failed ``slot_patience`` occupants in a row.  Returns True when
            the slot was retired just now."""
            if status != "ok":
                self.stats["quarantined_lane_steps"] += int(it_s)
                slot_fails[slot] += 1
            else:
                slot_fails[slot] = 0
            if status != "ok" and entry["attempts"] < self.max_attempts:
                entry["bad_slots"].add(slot)
                retry_q.append(entry)
                self.stats["retries"] += 1
            else:
                with obs.span("farm.emit"):
                    out, red = payload()
                    self.stats["d2h_bytes"] += \
                        _nbytes(out) + _nbytes(red) + 4
                    emit(entry, status, a=out, reduced=red, iters=it_s)
            if (not slot_dead[slot]
                    and slot_fails[slot] >= self.slot_patience
                    and L - sum(slot_dead) > 1):
                slot_dead[slot] = True
                self.stats["quarantined_slots"] += 1
                return True
            return False

        def run_chained():
            """The chained pipeline: stage(t+1) ∥ run(t) ∥ drain(t−1).
            Every steady-state segment boundary is ONE ``_chain_entry`` call
            — segment, payload capture and masked batch refill from the
            staging ring — and the host reads segment t's metadata only
            after segment t+1 is dispatched.  Retries drop to a
            synchronous repair phase (classic admission, ring rewound
            through ``pending_entries``), then the chain resumes."""
            nonlocal frames, env_frames, r, itv, done, hw, prev_it
            K = self._ring_depth
            rd = torch.zeros((), dtype=torch.int32, device=dev)
            wr_host = 0                      # staged-count watermark
            rd_host = 0                      # host mirror of rd (lags by
                                             # the in-flight takes)
            inflight: deque = deque()        # dispatched, undrained

            def stage_next():
                """Admission-checked staging of ONE entry into the ring
                (the chained twin of ``admit``)."""
                nonlocal wr_host
                while True:
                    if pending_entries:
                        entry = pending_entries.popleft()
                    else:
                        entry = pull_stream()
                    if entry is None:
                        return False
                    if entry["index"] in emitted_pre:
                        continue
                    try:
                        with obs.span("farm.check"):
                            self._check_item(entry["item"])
                    except NonFiniteItemError:
                        self.stats["rejected"] += 1
                        emit(entry, "rejected")
                        continue
                    break
                self._stage_impl(wr_host % K, self._upload(entry["item"]))
                staged.append(entry)
                wr_host += 1
                self.stats["h2d_bytes"] += _item_nbytes(entry["item"])
                return True

            def top_up():
                # rd_host is a lower bound on the device cursor, so
                # staying < K deep never overwrites a ring position an
                # in-flight segment might still read
                while wr_host - rd_host < K:
                    with obs.span("farm.stage"):
                        more = stage_next()
                    if not more:
                        return

            def unstage_all():
                """Rewind the ring at a repair boundary (the pipeline is
                drained): un-seated entries re-queue ahead of the cursor
                and the watermark drops back to the mirror cursor."""
                nonlocal wr_host
                while staged:
                    pending_entries.appendleft(staged.pop())
                wr_host = rd_host

            live_cache = [None, None]          # (key, device mask): the
                                               # mask changes only on a
                                               # quarantine
            def live_mask():
                key = tuple(slot_dead)
                if live_cache[0] != key:
                    live_cache[0] = key
                    live_cache[1] = torch.tensor(
                        [not d for d in slot_dead], device=dev)
                return live_cache[1]

            def dispatch():
                nonlocal frames, env_frames, r, itv, done, hw, rd
                (frames, env_frames, r, itv, done, hw, rd, meta, r_pre,
                 outs) = self._chain_entry(frames, env_frames, r, itv, done,
                                           hw, rd, wr_host, live_mask())
                self.stats["segments"] += 1
                if on_segment is not None:
                    # the preemption seam: fires while the segment's
                    # results are un-journaled (redone from the last
                    # snapshot, never re-emitted)
                    on_segment(self.stats["segments"])
                inflight.append((meta, r_pre, outs))

            def drain_one():
                """Consume the OLDEST in-flight segment: one metadata
                read, then the classic emission / retry / quarantine
                bookkeeping and the host mirror of the device's ring seats
                (lane order over the finished live slots)."""
                nonlocal prev_it, rd_host
                meta_d, r_d, outs_d = inflight.popleft()
                (meta_h,) = self._meta_read(meta_d)
                self.stats["host_reads"] += 1
                obs.poll()
                fin_h = meta_h[0:L] != 0
                it_h = meta_h[L:2 * L].astype(np.int64)
                hw_h = meta_h[2 * L:3 * L]
                took_h = meta_h[3 * L:4 * L] != 0
                account(meta_h[4 * L:], it_h)
                prev_it = np.where(took_h, 0, it_h)
                r_h = []                     # ONE reduce pull a drained
                                             # segment, on first need
                def payload(slot):
                    with obs.span("farm.payload", device=dev):
                        if not r_h:
                            with obs.span("farm.drain"):
                                r_h.append(r_d.cpu())
                            self.stats["host_reads"] += 1
                        self.stats["host_reads"] += 1
                        return (outs_d[slot // Ll][slot % Ll].cpu(),
                                r_h[0][slot])
                for slot in range(L):
                    entry = occupants[slot]
                    if entry is None or not fin_h[slot]:
                        continue
                    occupants[slot] = None
                    status = item_status(hw_h[slot], it_h[slot],
                                         loop.max_iters)
                    # a retirement lags one in-flight dispatch: the chain
                    # already in flight may seat one more occupant here
                    finish(slot, entry, status, it_h[slot],
                           lambda s=slot: payload(s))
                for slot in range(L):
                    if not took_h[slot]:
                        continue
                    if not staged:
                        raise RuntimeError(
                            "the device seated more items than were "
                            "staged")
                    entry = staged.popleft()
                    entry["attempts"] += 1
                    occupants[slot] = entry
                    self.stats["refills"] += 1
                    rd_host += 1

            while True:
                dispatched = False
                if retry_q:
                    # repair: drain the pipeline, rewind the ring, and run
                    # synchronously on classic admission until the retry
                    # queue is dry
                    while inflight:
                        drain_one()
                    unstage_all()
                    for slot in range(L):
                        if occupants[slot] is None \
                                and not slot_dead[slot]:
                            admit(slot)
                    if not any(o is not None for o in occupants):
                        break
                    dispatch()
                    dispatched = True
                    drain_one()
                else:
                    top_up()
                    work = (any(o is not None for o in occupants)
                            or bool(staged) or bool(pending_entries))
                    if not work and not inflight:
                        break
                    if work:
                        dispatch()
                        dispatched = True
                    # lag-1 drain: with a fresh dispatch in flight,
                    # consume only the PREVIOUS segment; with none left
                    # (tail), flush what remains
                    if len(inflight) > (1 if dispatched else 0):
                        drain_one()
                if dispatched and recovery is not None and \
                        self.stats["segments"] % \
                        recovery.snapshot_every == 0:
                    # snapshot boundary: drain the pipeline, then capture
                    # a consistent state
                    while inflight:
                        drain_one()
                    persist()

        def run_classic():
            nonlocal frames, env_frames, r, itv, done, hw, prev_it
            while any(o is not None for o in occupants):
                with obs.span("farm.dispatch", device=dev):
                    (frames, env_frames, r, itv, done, hw,
                     steps) = self._segment_body(frames, env_frames, r, itv,
                                               done, hw)
                self.stats["segments"] += 1
                if on_segment is not None:
                    # the preemption seam: fires BEFORE this segment's
                    # results are journaled
                    on_segment(self.stats["segments"])
                with obs.span("farm.drain"):
                    done_h = done.cpu().numpy()
                    it_h = itv.cpu().numpy().astype(np.int64)
                    r_h = r.cpu()
                    hw_h = hw.cpu().numpy()
                self.stats["host_reads"] += 4
                obs.poll()
                account(steps, it_h)
                prev_it = it_h.copy()
                finished = done_h | (it_h >= loop.max_iters)

                def payload(slot):
                    self.stats["host_reads"] += 1
                    with obs.span("farm.payload", device=dev):
                        return (self._extract_impl(frames, slot).cpu(),
                                r_h[slot])
                for slot in range(L):
                    entry = occupants[slot]
                    if entry is None or not finished[slot]:
                        continue
                    occupants[slot] = None
                    status = item_status(hw_h[slot], it_h[slot],
                                         loop.max_iters)
                    if finish(slot, entry, status, it_h[slot],
                              lambda s=slot: payload(s)):
                        continue
                    if not slot_dead[slot]:
                        admit(slot)
                if recovery is not None and \
                        self.stats["segments"] % \
                        recovery.snapshot_every == 0:
                    persist()

        try:
            # a FRESH chained stream seats its whole first cohort from the
            # ring: every slot starts retired and the first chain dispatch
            # (a zero-step segment) batch-seats from it.  Resumed runs keep
            # the classic admission: mid-flight occupants re-enter through
            # the carry-aware restore path the ring knows nothing about.
            if self._chain and state is None and not resume:
                r = torch.full_like(r, loop._id)
                itv = torch.full_like(itv, loop.max_iters)
                done = torch.ones_like(done)
                hw = torch.zeros_like(hw)
            else:
                for slot in range(L):
                    admit(slot)
                    if occupants[slot] is None:  # stream already drained
                        break
            # retired slots may carry iteration counts from a previous
            # stream — baseline the useful-work deltas on the real carry
            prev_it = itv.cpu().numpy().astype(np.int64)
            persist(complete=False)   # recoverable before the first
                                      # segment even starts
            if state is not None or resume:
                self.stats["recovery_seconds"] += (
                    time.perf_counter() - t_resume0)
            if self._chain:
                run_chained()
            else:
                run_classic()
            persist(complete=True)
        finally:
            self._frames, self._env_frames = frames, env_frames
            self._cont_carry = (r, itv, done, hw)
            if journal is not None:
                journal.close()
        self.stats["items"] += n_out
        return n_out

    # -- the stream protocol (read ∥ compute ∥ write) --------------------
    def run(self, source, sink, *, continuous: bool = False,
            recovery=None, resume: bool = False,
            on_segment: Optional[Callable] = None) -> int:
        """Drive a whole stream: ``source`` yields items (a callable
        returning an iterator, or an iterable), ``sink`` consumes one
        :class:`~repro_torch.core.pattern.LoopResult` (CPU tensors) per
        item, in order.  Round i is dispatched before round i−1 is drained
        into the sink.

        With ``continuous=True`` the stream runs in continuous per-lane
        refill mode instead (:meth:`run_continuous`): the sink receives
        :class:`StreamResult` objects in completion order.  ``recovery`` /
        ``resume`` / ``on_segment`` need continuous mode (round mode has
        no segment boundaries to snapshot at)."""
        if continuous:
            return self.run_continuous(source, sink, recovery=recovery,
                                       resume=resume,
                                       on_segment=on_segment)
        if recovery is not None or resume or on_segment is not None:
            raise ValueError(
                "recovery/resume/on_segment need continuous=True "
                "(round mode has no segment boundaries to snapshot at)")
        it = iter(source() if callable(source) else source)
        n = 0
        inflight = None
        while True:
            batch = list(islice(it, self.lanes))
            nxt = self.round(_stack_items(batch), len(batch)) if batch \
                else None
            if inflight is not None:
                n += self._drain(inflight, sink)
            inflight = nxt
            if not batch:
                break
        if inflight is not None:
            n += self._drain(inflight, sink)
        return n

    def _drain(self, result, sink) -> int:
        """ONE device→host pull per round; the per-item results are then
        views of the host copies, handed to the sink one at a time."""
        outs, red, iters, hw = (x.cpu() for x in result)
        self.stats["host_reads"] += 4
        self.stats["d2h_bytes"] += (_nbytes(outs) + _nbytes(red)
                                    + _nbytes(iters))
        for i in range(outs.shape[0]):
            sink(LoopResult(a=outs[i], reduced=red[i], iters=iters[i],
                            health=hw[i]))
        return outs.shape[0]

