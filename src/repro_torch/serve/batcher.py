"""Request batching for the serving engine (the stream tier, 1:1 mode).

PyTorch twin of :mod:`repro.serve.batcher`.  The round path
(:meth:`Batcher.run_all`) groups ragged prompts by exact length, forms
FIFO batches of up to ``max_batch`` a group, and drives each batch through
one :func:`~repro_torch.serve.engine.generate` call (prefill and the
Loop-of-stencil-reduce-s decode) with per-request ``max_new_tokens``
budgets in the done-mask.  Each batch's arrays come to the host once.

The continuous path (:meth:`Batcher.run_continuous`) admits the whole
ragged queue into one :class:`~repro_torch.serve.engine.ContinuousEngine`
slot pool bound at the queue's longest prompt; results are emitted in
completion order.  SSM and hybrid archs fall back to exact-length groups
(their state updates have no pad mask).
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from ..configs.base import ArchConfig
from .engine import (ContinuousEngine, GenerateConfig, _arch_has_ssm,
                     generate, request_budget)

_EMPTY = np.zeros((0,), np.int32)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray           # (len,) int32
    max_new_tokens: Optional[int] = None   # per-request budget; None =
                                           # the engine's gcfg cap
    deadline: Optional[float] = None       # absolute, on the batcher's
                                           # clock; None = no deadline


@dataclasses.dataclass
class Result:
    rid: int
    tokens: np.ndarray           # (n_generated,) int32
    status: str = "ok"           # ok | timed_out | shed | failed
    error: Optional[str] = None  # why, for non-ok statuses


def _host(x) -> np.ndarray:
    """One device-to-host pull of a whole array."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


class Batcher:
    """FIFO exact-length-grouped batcher over the generate engine.

    Admission control: ``max_queue`` bounds the submit queue; past it,
    :meth:`submit` sheds the request (a ``status="shed"`` :class:`Result`
    instead of ``None``).  With ``est_service_time`` (seconds per
    dispatched batch), a request whose projected queue delay already
    passes its deadline is shed at submit too.  ``stats`` counts both shed
    reasons, failures and evictions.  ``device=None`` is the card.
    """

    def __init__(self, cfg: ArchConfig, params, gcfg: GenerateConfig, *,
                 max_batch: int = 8, cache_dtype=torch.float32,
                 max_queue: Optional[int] = None,
                 est_service_time: Optional[float] = None, clock=None,
                 device=None):
        self.cfg, self.params, self.gcfg = cfg, params, gcfg
        self.max_batch = max_batch
        self.cache_dtype = cache_dtype
        self.max_queue = max_queue
        self.est_service_time = est_service_time
        self.clock = time.monotonic if clock is None else clock
        self.device = device
        self._queue: List[Request] = []
        self.stats = {"submitted": 0, "accepted": 0,
                      "shed_queue_full": 0, "shed_deadline": 0,
                      "failed": 0, "evicted": 0, "shed": 0}

    def submit(self, req: Request) -> Optional[Result]:
        """Admit one request (``None``), or shed it: a terminal
        ``status="shed"`` :class:`Result` whose ``error`` names the reason
        (queue full, or projected delay past the deadline)."""
        self.stats["submitted"] += 1
        if self.max_queue is not None and len(self._queue) >= \
                self.max_queue:
            self.stats["shed_queue_full"] += 1
            return Result(rid=req.rid, tokens=_EMPTY, status="shed",
                          error=f"admission queue full "
                                f"(max_queue={self.max_queue})")
        dl = getattr(req, "deadline", None)
        if dl is not None and self.est_service_time is not None:
            waves = len(self._queue) // self.max_batch + 1
            projected = self.clock() + waves * self.est_service_time
            if projected > dl:
                self.stats["shed_deadline"] += 1
                return Result(
                    rid=req.rid, tokens=_EMPTY, status="shed",
                    error=f"projected completion {projected:.3f} past "
                          f"deadline {dl:.3f} "
                          f"({waves} queued batch waves ahead)")
        self._queue.append(req)
        self.stats["accepted"] += 1
        return None

    def _form_batch(self) -> Optional[List[Request]]:
        if not self._queue:
            return None
        L = len(self._queue[0].prompt)      # the FIFO head sets the group
        batch, rest = [], []
        for r in self._queue:
            if len(batch) < self.max_batch and len(r.prompt) == L:
                batch.append(r)
            else:
                rest.append(r)
        self._queue = rest
        return batch

    def _dispatch(self, batch: List[Request]):
        """One batch's generate call, per-request budgets through
        :func:`~repro_torch.serve.engine.request_budget` (the continuous
        engine's rule).  Returns the batch and its device tensors."""
        cap = self.gcfg.max_new_tokens
        toks = np.stack([r.prompt for r in batch]).astype(np.int32)
        budgets = np.asarray([request_budget(r, cap) for r in batch],
                             np.int32)
        gen, lengths, _ = generate(
            self.cfg, self.params, toks, self.gcfg,
            cache_dtype=self.cache_dtype, budgets=budgets,
            device=self.device)
        return batch, gen, lengths

    @staticmethod
    def _drain(inflight, out: List[Result]):
        batch, gen, lengths = inflight
        # one device-to-host pull per array per batch
        try:
            gen = _host(gen)
            lengths = _host(lengths)
        except Exception as e:               # noqa: BLE001 — a poisoned
            # batch degrades to per-request failed Results
            for r in batch:
                out.append(Result(rid=r.rid, tokens=_EMPTY,
                                  status="failed", error=str(e)))
            return
        for i, r in enumerate(batch):
            out.append(Result(rid=r.rid, tokens=gen[i, :int(lengths[i])]))

    def run_all(self) -> List[Result]:
        """Drain the queue; returns results in completion order (batch i+1
        dispatched before batch i is drained, as the reference)."""
        out: List[Result] = []
        inflight = None
        while True:
            batch = self._form_batch()
            nxt = self._dispatch(batch) if batch else None
            if inflight is not None:
                self._drain(inflight, out)
            inflight = nxt
            if not batch:
                break
        if inflight is not None:
            self._drain(inflight, out)
        self.stats["failed"] += sum(r.status == "failed" for r in out)
        return out

    def run_continuous(self, exact_groups: Optional[bool] = None, *,
                       recovery=None, resume: bool = False,
                       on_segment=None,
                       chained: bool = False) -> List[Result]:
        """Drain the queue through :class:`~repro_torch.serve.engine.
        ContinuousEngine`: the whole ragged queue through one engine
        binding at the queue's longest prompt; results in completion
        order; the engines used kept on ``self.engines``.

        ``exact_groups=True``: one engine per exact prompt length (the
        automatic fallback for SSM and hybrid archs).  ``recovery=``,
        ``resume=``, ``on_segment=`` and ``chained=`` pass through to
        :meth:`ContinuousEngine.run` (the single-pool path only for
        recovery); on resume the submitted queue may be empty.  A
        mid-stream engine fault degrades the unemitted requests to
        ``failed`` Results."""
        out: List[Result] = []
        self.engines: List[ContinuousEngine] = []
        if exact_groups and recovery is not None:
            raise ValueError(
                "recovery= needs the single-pool path (exact_groups "
                "slices the queue into per-length engines — a snapshot "
                "cannot name which engine it belongs to)")
        if not self._queue and not (recovery is not None and resume):
            return out
        if exact_groups is None:
            exact_groups = (False if recovery is not None
                            else _arch_has_ssm(self.cfg))

        def serve(eng, group):
            emitted = set()

            def sink(rid, toks, status):
                emitted.add(rid)
                out.append(Result(
                    rid=rid, tokens=toks, status=status,
                    error=None if status == "ok"
                    else f"engine status {status}"))

            try:
                eng.run(group, sink, clock=self.clock,
                        recovery=recovery, resume=resume,
                        on_segment=on_segment, chained=chained)
            except Exception as e:           # noqa: BLE001 — degrade
                survivors = [r for r in group if r.rid not in emitted]
                if not survivors:
                    # nothing to degrade into a failed Result: raise
                    self.engines.append(eng)
                    raise
                for r in survivors:
                    out.append(Result(rid=r.rid, tokens=_EMPTY,
                                      status="failed", error=str(e)))
                    self.stats["failed"] += 1
            self.stats["evicted"] += eng.stats["evicted"]
            self.stats["shed"] += eng.stats["shed"]
            self.engines.append(eng)

        def engine(max_prompt_len=None):
            return ContinuousEngine(
                self.cfg, self.params, self.gcfg, slots=self.max_batch,
                cache_dtype=self.cache_dtype, max_prompt_len=max_prompt_len,
                device=self.device)

        if not exact_groups:
            # on resume the snapshot's prompt width wins
            maxL = (max(len(r.prompt) for r in self._queue)
                    if self._queue and not resume else None)
            # built before the queue empties: an unsupported cfg raises
            # here and the requests stay queued
            eng = engine(maxL)
            queue, self._queue = self._queue, []
            serve(eng, queue)
            return out
        while self._queue:
            L = len(self._queue[0].prompt)      # the FIFO head sets the group
            group = [r for r in self._queue if len(r.prompt) == L]
            self._queue = [r for r in self._queue if len(r.prompt) != L]
            serve(engine(), group)
        return out
