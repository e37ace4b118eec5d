"""Data pipeline: deterministic synthetic token streams, batches placed on
the device or on a mesh, and a one-step-ahead prefetch.

PyTorch twin of :mod:`repro.data.pipeline`.  :class:`SyntheticLM` is the
reference's numpy code, copied as it is, so both packages draw the same
batches from the same seed: tokens follow a randomly parameterised
first-order Markov chain with a skip-gram copy rule, which a small LM
learns within a few hundred steps.

At scale this is the "read" stage of the paper's streaming tier: batches
are made on the host, copied to the card from pinned memory without
blocking the host (:class:`Prefetcher`), one step ahead, so the copy of
step t+1 is queued behind step t's compute.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from ..device import resolve_device
from ..sharding.specs import Mesh, axis_devices


@dataclasses.dataclass
class SyntheticLM:
    """Markov-chain + copy-rule synthetic language modelling task."""
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_states: int = 64

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        V = min(self.vocab_size, 4096)  # active vocabulary
        self._V = V
        # sparse-ish transition matrix with strong modes
        trans = rng.dirichlet(np.full(self.n_states, 0.1),
                              size=self.n_states)
        self._trans = trans / trans.sum(-1, keepdims=True)
        self._emit = rng.integers(0, V, size=(self.n_states, 8))

    def batches(self, start_step: int = 0) -> Iterator[dict]:
        step = start_step
        while True:
            yield self.batch_at(step)
            step += 1

    def batch_at(self, step: int) -> dict:
        """Deterministic batch for a step — restart/replay-safe (resuming
        at step k regenerates the same data).  numpy int32 ``tokens`` and
        ``labels`` (B, S)."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))
        B, S = self.global_batch, self.seq_len
        states = rng.integers(0, self.n_states, size=B)
        toks = np.empty((B, S + 1), np.int32)
        u = rng.random((B, S + 1))
        pick = rng.integers(0, 8, size=(B, S + 1))
        for t in range(S + 1):
            toks[:, t] = self._emit[states, pick[:, t]]
            cdf = np.cumsum(self._trans[states], axis=-1)
            states = (u[:, t, None] < cdf).argmax(-1)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _to(x, device: torch.device) -> torch.Tensor:
    """One leaf onto ``device``: from pinned host memory without blocking
    the host when the device is a card (the copy is queued on the current
    stream, behind the work already queued there)."""
    t = torch.as_tensor(np.ascontiguousarray(x)) \
        if isinstance(x, np.ndarray) else torch.as_tensor(x)
    if device.type != "cuda":
        return t.to(device)
    if t.device.type == "cpu":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def shard_batch(batch: dict, target=None):
    """Place a host batch: on a device (``None``: the CUDA card) as a dict
    of tensors, or on a :class:`~repro_torch.sharding.specs.Mesh` split
    along its ``"data"`` axis — one dict a data shard, in mesh order, each
    holding its rows on its own device (the single-controller counterpart
    of the reference's placement against the batch sharding).  The
    leading axis must divide evenly."""
    if isinstance(target, Mesh):
        devs = axis_devices(target, "data")
        out = [dict() for _ in devs]
        for k, v in batch.items():
            if v.shape[0] % len(devs):
                raise ValueError(
                    f"batch leaf {k!r} of {v.shape[0]} rows does not split "
                    f"over {len(devs)} data shards")
            for i, (part, dev) in enumerate(
                    zip(np.split(np.asarray(v), len(devs)), devs)):
                out[i][k] = _to(part, torch.device(dev))
        return out
    dev = resolve_device(target)
    return {k: _to(v, dev) for k, v in batch.items()}


class Prefetcher:
    """One-deep prefetch queue: the next batch's copy is issued when the
    current one is handed out (the paper's asynchronous H2D overlap).
    ``target`` is what :func:`shard_batch` takes."""

    def __init__(self, it: Iterator, target=None):
        self._it = it
        self._target = target
        self._next = self._load()

    def _load(self):
        try:
            b = next(self._it)
        except StopIteration:
            return None
        return shard_batch(b, self._target)

    def __iter__(self):
        return self

    def __next__(self):
        cur = self._next
        if cur is None:
            raise StopIteration
        self._next = self._load()
        return cur
