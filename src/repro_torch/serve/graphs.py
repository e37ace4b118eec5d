"""Compiled decode: one decode step captured as a CUDA graph and replayed.

The port's twin of the reference's ``jax.jit`` over a decode step: the
reference's ``generate_jit`` lowers a whole generation to one on-device
``while_loop``, and its continuous engine jit-compiles each segment.  In
PyTorch the counterpart of ``jax.jit`` over a step of static shapes is a
captured CUDA graph: the host issues one replay a step in place of the
hundreds to thousands of kernel launches of an eager step.

:class:`StepGraph` holds such a step.  The step is a function of no
arguments that reads and writes only tensors that outlive it (the carry
buffers, the caches, the parameters), writes them in place, and does no
host read.  On a CUDA device its first ``WARMUP`` calls run it eagerly on a
side stream (real steps: the carry advances, and lazy state such as the
matrix library's workspaces is set up), the next call captures it with
:class:`torch.cuda.graph` and replays it, and every later call replays.
Warm-up and capture run under ``torch.cuda.set_sync_debug_mode("error")``,
so a hidden host synchronisation in the step raises.  A warm-up or a
capture that fails raises :class:`RuntimeError`: nothing falls back to the
eager step on the card.  On the CPU every call runs the step eagerly; that
is the plain version the CPU tests hold against the reference.

Every tensor the step reads is captured by address, the parameters
included: a replay reads what those tensors hold at that moment, so
in-place updates are seen, while a tensor replaced by a new one is not (the
graph goes on reading the old one).  Call :meth:`StepGraph.reset` after
replacing any of them; the next calls warm up and capture anew.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Callable

import torch

WARMUP = 2          # eager steps on a side stream before the capture


@contextlib.contextmanager
def _no_host_sync():
    """Make a synchronising CUDA call raise (``set_sync_debug_mode``), and
    restore the previous mode afterwards."""
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


@functools.lru_cache(maxsize=None)
def _side_stream(device: torch.device) -> torch.cuda.Stream:
    """The one warm-up stream of ``device``: the matrix library keeps a
    workspace for every stream it has run on, so a new stream a warm-up
    would leave one more behind each time."""
    return torch.cuda.Stream(device)


def graph_counts(step) -> tuple:
    """``(replays, captures)`` of a body step: a :class:`StepGraph`'s
    counters, ``(0, 0)`` for a step issued as a plain function."""
    return getattr(step, "replays", 0), getattr(step, "captures", 0)


class StepGraph:
    """A step over static buffers: eager on the CPU, a captured CUDA graph
    on the card (see the module docstring).  ``calls`` counts the steps
    issued, ``replays`` those issued as one graph replay."""

    def __init__(self, step: Callable[[], None], device):
        self.step = step
        self.device = torch.device(device)
        self.calls = 0
        self.replays = 0
        self.captures = 0
        self.reset()

    def reset(self):
        """Drop the graph: the next calls warm up and capture anew."""
        self.graph = None
        self._warm = 0

    def __call__(self):
        self.calls += 1
        if self.device.type != "cuda":
            self.step()
            return
        if self.graph is None:
            if self._warm < WARMUP:
                self._warm_up()
                return
            self._capture()
        self.graph.replay()
        self.replays += 1

    def _warm_up(self):
        main = torch.cuda.current_stream(self.device)
        side = _side_stream(self.device)
        side.wait_stream(main)
        try:
            with torch.cuda.stream(side), _no_host_sync():
                self.step()
        except Exception as e:
            raise RuntimeError(
                f"the decode step failed its warm-up before capture: {e}"
            ) from e
        finally:
            main.wait_stream(side)
        self._warm += 1

    def _capture(self):
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph):
                with _no_host_sync():
                    self.step()
        except Exception as e:
            raise RuntimeError(
                f"capturing the decode step as a CUDA graph failed: {e}"
            ) from e
        self.graph = graph
        self.captures += 1
