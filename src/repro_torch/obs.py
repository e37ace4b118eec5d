"""Spans inside the port, and device idle put down to the host span that
caused it.

A span names one phase of the program where its work happens::

    with obs.span("farm.prep", device=dev):
        a0, envs = prep(item)

Tracing is on while a ``torch.profiler`` records (``torch.autograd.
profiler.emit_nvtx`` included) or after :func:`enable`, and off otherwise.
Off, :func:`span` makes one check and returns a shared no-op: no record
function, no CUDA event, no table entry.  On, a span

* opens a record function named ``name`` (``torch.profiler``'s fast
  variant, function scope), so it lies in the profiler's trace (or
  Nsight's NVTX ranges) on the profiler's own clock.  A user-scope range
  (``record_function``) would also become a device interval in a CUDA
  trace, from its first kernel to its last, idle between them counted as
  busy;
* adds its count and host seconds to a process-wide table;
* with ``device=`` a CUDA device (``True``: the current one, once CUDA is
  initialised), records a ``torch.cuda.Event`` pair on the current stream,
  except while that stream captures a CUDA graph.

Event pairs resolve lazily: :func:`poll` queries the oldest ones and never
waits, and the engines call it after the host reads they already make.  No
span adds a host synchronisation; :func:`collect` waits once, at the end of
an engine's run, and only for events recorded while tracing was on.

Idle attribution.  At the entry of a device span whose ``idle`` is true, the
pair (the last event such a span recorded, this span's start event) is kept
with the host time ``h`` of the start.  Its ``elapsed_time`` is 0 when work
was still queued, and otherwise the time the device sat with nothing to do:
the start event completes as soon as it is enqueued, so that idle ended at
``h`` and began at ``h - gap`` on the host clock, no earlier than the
previous event was recorded (``h_prev``).  A start within ``SNAP`` of
``h_prev`` is the device running dry at that event, and is put at
``h_prev``: the two events' submission latencies differ by microseconds.
The gap is charged to the innermost span open on the host at its start
(:func:`attribute`), or to the engine's ``<engine>.other``.  The rule holds
only where no device work was enqueued between the two events, so a span
inside a larger eager computation (one layer of a forward) passes
``idle=False``: it is timed but takes no part in the pairs.  Idle inside a
device span, between kernels its host issues one at a time, lies between
no pair and is not counted.

Engines fold the table into their ``stats`` (:func:`stats_keys`,
:func:`collect`): ``span_n.<name>``, ``span_host_ms.<name>``,
``span_dev_ms.<name>`` and ``span_dev_n.<name>`` (device spans),
``idle_ms.<name>``.
"""
from __future__ import annotations

import contextlib
import functools
import time
from collections import deque

import torch
from torch.autograd import _profiler_enabled

_enabled = False
_N, _HOST_S, _DEV_MS, _DEV_N, _IDLE_MS = range(5)
_table: dict = {}        # name -> [n, host s, device ms, device n, idle ms]
_stack: list = []        # open spans, outermost first
_closed: deque = deque()  # (name, t0, t1, depth) of closed spans, by t1
_pending: deque = deque()  # unresolved (kind, a, b, name or h, h_prev)
_last = None             # (event, host time) of the last idle-taking event
_other = "other"         # where idle goes when no span was open
MAX_PENDING = 4096       # spans kept before a span's exit polls
SNAP = 1e-4              # seconds: a gap starting this near its first
                         # event's record starts at that record


def enable(on: bool = True):
    """Turn tracing on (or off) whether or not a profiler records."""
    global _enabled
    _enabled = bool(on)


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str, *, device=False, idle: bool = True):
    """A context manager timing one phase (see the module docstring)."""
    if not (_enabled or _profiler_enabled()):
        return _OFF
    return _Span(name, device, idle)


def _row(name: str) -> list:
    r = _table.get(name)
    if r is None:
        r = _table[name] = [0, 0.0, 0.0, 0, 0.0]
    return r


def _on_card(device) -> bool:
    if device is True:
        return torch.cuda.is_initialized()
    if not device:
        return False
    return torch.device(device).type == "cuda"


class _Span:
    __slots__ = ("name", "device", "idle", "rf", "t0", "ev0", "depth")

    def __init__(self, name, device, idle):
        self.name, self.idle = name, idle
        self.device = _on_card(device)

    def __enter__(self):
        global _last
        self.rf = torch._C._profiler._RecordFunctionFast(self.name)
        self.rf.__enter__()
        self.t0 = time.perf_counter()
        self.depth = len(_stack)
        _stack.append(self)
        self.ev0 = None
        if self.device and not torch.cuda.is_current_stream_capturing():
            ev = self.ev0 = torch.cuda.Event(enable_timing=True)
            ev.record()
            if self.idle:
                h = time.perf_counter()
                if _last is not None:
                    _pending.append(("gap", _last[0], ev, h, _last[1]))
                _last = (ev, h)
        return self

    def __exit__(self, *exc):
        global _last
        # the host interval closes after the end event: idle that opens as
        # the device runs out of this span's work, the host still in it, is
        # this span's (as a trace names a gap after the call it starts in)
        if self.ev0 is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            _pending.append(("span", self.ev0, ev, self.name, None))
            if self.idle:
                _last = (ev, time.perf_counter())
        t1 = time.perf_counter()
        _stack.pop()
        r = _row(self.name)
        r[_N] += 1
        r[_HOST_S] += t1 - self.t0
        _closed.append((self.name, self.t0, t1, self.depth))
        self.rf.__exit__(*exc)
        if len(_pending) > MAX_PENDING or len(_closed) > MAX_PENDING:
            poll()
        return False


def attribute(spans, gaps, other: str) -> dict:
    """Milliseconds of device idle by span name.

    ``spans`` are host intervals ``(name, t0, t1, depth)`` (``t1`` may be
    ``inf`` for a span still open); ``gaps`` are ``(t, ms)``: ``ms`` of idle
    that began at host time ``t``.  Each gap goes to the deepest span open
    at its start, or to ``other``; a gap of 0 goes nowhere."""
    out: dict = {}
    for t, ms in gaps:
        if ms <= 0.0:
            continue
        best, depth = other, -1
        for name, t0, t1, d in spans:
            if t0 <= t < t1 and d > depth:
                best, depth = name, d
        out[best] = out.get(best, 0.0) + ms
    return out


def poll(wait: bool = False):
    """Resolve the pending event pairs whose events have completed, oldest
    first, without waiting (``wait``: wait for each first)."""
    if not _pending and not _closed:
        return
    gaps = []
    while _pending:
        kind, a, b, x, h_prev = _pending[0]
        if wait:
            a.synchronize()
            b.synchronize()
        elif not (b.query() and a.query()):
            break
        _pending.popleft()
        ms = a.elapsed_time(b)
        if kind == "span":
            r = _row(x)
            r[_DEV_MS] += ms
            r[_DEV_N] += 1
        else:
            t = x - ms * 1e-3
            gaps.append((h_prev if t < h_prev + SNAP else t, ms))
    if gaps:
        live = [(s.name, s.t0, float("inf"), s.depth) for s in _stack]
        for name, ms in attribute(list(_closed) + live, gaps,
                                  _other).items():
            _row(name)[_IDLE_MS] += ms
    # a later gap begins no earlier than the host time of its first event
    floor = min([p[4] for p in _pending if p[0] == "gap"]
                + ([_last[1]] if _last is not None else []),
                default=float("inf"))
    while _closed and _closed[0][2] < floor:
        _closed.popleft()


def stats_keys(names, *, device=(), other: str) -> dict:
    """The ``stats`` keys, at 0, of an engine whose spans are ``names``
    (``device`` among them record events) and whose unattributed idle goes
    to ``other``."""
    keys = {}
    for n in names:
        keys[f"span_n.{n}"] = 0
        keys[f"span_host_ms.{n}"] = 0.0
        if n in device:
            keys[f"span_dev_ms.{n}"] = 0.0
            keys[f"span_dev_n.{n}"] = 0
        keys[f"idle_ms.{n}"] = 0.0
    keys[f"idle_ms.{other}"] = 0.0
    return keys


@contextlib.contextmanager
def collect(stats: dict, other: str):
    """Fold what the spans inside record into ``stats``: each key of
    :func:`stats_keys` grows by its span's share of the table over the
    block.  Idle before the block's first device span is not counted, and
    idle no open span claims goes to ``other``."""
    global _other, _last
    prev_other, _other, _last = _other, other, None
    before = {n: list(r) for n, r in _table.items()}
    try:
        yield
    finally:
        poll(wait=True)
        _other, _last = prev_other, None
        for n, r in _table.items():
            b = before.get(n, (0, 0.0, 0.0, 0, 0.0))
            for key, i, scale in ((f"span_n.{n}", _N, 1),
                                  (f"span_host_ms.{n}", _HOST_S, 1e3),
                                  (f"span_dev_ms.{n}", _DEV_MS, 1),
                                  (f"span_dev_n.{n}", _DEV_N, 1),
                                  (f"idle_ms.{n}", _IDLE_MS, 1)):
                if key in stats and r[i] != b[i]:
                    stats[key] += (r[i] - b[i]) * scale


def collected(other: str):
    """Decorate an engine method so that :func:`collect` folds its spans
    into the engine's ``stats``."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(self, *args, **kw):
            with collect(self.stats, other):
                return fn(self, *args, **kw)
        return run
    return wrap


def table() -> dict:
    """A copy of the process-wide table: name -> ``{"n", "host_ms",
    "dev_ms", "dev_n", "idle_ms"}``."""
    return {n: {"n": r[_N], "host_ms": r[_HOST_S] * 1e3,
                "dev_ms": r[_DEV_MS], "dev_n": r[_DEV_N],
                "idle_ms": r[_IDLE_MS]} for n, r in _table.items()}
