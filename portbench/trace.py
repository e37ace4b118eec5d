"""A traced slice of the window, and what the metric readers take from it.

``--trace 1`` runs the same window as ``--trace 0`` and profiles a steady
slice of it with ``torch.profiler`` (CPU and CUDA activity): the driver
calls :meth:`Slice.tick` at each of the engine's segment boundaries, and the
profiler starts at the first tick at or after ``on`` and stops at the first
at or after ``off``.  :func:`summarise` turns the events into the device's
busy seconds (the union of its kernel, copy and set intervals), the traced
window's length, device seconds by kernel name, and the idle gaps between
device work by what the host was doing at each gap's start.  The readers
in ``metrics/`` share these sums.
"""
from __future__ import annotations

import bisect
from collections import defaultdict


class Slice:
    """Profile the part of the window between ``on`` and ``off`` (host
    clock seconds); a disabled slice does nothing."""

    def __init__(self, enabled: bool, on: float = 0.0, off: float = 0.0):
        self.enabled, self.on, self.off = enabled, on, off
        self.prof = None
        self.done = False
        self.marks = {}                 # "start" / "stop" -> driver values
        self.wall = []                  # host clock at start and stop

    def prime(self):
        """Start and stop a throwaway profile in set-up: the first start in
        a process initialises the profiler's device tracing, which takes
        seconds, and would otherwise eat the slice."""
        if not self.enabled:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        p = profile(activities=acts)
        p.start()
        torch.ones(1, device="cuda" if torch.cuda.is_available() else "cpu"
                   ).add_(1)
        p.stop()

    def tick(self, now: float, mark=None):
        """Start or stop the profiler at a segment boundary; ``mark()``
        returns the driver's counters at that boundary."""
        if not self.enabled or self.done:
            return
        if self.prof is None and now >= self.on:
            import time

            import torch
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.marks["start"] = mark() if mark else None
            self.prof.start()
            self.wall = [time.perf_counter()]
        elif self.prof is not None and now >= self.off:
            self.stop(mark)

    def stop(self, mark=None):
        if self.prof is not None and not self.done:
            import time
            self.wall.append(time.perf_counter())
            self.prof.stop()
            self.marks["stop"] = mark() if mark else None
            self.done = True

    def summary(self):
        """:func:`summarise` of the slice with its host-clock length, or
        None where it never ran."""
        if not self.done:
            return None
        out = summarise(self.prof)
        out["wall_s"] = self.wall[1] - self.wall[0]
        return out


def _is_device(ev) -> bool:
    import torch
    return ev.device_type == torch.autograd.DeviceType.CUDA


def _union(intervals):
    """Merge (start, end) intervals; returns the merged list."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def summarise(prof, top: int = 10) -> dict:
    """Busy and window seconds, device seconds by kernel name, and the
    ``top`` device operations and idle-gap causes, from a finished
    profile.  Times in the profile are microseconds."""
    dev, host = [], []
    for ev in prof.events():
        tr = ev.time_range
        if tr.end <= tr.start:
            continue
        (dev if _is_device(ev) else host).append(ev)
    if not dev:
        return {"busy_s": 0.0, "window_s": 0.0, "kernels": {},
                "device_ops": [], "idle_gaps": []}
    t0 = min(min(e.time_range.start for e in dev),
             min((e.time_range.start for e in host), default=float("inf")))
    t1 = max(max(e.time_range.end for e in dev),
             max((e.time_range.end for e in host), default=0.0))
    merged = _union((e.time_range.start, e.time_range.end) for e in dev)
    busy = sum(e - s for s, e in merged)
    by_name = defaultdict(float)
    for e in dev:
        by_name[e.name] += (e.time_range.end - e.time_range.start) * 1e-6
    # idle gaps: before the first device interval, between intervals, and
    # after the last, each named by the innermost host event covering its
    # start
    gaps = []
    edge = t0
    for s, e in merged:
        if s > edge:
            gaps.append((edge, s))
        edge = max(edge, e)
    if t1 > edge:
        gaps.append((edge, t1))
    host.sort(key=lambda ev: ev.time_range.start)
    starts = [ev.time_range.start for ev in host]
    causes = defaultdict(float)
    for s, e in gaps:
        i = bisect.bisect_right(starts, s) - 1
        name = "no host event"
        for j in range(i, max(i - 400, -1), -1):
            if host[j].time_range.end >= s:
                name = host[j].name
                break
        causes[name] += (e - s) * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])
    idle = sorted(causes.items(), key=lambda kv: -kv[1])
    return {"busy_s": busy * 1e-6, "window_s": (t1 - t0) * 1e-6,
            "kernels": dict(by_name),
            "device_ops": [[n, s] for n, s in ops[:top]],
            "idle_gaps": [[n, s] for n, s in idle[:top]]}


def kernel_seconds(summary: dict, *parts: str) -> float:
    """Device seconds of the kernels whose names hold every one of
    ``parts``."""
    return sum(s for name, s in summary["kernels"].items()
               if all(p in name for p in parts))
