"""Driver of a restoration stream: paper §4.3's pipe(read, detect,
ofarm(restore), write) through the port's ``FarmEngine``.

Set-up makes the traffic's distinct noisy frames from the seed (on the
device, then into pinned host memory), builds the restoration loop and the
farm exactly as the configuration states (adaptive-median detection as the
farm's ``prep``, the restoration sweep as its worker, continuous refill),
and runs a few frames through it so that the slots are bound and every
kernel is built before the window.

The window offers the frames in a cycle as fast as the engine draws them:
a backlog.  An item's latency runs from the engine's draw to its result at
the sink.  When the window closes the source stops; the items still in
flight are drained and count neither as attempted nor as completed.

Correctness: every distinct frame emitted in the window has its first
emission compared pixel by pixel with the plain reference's restoration
(``reference/restore.py``, float32), and every emission's sweep count with
the reference's, once the window has closed and the farm is freed.
"""
from __future__ import annotations

import gc
import time

import torch

from portbench import report, spec
from portbench.reference import restore as ref
from portbench.trace import Slice

# a frame's result is complete when its loop's condition fired ("ok") or it
# ran the configuration's max_iters sweeps ("timed_out"); any other status
# (poisoned, nonconverged, rejected, failed) is a failure
COMPLETE = ("ok", "timed_out")


def build(cfg: dict, device):
    """The program under test: (loop, prep) as the configuration states."""
    from repro_torch.core.pattern import LoopOfStencilReduce
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as R

    r, d = cfg["restore"], cfg["detect"]
    backend = cfg["engine"]["backend"]
    tol = r["tol"]
    loop = LoopOfStencilReduce(
        f=R.restore_taps(r["beta"]), k=r["k"], combine=r["combine"],
        delta=R.abs_delta, cond=lambda x: x < tol, boundary=r["boundary"],
        max_iters=r["max_iters"], backend=backend, device=device)

    def prep(frame):
        mask, repaired = ops.adaptive_median_detect(
            frame, kmax=d["kmax"], backend=backend, device=device)
        return repaired, (repaired, mask)
    return loop, prep


class TimedPrep:
    """The farm's ``prep`` with CUDA events around each call (traced runs
    on the card only): device milliseconds of detection an item."""

    def __init__(self, prep, on: bool):
        self.prep, self.on = prep, on
        self.events = []

    def __call__(self, frame):
        if not self.on:
            return self.prep(frame)
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        out = self.prep(frame)
        b.record()
        self.events.append((a, b))
        return out

    def ms(self) -> list:
        return [a.elapsed_time(b) for a, b in self.events]


def run(c: dict, seed: int, seconds: float, trace: bool, *, device="cuda",
        t0: float, control: bool = False) -> dict:
    from repro_torch.core.streaming import FarmEngine

    cfg, traffic = c["config"], c["traffic"]
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    gen = spec.generator(c)
    frames_dev = gen.make(tuple(cfg["frame"]), traffic, seed, dev)
    n = frames_dev.shape[0]
    host = torch.empty(frames_dev.shape, dtype=frames_dev.dtype,
                       pin_memory=cuda)
    host.copy_(frames_dev)
    del frames_dev
    items = [host[i] for i in range(n)]

    loop, prep = build(cfg, dev)
    timed = TimedPrep(prep, on=trace and cuda)
    e = cfg["engine"]
    eng = FarmEngine(loop, lanes=e["lanes"], prep=timed, segment=e["segment"],
                     chained=e["chained"], device=dev)
    Slice(trace).prime()
    warm = int(traffic["warmup_items"])
    eng.run(items[:warm], lambda res: None, continuous=True)
    if cuda:
        torch.cuda.synchronize(dev)
    stats0 = dict(eng.stats)
    timed.events.clear()

    draws: list = []
    done: list = []                       # (index, t, iters, status)
    first: dict = {}                      # frame id -> restored frame
    t_start = time.perf_counter()
    t_end = t_start + seconds
    tslice = Slice(trace, t_start + (seconds - cfg["trace_seconds"]) / 2,
                   t_start + (seconds + cfg["trace_seconds"]) / 2)

    def source():
        i = 0
        while True:
            now = time.perf_counter()
            if now >= t_end:
                return
            draws.append(now)
            yield items[i % n]
            i += 1

    def sink(res):
        t = time.perf_counter()
        done.append((res.index, t, int(res.iters), res.status))
        fid = res.index % n
        if t <= t_end and fid not in first and res.status in COMPLETE:
            first[fid] = res.a

    def mark():
        s = eng.stats
        return s["lane_steps"] - s["wasted_lane_steps"]

    eng.run(source, sink, continuous=True,
            on_segment=lambda k: tslice.tick(time.perf_counter(), mark))
    tslice.stop(mark)
    if cuda:
        torch.cuda.synchronize(dev)
    stats = {k: eng.stats[k] - stats0[k] for k in stats0}

    in_window = [d for d in done if d[1] <= t_end]
    ok = [d for d in in_window if d[3] in COMPLETE]
    lat_ms = [(t - draws[i]) * 1e3 for i, t, _, _ in ok]
    e2e = {"setup_s": t_start - t0,
           "items_per_s": len(ok) / seconds,
           "item_p95_ms": report.percentile(lat_ms, 95) if lat_ms else None}
    summary = tslice.summary()
    m, w = cfg["frame"]
    ctx = {"stats": stats, "window_s": seconds, "trace": summary,
           "frame": (m, w),
           "detect_ms": timed.ms() if timed.on else [],
           "traced_useful_lane_steps": (
               tslice.marks["stop"] - tslice.marks["start"]
               if summary else None)}
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    del eng, loop, prep, timed
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks, ctrl = compare(cfg, host, in_window, first, dev, control)
    return {"e2e": e2e, "ctx": ctx, "trace": summary,
            "attempted": len(in_window), "failed": len(in_window) - len(ok),
            "memory_peak_bytes": peak, "checks": checks, "control": ctrl}


def compare(cfg, host, in_window, first, dev, control):
    """The checks of one run, and with ``control`` the control's readings
    (the reference in bfloat16 against it in float32) on the same
    frames."""
    n = host.shape[0]
    refs, ctrl_gap, ctrl_it = {}, 0.0, 0
    frame_gap = 0.0
    for fid in sorted({i % n for i, _, _, st in in_window
                       if st in COMPLETE}):
        frame = host[fid].to(dev)
        a, it = ref.restore_frame(frame, cfg)
        refs[fid] = it
        if fid in first:
            got = first[fid].to(dev)
            frame_gap = max(frame_gap, float((got - a).abs().max()))
        if control:
            ab, itb = ref.restore_frame(frame, cfg, dtype=torch.bfloat16)
            ctrl_gap = max(ctrl_gap, float((ab.float() - a).abs().max()))
            ctrl_it = max(ctrl_it, abs(itb - it))
    it_gap = max((abs(it - refs[i % n]) for i, _, it, st in in_window
                  if st in COMPLETE), default=None)
    not_ok = sum(st not in COMPLETE for _, _, _, st in in_window)
    lim = cfg["limits"]
    checks = [
        report.check("frame_max_abs", frame_gap if first else None,
                     lim["frame_max_abs"]),
        report.check("iters_max_abs", it_gap, lim["iters_max_abs"]),
        report.check("not_ok", not_ok, lim["not_ok"]),
        report.check("frames_compared", len(first), 1, kind="min"),
    ]
    ctrl = None
    if control:
        ctrl = [report.check("frame_max_abs", ctrl_gap,
                             lim["frame_max_abs"]),
                report.check("iters_max_abs", ctrl_it,
                             lim["iters_max_abs"])]
    return checks, ctrl
