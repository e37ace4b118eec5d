#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Builds the hand-written CUDA kernel from ``src/repro_torch/kernels/csrc``,
holds it against its plain PyTorch version, and drives the port's main
path — the persistent-frame Loop-of-stencil-reduce and the paper's §4 apps
— on one CUDA card at full size:

  0. the card (nvidia-smi), torch/CUDA versions, kernel build time;
  1. kernel vs plain on frames: every registered functor at a
     non-tile-multiple 1000x1300 grid, monoids sum/max/min/any/all, measures
     none/abs_delta, all four boundaries, and a NaN-boundary max case;
  2. Helmholtz 8192x8192 f32, 200 sweeps whose condition never fires,
     on backend "cuda" and on "torch" (both on the card);
  3. a converging Helmholtz solve at 8192x8192 (equal iters on both);
  4. restoration of a 1080x1920 frame with 30% salt-and-pepper noise:
     AMF detection (equal masks), restore (equal iters, PSNR gain > 10 dB)
     and Sobel, kernel vs plain;
  5. per-kernel timings at the main path's shape and the ``kernels`` line;
  6. torch.profiler breakdown of the kernel loop, three runs: device time
     by kernel and the device's idle share;
  7. the kernel's time for a range of CTA tile shapes.

Every phase runs, at the sizes above.  Phases 2-4 are the main path: the
kernel launch counts are zeroed just before phase 2 and read just after
phase 4.  Every phase's failure propagates: the exit code is non-zero and
the final ok line is not printed.  Without a CUDA card, or without the
repository around it, the script exits non-zero before printing any
result.

    python3 chip_smoke.py
"""
import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SIZE = 8192            # Helmholtz grid side (phases 2, 3, 5, 6, 7)
TOL_GRID = 1e-5        # f32 grids, kernel vs plain (max abs error; phase 2
                       # scales it by max|u|, which is itself ~1e-5 there)
TOL_RED = 1e-5         # float sum reduces (relative); max/min/any exact
# published H100 device-memory rates (NVIDIA data sheets), by part
MEM_RATE = {"PCIe": 2.0e12, "NVL": 3.9e12, "SXM": 3.35e12}
FP32_RATE = 67e12      # H100 SXM float32 outside the tensor cores


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def mem_rate(name: str) -> float:
    for key, rate in MEM_RATE.items():
        if key in name:
            return rate
    return MEM_RATE["SXM"]


def sync():
    import torch
    torch.cuda.synchronize()


def cuda_ms(fn, iters=20, warmup=3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    sync()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    sync()
    return t0.elapsed_time(t1) / iters


def wall(fn):
    sync()
    t = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t


def max_err(x, y) -> float:
    """max |x - y| with NaN == NaN (a NaN on one side only is inf)."""
    import torch
    x, y = x.float(), y.float()
    both = torch.isnan(x) & torch.isnan(y)
    d = torch.where(both, torch.zeros_like(x), (x - y).abs())
    d = torch.where(torch.isnan(d), torch.full_like(d, math.inf), d)
    return float(d.max()) if d.numel() else 0.0


def same_scalar(a, b, rel) -> bool:
    a, b = float(a), float(b)
    if math.isnan(a) or math.isnan(b):
        return math.isnan(a) and math.isnan(b)
    if rel == 0.0:
        return a == b
    return abs(a - b) <= rel * max(abs(a), abs(b), 1e-30)


# ---------------------------------------------------------------------------


def phase0():
    import torch
    from repro_torch.kernels import _build
    card = card_line()
    log(f"[phase0] card: {card}")
    log(f"[phase0] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    t = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t
    blog = (_build.build_dir() / "build.log").read_text()
    regs = [int(w) for line in blog.splitlines() if "Used" in line
            for w, nxt in zip(line.split(), line.split()[1:])
            if nxt.startswith("registers")]
    spills = [line.strip() for line in blog.splitlines()
              if "spill stores" in line
              and " 0 bytes spill stores" not in line]
    log(f"[phase0] kernel build {build_s:.1f} s "
        f"({_build.build_dir()}), {len(regs)} instantiations, "
        f"registers max {max(regs) if regs else 'n/a'}, "
        f"spill lines {len(spills)}")
    for line in spills:
        log(f"[phase0]   {line}")
    return card


def phase1(gen):
    """Every functor: kernel vs plain on one frame sweep."""
    import torch
    from repro_torch.core.frames import frame_env, frame_spec, make_frame
    from repro_torch.kernels import ref as R
    from repro_torch.kernels.stencil2d import (stencil2d_fused_framed,
                                               stencil2d_fused_framed_ref)
    m, n = 1000, 1300
    dev = "cuda"

    def rand(binary=False):
        x = torch.rand((m, n), generator=gen, device=dev)
        return (x < 0.3).float() if binary else x

    cases = [
        # (label, elemental, boundary, combine, measure, binary input,
        #  env fields)
        ("jacobi", R.jacobi_taps(0.25), "zero", "sum", R.abs_delta, 0, 0),
        ("helmholtz_jacobi", R.helmholtz_jacobi_taps(0.5, 1 / 512), "zero",
         "max", R.abs_delta, 0, 1),
        ("heat", R.heat_taps(0.1), "wrap", "min", None, 0, 0),
        ("heat nan-boundary", R.heat_taps(0.1), "nan", "max", None, 0, 0),
        ("sobel", R.sobel_taps(), "reflect", "max", None, 0, 0),
        ("gol", R.gol_taps(), "wrap", "any", R.abs_delta, 1, 0),
        ("gol all", R.gol_taps(), "zero", "all", None, 1, 0),
        ("median3", R.median3_taps(), "reflect", "min", R.abs_delta, 0, 0),
        ("restore", R.restore_taps(2.0), "reflect", "sum", R.abs_delta, 0,
         2),
        ("conv k=1", R.conv_taps(torch.rand((3, 3), generator=gen,
                                            device=dev)),
         "nan", "sum", None, 0, 0),
        ("conv k=2", R.conv_taps(torch.rand((5, 5), generator=gen,
                                            device=dev)),
         "wrap", "sum", R.abs_delta, 0, 0),
        ("conv k=3", R.conv_taps(torch.rand((7, 7), generator=gen,
                                            device=dev)),
         "zero", "max", None, 0, 0),
    ]
    for kk, (b, comb, meas) in zip(
            (1, 2, 3), (("reflect", "sum", None), ("zero", "any", None),
                        ("wrap", "max", R.abs_delta))):
        fm, fr = R.amf_detect_taps(kk)
        cases.append((f"amf_mask k={kk}", fm, b, comb, meas, 0, 0))
        cases.append((f"amf_repl k={kk}", fr, b, "min" if kk != 2 else
                      "sum", R.abs_delta if kk != 3 else None, 0, 0))
    failures, worst = [], 0.0
    for label, f, b, comb, meas, binary, n_env in cases:
        a = rand(binary=bool(binary))
        spec = frame_spec(m, n, k=f.k)
        frame = make_frame(a, spec, b)
        env = []
        if n_env == 1:
            env = [torch.randn((m, n), generator=gen, device=dev)]
        elif n_env == 2:
            env = [rand(), rand(binary=True)]
        env = tuple(frame_env(e, spec, b) for e in env)
        kw = dict(env_framed=env, combine=comb, measure=meas)
        out_k, red_k = stencil2d_fused_framed(frame, f, spec, **kw)
        out_p, red_p = stencil2d_fused_framed_ref(frame, f, spec, **kw)
        sync()
        p = spec.pad
        mi, ni = spec.interior
        err = max_err(out_k[p:p + mi, p:p + ni], out_p[p:p + mi, p:p + ni])
        exact = bool(torch.equal(
            torch.nan_to_num(out_k[p:p + mi, p:p + ni], nan=7.0),
            torch.nan_to_num(out_p[p:p + mi, p:p + ni], nan=7.0)))
        rel = TOL_RED if comb == "sum" else 0.0
        ok_red = same_scalar(red_k, red_p, rel)
        ok = err <= TOL_GRID and ok_red and (
            exact or not label.startswith("amf_mask"))
        if label == "heat nan-boundary":
            ok = ok and math.isnan(float(red_k)) and math.isnan(float(red_p))
        worst = max(worst, err)
        log(f"[phase1] {label:18s} b={b:7s} {comb:3s} "
            f"meas={'abs_delta' if meas else 'none':9s} "
            f"max_abs_err={err:.3g} bit_exact={exact} "
            f"reduce kernel={float(red_k)!r} plain={float(red_p)!r} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(label)
    if failures:
        raise AssertionError(f"phase1 kernel/plain mismatch: {failures}")
    log(f"[phase1] {len(cases)} cases ok, worst grid error {worst:.3g}")
    return worst


def helmholtz_loop(u0, fxy, *, alpha, dx, tol, max_iters, backend, cond=None):
    from repro_torch.core.pattern import LoopOfStencilReduce
    from repro_torch.kernels import ref as R
    loop = LoopOfStencilReduce(
        f=R.helmholtz_jacobi_taps(alpha, dx), k=1, combine="max",
        cond=cond or (lambda r: r < tol), delta=R.abs_delta,
        boundary="zero", max_iters=max_iters, backend=backend,
        device="cuda")
    return loop.run(u0, env=(fxy,))


def phase2(gen, size, rate):
    """Helmholtz, fixed 200 sweeps: kernel vs plain on the card."""
    import torch
    sweeps = 200
    u0 = torch.zeros((size, size), device="cuda")
    fxy = torch.randn((size, size), generator=gen, device="cuda")
    kw = dict(alpha=0.5, dx=1.0 / 512, tol=0.0, max_iters=sweeps,
              cond=lambda r: False)
    helmholtz_loop(u0, fxy, **{**kw, "max_iters": 2}, backend="cuda")
    rk, tk = wall(lambda: helmholtz_loop(u0, fxy, **kw, backend="cuda"))
    rp, tp = wall(lambda: helmholtz_loop(u0, fxy, **kw, backend="torch"))
    err = max_err(rk.a, rp.a)
    # |u| after 200 sweeps is ~1e-5 here: hold the error to TOL_GRID of it
    umax = float(rp.a.abs().max())
    ms_k, ms_p = 1e3 * tk / sweeps, 1e3 * tp / sweeps
    gbs = 3 * size * size * 4 / (ms_k * 1e-3) / 1e9
    log(f"[phase2] helmholtz {size}x{size} f32 {sweeps} sweeps: "
        f"max|du| kernel-vs-plain={err!r} (limit {TOL_GRID * umax!r} = "
        f"{TOL_GRID} x max|u| {umax!r}) reduce kernel={float(rk.reduced)!r} "
        f"plain={float(rp.reduced)!r} iters {int(rk.iters)}/{int(rp.iters)} "
        f"ms/sweep cuda={ms_k:.4f} torch={ms_p:.4f} "
        f"effective {gbs:.0f} GB/s (3 streams x interior; "
        f"{gbs / (rate / 1e9):.2f} of {rate / 1e12:.2f} TB/s)")
    if not (umax > 0.0 and err <= TOL_GRID * umax
            and torch.isfinite(rk.a).all()
            and same_scalar(rk.reduced, rp.reduced, 0.0)
            and int(rk.iters) == sweeps == int(rp.iters)):
        raise AssertionError("phase2 helmholtz kernel/plain mismatch")
    return err, ms_k, ms_p


def phase3(gen, size):
    """Converging Helmholtz solve: equal iters, below the cap."""
    import torch
    u0 = torch.zeros((size, size), device="cuda")
    fxy = torch.randn((size, size), generator=gen, device="cuda")
    kw = dict(alpha=2.0, dx=0.2, tol=1e-5, max_iters=2000)
    rk, tk = wall(lambda: helmholtz_loop(u0, fxy, **kw, backend="cuda"))
    rp, tp = wall(lambda: helmholtz_loop(u0, fxy, **kw, backend="torch"))
    ik, ip = int(rk.iters), int(rp.iters)
    u = rk.a
    up = torch.nn.functional.pad(u, (1, 1, 1, 1))
    neigh = up[:-2, 1:-1] + up[2:, 1:-1] + up[1:-1, :-2] + up[1:-1, 2:]
    res = (4 + 2.0 * 0.04) * u - neigh - 0.04 * fxy
    resid = float(res.abs().max())
    err = max_err(rk.a, rp.a)
    log(f"[phase3] converging solve {size}x{size}: iters cuda={ik} "
        f"torch={ip} (cap 2000) max|du|={err!r} residual={resid:.3g} "
        f"reduce {float(rk.reduced)!r}/{float(rp.reduced)!r} "
        f"wall cuda={tk:.3f}s torch={tp:.3f}s")
    if not (ik == ip < 2000 and err <= TOL_GRID and resid < 1e-4):
        raise AssertionError("phase3 converging solve mismatch")
    return err


def phase4(gen):
    """Restoration of a full-HD frame, kernel vs plain."""
    import torch
    from repro_torch.kernels import ops
    h, w = 1080, 1920
    yy, xx = torch.meshgrid(torch.arange(h, device="cuda"),
                            torch.arange(w, device="cuda"), indexing="ij")
    clean = (0.5 + 0.3 * torch.sin(xx / 20.0) * torch.cos(yy / 15.0)
             ).clamp(0, 1).float()
    imp = torch.rand((h, w), generator=gen, device="cuda") < 0.3
    sp = (torch.rand((h, w), generator=gen, device="cuda") < 0.5).float()
    noisy = torch.where(imp, 1.0 - sp, clean)

    def psnr(x):
        return float(-10 * torch.log10(((x - clean) ** 2).mean() + 1e-12))

    # one untimed pass first: the walls below are steady state (the first
    # launch of each kernel instantiation loads its module)
    for be in ("cuda", "torch"):
        m0, r0 = ops.adaptive_median_detect(noisy, backend=be,
                                            device="cuda")
        ops.restore(r0, m0, backend=be, device="cuda")
        ops.sobel(noisy, backend=be, device="cuda")
    (mk, rk), tdk = wall(lambda: ops.adaptive_median_detect(
        noisy, backend="cuda", device="cuda"))
    (mp, rp), tdp = wall(lambda: ops.adaptive_median_detect(
        noisy, backend="torch", device="cuda"))
    masks_equal = bool(torch.equal(mk, mp))
    (ok_, dk, ik), trk = wall(lambda: ops.restore(rk, mk, backend="cuda", device="cuda"))
    (op_, dp, ip), trp = wall(lambda: ops.restore(rp, mp, backend="torch", device="cuda"))
    (ek, sk), tsk = wall(lambda: ops.sobel(noisy, backend="cuda", device="cuda"))
    (ep, spl), tsp = wall(lambda: ops.sobel(noisy, backend="torch", device="cuda"))
    gain = psnr(ok_) - psnr(noisy)
    recall = float((mk[imp] > 0).float().mean())
    err = max(max_err(rk, rp), max_err(ok_, op_), max_err(ek, ep))
    log(f"[phase4] restoration {h}x{w}: masks_equal={masks_equal} "
        f"recall={recall:.4f} restore iters cuda={int(ik)} "
        f"torch={int(ip)} mean|d| {float(dk)!r}/{float(dp)!r} "
        f"PSNR noisy={psnr(noisy):.2f} restored={psnr(ok_):.2f} dB "
        f"(gain {gain:.2f}) sobel max {float(sk)!r}/{float(spl)!r} "
        f"max_abs_err={err!r} wall detect {tdk:.4f}/{tdp:.4f}s "
        f"restore {trk:.4f}/{trp:.4f}s sobel {tsk:.4f}/{tsp:.4f}s")
    if not (masks_equal and int(ik) == int(ip) and gain > 10.0
            and err <= TOL_GRID and same_scalar(sk, spl, 0.0)):
        raise AssertionError("phase4 restoration mismatch")
    return err


def phase5(gen, size, rate):
    """Device time of one sweep at the main path's shape: the kernel, its
    plain version, and the bound.  Also the per-app sweeps."""
    import torch
    from repro_torch.core.frames import frame_env, frame_spec, make_frame
    from repro_torch.kernels import ref as R
    from repro_torch.kernels.stencil2d import (alloc_scratch,
                                               stencil2d_fused_framed,
                                               stencil2d_fused_framed_ref)

    def sweep_times(f, m, n, boundary, combine, measure, n_env, iters):
        a = torch.rand((m, n), generator=gen, device="cuda")
        spec = frame_spec(m, n, k=f.k)
        frame = make_frame(a, spec, boundary)
        out = torch.zeros_like(frame)
        scratch = alloc_scratch(spec, "cuda")
        env = tuple(frame_env(torch.rand((m, n), generator=gen,
                                         device="cuda"), spec, boundary)
                    for _ in range(n_env))
        kw = dict(env_framed=env, combine=combine, measure=measure)
        # the wrapper against its plain version on these inputs
        got, red_k = stencil2d_fused_framed(frame, f, spec, **kw)
        want, red_p = stencil2d_fused_framed_ref(frame, f, spec, **kw)
        p = spec.pad
        err = max_err(got[p:p + m, p:p + n], want[p:p + m, p:p + n])
        rel = TOL_RED if combine == "sum" else 0.0
        if not (err <= TOL_GRID and same_scalar(red_k, red_p, rel)):
            raise AssertionError(f"phase5 {f.functor} kernel/plain "
                                 f"mismatch: {err!r} {red_k!r} {red_p!r}")
        del got, want
        ms_k = cuda_ms(lambda: stencil2d_fused_framed(
            frame, f, spec, scratch=scratch, out=out, **kw), iters=iters)
        ms_p = cuda_ms(lambda: stencil2d_fused_framed_ref(
            frame, f, spec, out=out, **kw), iters=max(iters // 4, 2),
            warmup=1)
        del frame, out, env
        torch.cuda.empty_cache()
        return ms_k, ms_p, err

    ms_k, ms_p, err = sweep_times(R.helmholtz_jacobi_taps(0.5, 1 / 512),
                                  size, size, "zero", "max", R.abs_delta, 1,
                                  50)
    cells = size * size
    nbytes = 3 * cells * 4          # frame read, env read, frame written
    flops = 10 * cells              # 4 add, mul, add, div; sub, abs, max
    bound_ms = max(nbytes / rate, flops / FP32_RATE) * 1e3
    bound_by = "bytes" if nbytes / rate >= flops / FP32_RATE \
        else "operations"
    log(f"[phase5] stencil_sweep helmholtz {size}x{size}: kernel "
        f"{ms_k:.4f} ms, plain {ms_p:.4f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}), {nbytes / (ms_k * 1e-3) / 1e9:.0f} GB/s, "
        f"max_abs_err vs plain {err!r}")
    for label, f, b, comb, meas, n_env in [
            ("sobel", R.sobel_taps(), "reflect", "max", None, 0),
            ("amf_mask k=3", R.amf_detect_taps(3)[0], "reflect", "sum",
             None, 0),
            ("amf_repl k=3", R.amf_detect_taps(3)[1], "reflect", "sum",
             None, 0),
            ("restore", R.restore_taps(2.0), "reflect", "sum", R.abs_delta,
             2)]:
        k_ms, p_ms, e = sweep_times(f, 1080, 1920, b, comb, meas, n_env,
                                    20)
        err = max(err, e)
        log(f"[phase5] stencil_sweep {label} 1080x1920: kernel "
            f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, max_abs_err vs plain "
            f"{e!r}")
    return ms_k, ms_p, bound_ms, bound_by, err


def phase6(gen, size, runs=3):
    """Where a check's time goes in the kernel loop — device time
    by kernel name and the device's busy share, from torch.profiler over
    50 sweeps of the Helmholtz loop, ``runs`` times."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    u0 = torch.zeros((size, size), device="cuda")
    fxy = torch.randn((size, size), generator=gen, device="cuda")
    kw = dict(alpha=0.5, dx=1.0 / 512, tol=0.0, cond=lambda r: False)
    helmholtz_loop(u0, fxy, max_iters=2, backend="cuda", **kw)
    sync()
    idle = []
    for run in range(runs):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, secs = wall(lambda: helmholtz_loop(u0, fxy, max_iters=50,
                                                  backend="cuda", **kw))
        rows = []
        for ev in prof.key_averages():
            # device-side events only: CPU-side op entries repeat their
            # kernels' time
            if ev.device_type != torch.autograd.DeviceType.CUDA:
                continue
            us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
            if us > 0:
                rows.append((us, ev.count, ev.key))
        rows.sort(reverse=True)
        busy = sum(r[0] for r in rows) * 1e-6
        idle.append(1 - busy / secs)
        log(f"[phase6] run {run}: helmholtz {size}x{size} 50 sweeps under "
            f"the profiler: wall {secs * 1e3:.2f} ms, device busy "
            f"{busy * 1e3:.2f} ms (idle share {idle[-1]:.3f})")
        for us, count, key in rows[:10]:
            log(f"[phase6]   {us / 1e3:9.3f} ms  x{count:<5d} {key[:90]}")
    log(f"[phase6] idle share over {runs} runs: min {min(idle):.3f} "
        f"max {max(idle):.3f}")


def phase7(gen, size, rate):
    """The kernel's time per CTA tile shape, on the Helmholtz sweep
    at ``size`` (bound by bytes) and on the restoration sweeps at 1080x1920
    (AMF k=3 is bound by operations)."""
    import torch
    from repro_torch.core.frames import frame_env, frame_spec, make_frame
    from repro_torch.kernels import ref as R
    from repro_torch.kernels.stencil2d import (alloc_scratch,
                                               stencil2d_fused_framed)
    cases = [("helmholtz", R.helmholtz_jacobi_taps(0.5, 1 / 512), size,
              size, "zero", "max", R.abs_delta, 1),
             ("amf_mask k=3", R.amf_detect_taps(3)[0], 1080, 1920,
              "reflect", "sum", None, 0),
             ("restore", R.restore_taps(2.0), 1080, 1920, "reflect", "sum",
              R.abs_delta, 2)]
    for label, f, m, n, b, comb, meas, n_env in cases:
        a = torch.rand((m, n), generator=gen, device="cuda")
        es = [torch.rand((m, n), generator=gen, device="cuda")
              for _ in range(n_env)]
        for block in [(8, 32), (16, 32), (32, 32), (64, 32), (32, 64),
                      (64, 64), (16, 128), (32, 128), (8, 256),
                      (128, 128)]:
            spec = frame_spec(m, n, k=f.k, block=block)
            frame = make_frame(a, spec, b)
            out = torch.empty_like(frame)
            env = tuple(frame_env(e, spec, b) for e in es)
            scratch = alloc_scratch(spec, "cuda")
            ms = cuda_ms(lambda: stencil2d_fused_framed(
                frame, f, spec, env_framed=env, combine=comb,
                measure=meas, out=out, scratch=scratch), iters=20)
            gbs = (2 + n_env) * m * n * 4 / (ms * 1e-3) / 1e9
            log(f"[phase7] {label} {m}x{n} block {block} "
                f"({spec.gm * spec.gn} CTAs): {ms:.4f} ms/sweep, "
                f"{gbs:.0f} GB/s ({gbs * 1e9 / rate:.3f} of peak)")
            del frame, out, env
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: the port is not beside this script "
              f"({ROOT / 'src' / 'repro_torch'} missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import stencil2d as S

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    card = phase0()
    rate = mem_rate(card.split(",")[0])
    phase1(gen)
    S.launch_counts["stencil_sweep"] = 0           # main path: 2-4
    errs = [phase2(gen, SIZE, rate)[0], phase3(gen, SIZE), phase4(gen)]
    launches = S.launch_counts["stencil_sweep"]
    log(f"[main] stencil_sweep launches on the main path: {launches}")
    if launches == 0:
        raise AssertionError("the main path never launched stencil_sweep")
    ms_k, ms_p, bound_ms, bound_by, err5 = phase5(gen, SIZE, rate)
    log(json.dumps({"kernels": [{
        "name": "stencil_sweep",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/stencil2d.cu",
        "replaces": "src/repro/kernels/stencil2d.py:138",
        "launches": launches,
        "max_abs_err": max(errs + [err5]),
        "ms": ms_k,
        "plain_ms": ms_p,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "phases": {"launched": [2, 3, 4],
                   "held_against_plain": [1, 2, 3, 4, 5]},
    }]}))
    phase6(gen, SIZE)
    phase7(gen, SIZE, rate)
    log(card_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
