#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``
(the single-step stencil+reduce sweep and the temporal-blocking multistep
sweep), holds each against its plain PyTorch version, and drives the port's
main paths — the persistent-frame Loop-of-stencil-reduce on "cuda" and
"cuda-multistep", the lane farm ``farm_run`` and the paper's §4 apps — on
one CUDA card at full size:

  0. the card (nvidia-smi), torch/CUDA versions, kernel build time;
  1. stencil_sweep vs plain on frames: every registered functor at a
     non-tile-multiple 1000x1300 grid, monoids sum/max/min/any/all, measures
     none/abs_delta, all four boundaries, and a NaN-boundary max case;
  8. multistep_sweep vs plain on frames at 1000x1300: every functor with
     T in {2, 3, 8}, the four boundaries with an asymmetric conv, env
     functors, sentinel domain bounds, a 3-lane stack with a frozen lane;
     bf16 frames on both kernels;
  2. Helmholtz 8192x8192 f32, 200 sweeps whose condition never fires,
     on backend "cuda" and on "torch" (both on the card);
  3. a converging Helmholtz solve at 8192x8192 (equal iters on both);
  4. restoration of a 1080x1920 frame with 30% salt-and-pepper noise:
     AMF detection (equal masks), restore (equal iters, PSNR gain > 10 dB)
     and Sobel, kernel vs plain;
  9. Helmholtz 8192x8192 on "cuda-multistep", T in {2, 4, 8}: 200 sweeps
     and the converging solve against "torch" at the same unroll;
 10. farm_run of 8 full-HD restoration lanes with different noise levels,
     on "cuda" and "cuda-multistep" (T=3), against solo runs and "torch";
  5. per-kernel timings at the main path's shape and the ``kernels`` line;
  6. torch.profiler breakdown of the kernel loops (three runs on "cuda",
     one on "cuda-multistep" at T=4): device time by kernel and the
     device's idle share;
  7. the single-step kernel's time for a range of CTA tile shapes.

Every phase runs, at the sizes above, in the order listed.  Phases 2-4, 9
and 10 are the main path: the kernel launch counts are zeroed just before
phase 2 and read just after phase 10.  Every phase's failure propagates:
the exit code is non-zero and the final ok line is not printed.  Without a
CUDA card, or without the repository around it, the script exits non-zero
before printing any result.

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
TOL_BF16 = 5e-2        # bf16 frames, kernel vs plain (atol and rtol; the
                       # reference's bf16 tolerance): the kernel computes in
                       # float and rounds once per sweep, the plain version
                       # rounds after every torch op
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


def within(x, y, tol) -> bool:
    """|x - y| <= tol + tol * |y| everywhere, NaN == NaN."""
    import torch
    x, y = x.float(), y.float()
    both = torch.isnan(x) & torch.isnan(y)
    ok = (x - y).abs() <= tol + tol * y.abs()
    return bool((ok | both).all())


def zero_counts():
    from repro_torch.kernels import stencil2d as S
    for key in S.launch_counts:
        S.launch_counts[key] = 0


def same_scalar(a, b, rel) -> bool:
    a, b = float(a), float(b)
    if math.isnan(a) or math.isnan(b):
        return math.isnan(a) and math.isnan(b)
    if rel == 0.0:
        return a == b
    return abs(a - b) <= rel * max(abs(a), abs(b), 1e-30)


# ---------------------------------------------------------------------------


def ptxas_entries(blog: str):
    """(kernel name, registers, spill line or None) per instantiation, from
    the ``-Xptxas -v`` output in the build log."""
    entries = []
    for line in blog.splitlines():
        if "Compiling entry function" in line:
            entries.append([line.split("'")[1], 0, None])
        elif entries and "Used" in line and "registers" in line:
            words = line.split()
            entries[-1][1] = int(words[words.index("Used") + 1])
        elif entries and "spill stores" in line \
                and " 0 bytes spill stores" not in line:
            entries[-1][2] = line.strip()
    return [tuple(e) for e in entries]


def short_name(mangled: str) -> str:
    """``kernel<storage, functor>`` from a mangled instantiation name."""
    kernel = "multistep" if "multistep_kernel" in mangled else "stencil_sweep"
    storage = "bf16" if "nv_bfloat16" in mangled else "f32"
    functor = next((w for w in ("HelmholtzJacobi", "AmfMask", "AmfRepl",
                                "Median3", "Restore", "Jacobi", "Heat",
                                "Sobel", "Gol", "Conv") if w in mangled), "?")
    if functor in ("AmfMask", "AmfRepl", "Conv"):
        after = mangled.split(functor, 1)[1]
        functor += "<" + after[after.index("Li") + 2] + ">"
    return f"{kernel}<{storage}, {functor}>"


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
    entries = ptxas_entries((_build.build_dir() / "build.log").read_text())
    regs = [r for _, r, _ in entries]
    log(f"[phase0] kernel build {build_s:.1f} s "
        f"({_build.build_dir()}), {len(entries)} instantiations, "
        f"registers max {max(regs) if regs else 'n/a'}")
    for name, r, spill in entries:
        if "HelmholtzJacobi" in name and "nv_bfloat16" not in name:
            log(f"[phase0]   {short_name(name)}: {r} registers")
        if spill:
            log(f"[phase0]   {short_name(name)}: {r} registers, {spill}")
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


def helmholtz_loop(u0, fxy, *, alpha, dx, tol, max_iters, backend, cond=None,
                   unroll=1):
    from repro_torch.core.pattern import LoopOfStencilReduce
    from repro_torch.kernels import ref as R
    loop = LoopOfStencilReduce(
        f=R.helmholtz_jacobi_taps(alpha, dx), k=1, combine="max",
        cond=cond or (lambda r: r < tol), delta=R.abs_delta,
        boundary="zero", max_iters=max_iters, backend=backend,
        unroll=unroll, device="cuda")
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


def phase5_multistep(gen, size, rate):
    """Device time of one multistep launch (T fused sweeps) at the main
    path's shape for T in {2, 4, 8}: the kernel, its plain version and the
    bound."""
    import torch
    from repro_torch.core.frames import frame_env, frame_spec, make_frame
    from repro_torch.kernels import ref as R
    from repro_torch.kernels.multistep import (stencil2d_multistep_framed,
                                               stencil2d_multistep_framed_ref)
    from repro_torch.kernels.stencil2d import alloc_scratch
    f = R.helmholtz_jacobi_taps(0.5, 1 / 512)
    cells = size * size
    rows = {}
    for T in (2, 4, 8):
        spec = frame_spec(size, size, k=1, sweeps=T)
        frame = make_frame(torch.rand((size, size), generator=gen,
                                      device="cuda"), spec, "zero")
        env = (frame_env(torch.rand((size, size), generator=gen,
                                    device="cuda"), spec, "zero",
                         halo=True),)
        out = torch.zeros_like(frame)
        scratch = alloc_scratch(spec, "cuda")
        kw = dict(T=T, env_framed=env, combine="max", measure=R.abs_delta,
                  boundary="zero")
        got, red_k = stencil2d_multistep_framed(frame, f, spec, **kw)
        want, red_p = stencil2d_multistep_framed_ref(frame, f, spec, **kw)
        p = spec.pad
        err = max_err(got[p:p + size, p:p + size],
                      want[p:p + size, p:p + size])
        if not (err <= TOL_GRID and same_scalar(red_k, red_p, 0.0)):
            raise AssertionError(f"phase5 multistep T={T} kernel/plain "
                                 f"mismatch: {err!r} {red_k!r} {red_p!r}")
        del got, want
        ms_k = cuda_ms(lambda: stencil2d_multistep_framed(
            frame, f, spec, out=out, scratch=scratch, **kw), iters=20)
        ms_p = cuda_ms(lambda: stencil2d_multistep_framed_ref(
            frame, f, spec, out=out, **kw), iters=3, warmup=1)
        # least work: the frame and the env field read once, the frame
        # written once; T sweeps of 10 flops a cell
        nbytes, flops = 3 * cells * 4, 10 * cells * T
        bound_ms = max(nbytes / rate, flops / FP32_RATE) * 1e3
        bound_by = "bytes" if nbytes / rate >= flops / FP32_RATE \
            else "operations"
        # the kernel's own traffic: each tile reads its (bm+2T)(bn+2T)
        # window of both fields and writes its tile
        win = (1 + 2 * T / spec.bm) * (1 + 2 * T / spec.bn)
        design_ms = (win * 2 * 4 + 4) * cells / rate * 1e3
        log(f"[phase5] multistep_sweep helmholtz {size}x{size} T={T}: "
            f"kernel {ms_k:.4f} ms/launch = {ms_k / T:.4f} ms/sweep, plain "
            f"{ms_p:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), window "
            f"traffic {design_ms:.4f} ms at the HBM rate, "
            f"{nbytes / (ms_k * 1e-3) / 1e9:.0f} GB/s of least bytes, "
            f"max_abs_err vs plain {err!r}")
        rows[T] = dict(ms=ms_k, ms_sweep=ms_k / T, plain_ms=ms_p,
                       bound_ms=bound_ms, bound_by=bound_by,
                       window_ms=design_ms, err=err)
        del frame, out, env
        torch.cuda.empty_cache()
    return rows


def phase6(gen, size, runs=3):
    """Where a check's time goes in the kernel loops — device time by
    kernel name and the device's busy share, from torch.profiler over 48
    sweeps of the Helmholtz loop: ``runs`` times on "cuda", once on
    "cuda-multistep" at T=4."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    u0 = torch.zeros((size, size), device="cuda")
    fxy = torch.randn((size, size), generator=gen, device="cuda")
    kw = dict(alpha=0.5, dx=1.0 / 512, tol=0.0, cond=lambda r: False)
    sweeps = 48
    plan = [("cuda", 1)] * runs + [("cuda-multistep", 4)]
    for backend, T in set(plan):
        helmholtz_loop(u0, fxy, max_iters=2 * T, backend=backend, unroll=T,
                       **kw)
    sync()
    idle = {}
    for run, (backend, T) in enumerate(plan):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, secs = wall(lambda: helmholtz_loop(
                u0, fxy, max_iters=sweeps, backend=backend, unroll=T, **kw))
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
        idle.setdefault(backend, []).append(1 - busy / secs)
        log(f"[phase6] run {run}: helmholtz {size}x{size} {sweeps} sweeps "
            f"on {backend} (unroll {T}) under the profiler: wall "
            f"{secs * 1e3:.2f} ms, device busy {busy * 1e3:.2f} ms (idle "
            f"share {idle[backend][-1]:.3f})")
        for us, count, key in rows[:10]:
            log(f"[phase6]   {us / 1e3:9.3f} ms  x{count:<5d} {key[:90]}")
    for backend, shares in idle.items():
        log(f"[phase6] idle share on {backend} over {len(shares)} runs: "
            f"min {min(shares):.3f} max {max(shares):.3f}")


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


def phase8(gen):
    """multistep_sweep vs plain on frames at 1000x1300: every functor with
    T in {2, 3, 8} (AMF k=3 at T=2), the four boundaries with an asymmetric
    3x3 conv, env functors, a domain_bounds case with sentinel sides and a
    3-lane stack with a frozen lane; then bf16 frames on both kernels."""
    import torch
    from repro_torch.core.frames import (frame_env, frame_spec,
                                         lane_env_frames, make_frame,
                                         make_lane_frames, refresh_frame)
    from repro_torch.kernels import ref as R
    from repro_torch.kernels.multistep import (
        SENTINEL, stencil2d_multistep_framed, stencil2d_multistep_framed_ref)
    from repro_torch.kernels.stencil2d import (stencil2d_fused_framed,
                                               stencil2d_fused_framed_ref)
    m, n = 1000, 1300
    dev = "cuda"
    bounds4 = ("zero", "nan", "reflect", "wrap")

    def rand(binary=False, shape=(m, n), dtype=torch.float32):
        x = torch.rand(shape, generator=gen, device=dev)
        return ((x < 0.3).float() if binary else x).to(dtype)

    def envs(n_env, shape=(m, n), dtype=torch.float32):
        if n_env == 1:
            return [torch.randn(shape, generator=gen, device=dev).to(dtype)]
        if n_env == 2:
            return [rand(shape=shape, dtype=dtype),
                    rand(True, shape, dtype)]
        return []

    # mirror-asymmetric weights (the reference test's `lopsided` stencil):
    # catch boundary models that evolve a continuation instead of
    # re-asserting the boundary after every sweep
    lop = R.conv_taps([[0.0, 0.0, 0.3], [0.2, 0.25, 0.0], [0.0, 0.25, 0.0]])
    functors = [
        ("jacobi", R.jacobi_taps(0.25), "sum", R.abs_delta, 0, 0),
        ("helmholtz_jacobi", R.helmholtz_jacobi_taps(0.5, 1 / 512), "max",
         R.abs_delta, 0, 1),
        ("heat", R.heat_taps(0.1), "min", None, 0, 0),
        ("sobel", R.sobel_taps(), "max", None, 0, 0),
        ("gol", R.gol_taps(), "any", R.abs_delta, 1, 0),
        ("median3", R.median3_taps(), "min", R.abs_delta, 0, 0),
        ("restore", R.restore_taps(2.0), "sum", R.abs_delta, 0, 2),
        ("conv k=2", R.conv_taps(torch.rand((5, 5), generator=gen,
                                            device=dev) - 0.5),
         "sum", None, 0, 0),
        ("conv k=3", R.conv_taps(torch.rand((7, 7), generator=gen,
                                            device=dev) - 0.5),
         "max", R.abs_delta, 0, 0),
    ]
    for kk in (1, 2, 3):
        fm, fr = R.amf_detect_taps(kk)
        functors.append((f"amf_mask k={kk}", fm, "sum", None, 0, 0))
        functors.append((f"amf_repl k={kk}", fr, "max", R.abs_delta, 0, 0))
    cases = []
    for i, (label, f, comb, meas, binary, n_env) in enumerate(functors):
        for j, T in enumerate((2, 3, 8)):
            if label == "amf_mask k=3" or label == "amf_repl k=3":
                if T != 2:
                    continue
            cases.append((label, f, bounds4[(i + j) % 4], comb, meas,
                          binary, n_env, T, None))
    for b in bounds4:
        for T in (2, 3, 8):
            cases.append(("conv lopsided", lop, b, "max", R.abs_delta, 0, 0,
                          T, None))
    cases.append(("heat sentinel cols", R.heat_taps(0.1), "reflect", "max",
                  R.abs_delta, 0, 0, 3, "cols"))

    failures, worst, worst_rel = [], 0.0, 0.0
    for label, f, b, comb, meas, binary, n_env, T, sent in cases:
        spec = frame_spec(m, n, k=f.k, sweeps=T)
        frame = make_frame(rand(bool(binary)), spec, b)
        env = tuple(frame_env(e, spec, b, halo=True) for e in envs(n_env))
        db = None
        if sent == "cols":
            p = spec.pad
            db = (p, p + m, -SENTINEL, SENTINEL)
        kw = dict(T=T, env_framed=env, combine=comb, measure=meas,
                  boundary=b, domain_bounds=db)
        out_k, red_k = stencil2d_multistep_framed(frame, f, spec, **kw)
        out_p, red_p = stencil2d_multistep_framed_ref(frame, f, spec, **kw)
        sync()
        p = spec.pad
        dk, dp = out_k[p:p + m, p:p + n], out_p[p:p + m, p:p + n]
        err = max_err(dk, dp)
        scale = max(1.0, float(torch.nan_to_num(dp, nan=0.0).abs().max()))
        exact = bool(torch.equal(torch.nan_to_num(dk, nan=7.0),
                                 torch.nan_to_num(dp, nan=7.0)))
        ok = (err <= TOL_GRID * scale
              and same_scalar(red_k, red_p, TOL_RED if comb == "sum"
                              else 0.0))
        worst, worst_rel = max(worst, err), max(worst_rel, err / scale)
        log(f"[phase8] multistep {label:18s} T={T} b={b:7s} {comb:3s} "
            f"max_abs_err={err:.3g} (scale {scale:.3g}) bit_exact={exact} "
            f"reduce kernel={float(red_k)!r} plain={float(red_p)!r} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"{label} T={T} {b}")
        del frame, env, out_k, out_p

    # three lanes in one launch, the middle one frozen
    f, T, b = R.helmholtz_jacobi_taps(0.5, 1 / 512), 3, "reflect"
    spec = frame_spec(m, n, k=1, sweeps=T)
    frames = make_lane_frames(rand(shape=(3, m, n)), spec, b)
    env = (lane_env_frames(torch.randn((3, m, n), generator=gen, device=dev),
                           spec, b, halo=True),)
    live = torch.tensor([True, False, True], device=dev)
    kw = dict(T=T, env_framed=env, combine="max", measure=R.abs_delta,
              boundary=b, live=live)
    out_k, red_k = stencil2d_multistep_framed(frames, f, spec, **kw)
    out_p, red_p = stencil2d_multistep_framed_ref(frames, f, spec, **kw)
    sync()
    p = spec.pad
    err = max_err(out_k[:, p:p + m, p:p + n], out_p[:, p:p + m, p:p + n])
    frozen = bool(torch.equal(out_k[1, p:p + m, p:p + n],
                              frames[1, p:p + m, p:p + n]))
    ok = (err <= TOL_GRID and frozen and torch.equal(red_k, red_p)
          and float(red_k[1]) == -math.inf)
    log(f"[phase8] multistep lanes=3 live=[1,0,1] T={T}: max_abs_err="
        f"{err!r} frozen lane kept={frozen} reduce kernel="
        f"{red_k.tolist()} plain={red_p.tolist()} {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("lanes")
    worst = max(worst, err)

    # bf16 frames on both kernels, against the plain versions (TOL_BF16),
    # and multistep against T single-step launches of the bf16 kernel
    worst16 = 0.0
    for label, f, b, comb, n_env, T in [
            ("heat", R.heat_taps(0.1), "zero", "max", 0, 3),
            ("helmholtz_jacobi", R.helmholtz_jacobi_taps(0.5, 1 / 512),
             "reflect", "max", 1, 4),
            ("restore", R.restore_taps(2.0), "wrap", "sum", 2, 2)]:
        a = rand(dtype=torch.bfloat16)
        fields = envs(n_env, dtype=torch.bfloat16)
        kw = dict(combine=comb, measure=R.abs_delta)
        s1 = frame_spec(m, n, k=1)
        fr1 = make_frame(a, s1, b)
        e1 = tuple(frame_env(e, s1, b) for e in fields)
        ok1, rk1 = stencil2d_fused_framed(fr1, f, s1, env_framed=e1, **kw)
        op1, rp1 = stencil2d_fused_framed_ref(fr1, f, s1, env_framed=e1,
                                              **kw)
        sT = frame_spec(m, n, k=1, sweeps=T)
        frT = make_frame(a, sT, b)
        eT = tuple(frame_env(e, sT, b, halo=True) for e in fields)
        okT, rkT = stencil2d_multistep_framed(frT, f, sT, T=T, env_framed=eT,
                                              boundary=b, **kw)
        opT, rpT = stencil2d_multistep_framed_ref(frT, f, sT, T=T,
                                                  env_framed=eT,
                                                  boundary=b, **kw)
        # T single-step bf16 launches with the ghost refresh between them
        cur, nxt = fr1.clone(), torch.empty_like(fr1)
        for _ in range(T):
            nxt, _ = stencil2d_fused_framed(cur, f, s1, env_framed=e1,
                                            out=nxt, **kw)
            refresh_frame(nxt, s1, b)
            cur, nxt = nxt, cur
        sync()
        d1 = (ok1[1:1 + m, 1:1 + n], op1[1:1 + m, 1:1 + n])
        q = sT.pad
        dT = (okT[q:q + m, q:q + n], opT[q:q + m, q:q + n])
        same_as_single = bool(torch.equal(dT[0], cur[1:1 + m, 1:1 + n]))
        e_1, e_T = max_err(*d1), max_err(*dT)
        ok = (within(*d1, TOL_BF16) and within(*dT, TOL_BF16)
              and within(rk1, rp1, TOL_BF16) and within(rkT, rpT, TOL_BF16)
              and same_as_single)
        worst16 = max(worst16, e_1, e_T)
        log(f"[phase8] bf16 {label:16s} b={b:7s}: stencil_sweep "
            f"max_abs_err={e_1:.3g} reduce {float(rk1)!r}/{float(rp1)!r}; "
            f"multistep T={T} max_abs_err={e_T:.3g} reduce "
            f"{float(rkT)!r}/{float(rpT)!r}; multistep == {T} single-step "
            f"launches: {same_as_single} (tolerance {TOL_BF16}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"bf16 {label}")
    if failures:
        raise AssertionError(f"phase8 kernel/plain mismatch: {failures}")
    log(f"[phase8] {len(cases) + 1} multistep cases ok, worst f32 grid "
        f"error {worst!r} absolute, {worst_rel!r} relative to max(1, "
        f"max|plain|); bf16 worst {worst16!r}")
    return worst, worst16


def phase9(gen, size, ms_single):
    """Helmholtz at ``size`` on "cuda-multistep", T in {2, 4, 8}: 200
    sweeps against "torch" at the same unroll, and the converging solve
    (equal iters to "torch", within [iters on "cuda" at T=1, that + T))."""
    import torch
    u0 = torch.zeros((size, size), device="cuda")
    fxy = torch.randn((size, size), generator=gen, device="cuda")
    fixed = dict(alpha=0.5, dx=1.0 / 512, tol=0.0, cond=lambda r: False)
    conv = dict(alpha=2.0, dx=0.2, tol=1e-5, max_iters=2000)
    iters_t1 = int(helmholtz_loop(u0, fxy, backend="cuda", **conv).iters)
    sweeps, errs, rows = 200, [], {}
    for T in (2, 4, 8):
        helmholtz_loop(u0, fxy, max_iters=2 * T, backend="cuda-multistep",
                       unroll=T, **fixed)
        rk, tk = wall(lambda: helmholtz_loop(
            u0, fxy, max_iters=sweeps, backend="cuda-multistep", unroll=T,
            **fixed))
        rp, tp = wall(lambda: helmholtz_loop(
            u0, fxy, max_iters=sweeps, backend="torch", unroll=T, **fixed))
        err = max_err(rk.a, rp.a)
        umax = float(rp.a.abs().max())
        ck, tck = wall(lambda: helmholtz_loop(
            u0, fxy, backend="cuda-multistep", unroll=T, **conv))
        cp, tcp = wall(lambda: helmholtz_loop(
            u0, fxy, backend="torch", unroll=T, **conv))
        cerr = max_err(ck.a, cp.a)
        ik, ip = int(ck.iters), int(cp.iters)
        ms_k, ms_p = 1e3 * tk / sweeps, 1e3 * tp / sweeps
        log(f"[phase9] helmholtz {size}x{size} cuda-multistep T={T}: "
            f"{sweeps} sweeps max|du| vs torch={err!r} (limit "
            f"{TOL_GRID * umax!r}) reduce {float(rk.reduced)!r}/"
            f"{float(rp.reduced)!r} ms/sweep multistep={ms_k:.4f} "
            f"torch={ms_p:.4f} (phase 2 cuda: {ms_single:.4f}); converging "
            f"iters multistep={ik} torch={ip} (T=1: {iters_t1}) "
            f"max|du|={cerr!r} wall {tck:.3f}s/{tcp:.3f}s")
        if not (umax > 0.0 and err <= TOL_GRID * umax and cerr <= TOL_GRID
                and int(rk.iters) == sweeps == int(rp.iters)
                and same_scalar(rk.reduced, rp.reduced, 0.0)
                and ik == ip and iters_t1 <= ik < iters_t1 + T
                and torch.isfinite(ck.a).all()):
            raise AssertionError(f"phase9 multistep T={T} mismatch")
        errs += [err, cerr]
        rows[T] = dict(ms_sweep=ms_k, torch_ms_sweep=ms_p, iters=ik,
                       solve_s=tck)
    return max(errs), rows


def restoration_stack(gen, lanes, h, w):
    """``lanes`` full-HD frames with salt-and-pepper noise at different
    densities (so restoration trip counts differ), their AMF masks and
    repaired initial guesses (detected on the kernel)."""
    import torch
    from repro_torch.kernels import ops
    yy, xx = torch.meshgrid(torch.arange(h, device="cuda"),
                            torch.arange(w, device="cuda"), indexing="ij")
    clean = (0.5 + 0.3 * torch.sin(xx / 20.0) * torch.cos(yy / 15.0)
             ).clamp(0, 1).float()
    levels = (0.02, 0.05, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6)[:lanes]
    noisy, masks, init = [], [], []
    for lvl in levels:
        imp = torch.rand((h, w), generator=gen, device="cuda") < lvl
        sp = (torch.rand((h, w), generator=gen, device="cuda") < 0.5).float()
        x = torch.where(imp, 1.0 - sp, clean)
        mk, rp = ops.adaptive_median_detect(x, backend="cuda", device="cuda")
        noisy.append(x)
        masks.append(mk)
        init.append(rp)
    return (torch.stack(noisy), torch.stack(masks), torch.stack(init),
            levels)


def phase10(gen):
    """farm_run at full width: 8 lanes of 1080x1920 restoration, on "cuda"
    and on "cuda-multistep" (T=3), each lane against its solo run on the
    same backend and against farm_run on "torch"; one launch per sweep (or
    per T sweeps) covers all 8 lanes."""
    import torch
    from repro_torch.core.pattern import LoopOfStencilReduce
    from repro_torch.kernels import ref as R
    from repro_torch.kernels import stencil2d as S
    lanes, h, w, tol = 8, 1080, 1920, 1e-4
    noisy, masks, init, levels = restoration_stack(gen, lanes, h, w)
    # one threshold for every lane (the condition sees one lane's reduce,
    # as in the reference): the summed change per noisy pixel of the
    # stack's mean count, so noisier frames take more sweeps
    thresh = tol * float(masks.sum((1, 2)).mean())

    def loop(backend, unroll):
        return LoopOfStencilReduce(
            f=R.restore_taps(2.0), k=1, combine="sum",
            cond=lambda r: r < thresh, delta=R.abs_delta,
            boundary="reflect", max_iters=64, unroll=unroll,
            backend=backend, device="cuda")

    rows = {}
    for backend, T, key in (("cuda", 1, "stencil_sweep"),
                            ("cuda-multistep", 3, "multistep_sweep")):
        loop(backend, T).farm_run(  # warm-up
            init[:2], env=(noisy[:2], masks[:2]))
        lp = loop(backend, T)
        before = S.launch_counts[key]
        res, tf = wall(lambda: lp.farm_run(init, env=(noisy, masks)))
        launched = S.launch_counts[key] - before
        iters = res.iters.tolist()
        solos, ts = [], 0.0
        for i in range(lanes):
            r, t = wall(lambda: loop(backend, T).run(
                init[i], env=(noisy[i], masks[i])))
            solos.append(r)
            ts += t
        ref, tt = wall(lambda: loop("torch", T).farm_run(
            init, env=(noisy, masks)))
        e_solo = max(max_err(res.a[i], solos[i].a) for i in range(lanes))
        e_torch = max_err(res.a, ref.a)
        checks = max(iters) // T
        want_launches = checks * (T if backend == "cuda" else 1)
        log(f"[phase10] farm_run {lanes}x{h}x{w} restoration on {backend} "
            f"(unroll {T}): noise {list(levels)} iters {iters} solo "
            f"{[int(r.iters) for r in solos]} torch {ref.iters.tolist()}; "
            f"max|d| vs solo {e_solo!r} vs torch {e_torch!r}; {key} "
            f"launches {launched} for {checks} checks (want "
            f"{want_launches}, each covering all {lanes} lanes); wall "
            f"farm {tf * 1e3:.2f} ms ({tf * 1e3 / lanes:.3f} ms/frame), "
            f"solo {ts * 1e3 / lanes:.3f} ms/frame, torch farm "
            f"{tt * 1e3:.2f} ms")
        if not (iters == [int(r.iters) for r in solos]
                == ref.iters.tolist() and len(set(iters)) > 1
                and e_solo <= TOL_GRID and e_torch <= TOL_GRID
                and launched == want_launches):
            raise AssertionError(f"phase10 farm_run on {backend} mismatch")
        rows[backend] = dict(ms_frame=tf * 1e3 / lanes,
                             solo_ms_frame=ts * 1e3 / lanes, iters=iters,
                             err=max(e_solo, e_torch))
    return rows


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
    err8, err8_bf16 = phase8(gen)
    zero_counts()                                  # main path: 2-4, 9, 10
    err2, ms_loop, _ = phase2(gen, SIZE, rate)
    err3 = phase3(gen, SIZE)
    err4 = phase4(gen)
    err9, rows9 = phase9(gen, SIZE, ms_loop)
    rows10 = phase10(gen)
    launches = dict(S.launch_counts)
    log(f"[main] launches on the main path (phases 2-4, 9, 10): {launches}")
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"the main path never launched {name}")
    ms_k, ms_p, bound_ms, bound_by, err5 = phase5(gen, SIZE, rate)
    rows5 = phase5_multistep(gen, SIZE, rate)
    log(json.dumps({"kernels": [{
        "name": "stencil_sweep",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/stencil2d.cu",
        "replaces": "src/repro/kernels/stencil2d.py:138",
        "launches": launches["stencil_sweep"],
        "max_abs_err": max(err2, err3, err4, err5, rows10["cuda"]["err"]),
        "ms": ms_k,
        "plain_ms": ms_p,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "bf16_max_abs_err": err8_bf16,
        "phases": {"launched": [2, 3, 4, 10],
                   "held_against_plain": [1, 2, 3, 4, 5, 8, 10]},
    }, {
        "name": "multistep_sweep",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/multistep.cu",
        "replaces": "src/repro/kernels/multistep.py:101",
        "launches": launches["multistep_sweep"],
        "max_abs_err": max([err8, err9, rows10["cuda-multistep"]["err"]]
                           + [r["err"] for r in rows5.values()]),
        "ms": rows5[4]["ms"],
        "plain_ms": rows5[4]["plain_ms"],
        "bound_ms": rows5[4]["bound_ms"],
        "bound_by": rows5[4]["bound_by"],
        "library_ms": None,
        "T": 4,
        "by_T": {T: {"ms_launch": r["ms"], "ms_sweep": r["ms_sweep"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "loop_ms_sweep": rows9[T]["ms_sweep"]}
                 for T, r in rows5.items()},
        "bf16_max_abs_err": err8_bf16,
        "phases": {"launched": [9, 10],
                   "held_against_plain": [5, 8, 9, 10]},
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
