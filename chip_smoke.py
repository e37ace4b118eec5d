#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``
(the stencil+reduce kernel of ``window.cuh`` behind its two entry points,
the single-step sweep and the temporal-blocking multistep sweep, and the
sliding-window flash attention: bf16 at hd 64/128/256 on the tensor
cores, the rest on CUDA cores), holds each against its plain
PyTorch version, and drives the port's main paths — the persistent-frame
Loop-of-stencil-reduce on "cuda" and "cuda-multistep", the lane farm
``farm_run``, the paper's §4 apps, the streaming FarmEngine on the §4.3
restoration stream, and the gemma2-9b scoring forward and greedy serving
— on one CUDA card at full size:

  0. the card (nvidia-smi), torch/CUDA versions, kernel build time,
     registers and spills of the stencil kernel's Helmholtz, Sobel and
     restore instantiations (a spill there fails the phase) and of every
     instantiation that spills;
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
     ms a frame of wall and of the device's busy time (profiler);
 14. the paper's §4.3 stream through the port's FarmEngine: 32 full-HD
     frames (noise 2%..60%), AMF detection as prep, restoration on 8 lane
     slots, segment 16 — round mode, continuous classic and chained on
     "cuda", chained on "cuda-multistep" (unroll="auto"), chained under a
     seeded FaultPlan (max_attempts 2), and chained with recovery, killed
     near the middle and resumed on 4 lanes; every index once in each
     run, iters / grids / reduces equal across the runs (bit for bit) and
     to solo runs; (c), (d) at its T and (e) against their plain twins on
     "torch" (the same prepped items and streams: statuses and iters
     equal, grids within TOL_GRID, (e)'s emission sequence equal; a
     planted zero-boundary fault fails that gate); the faults' statuses
     and attempts, each victim lane's slot retired, less waste than round
     mode, the slot buffers never re-allocated, one launch a body step; ms a frame (wall, and device busy for round and chained),
     lane steps, host bytes and reads, the recovery counters;
  5. per-kernel timings at the main path's shapes, each with its bound and
     the stencil kernel's launch choices (CTA tile, window slots, CTAs an
     SM, shared memory, registers); at 1080x1920 also the profiler's
     device time (the event timing there reads the host's issue rate);
 11. swa_attention vs plain on both routes (bf16 at hd 64/128/256 on the
     wgmma kernel, the rest on the CUDA-core one): the reference test's
     shapes (GQA, softcap, every head_dim) in f32 within 2e-5 (the share
     of the limit used printed) and their bf16 twins within one bf16 ulp,
     each call counted on its route;
     gemma2-9b's local and global layers at S=8192 on each route as the
     LM path gives them (bf16 on wgmma within one bf16 ulp, f32 on the
     CUDA cores within 2e-5), each with a planted fault (the band one kv
     tile off) held to the same limit and required to fail it; per route
     and layer the time a launch and TFLOP/s, the function's bound at
     the type's peak (bf16: also the split design's, P·V twice: 1.5x the
     tensor-core work), the plain version's time and a library call's
     (flex_attention); registers and spills of both kernels (a spill
     fails the phase); the CUDA-core kernel's launch (grid, heads and
     positions a CTA, warps an SM, shared memory, registers); then that
     kernel in f32 at every head_dim (hd 96 included) at the local
     layer's shape, each held against the plain version and timed;
 12. gemma2-9b at full width and depth in bf16, B=1, S=8192: the scoring
     forward on the kernel route (42 launches a forward) and on the einsum
     route, lm_loss, max|dlogits| and top-1 agreement gated; then in f32
     at depth 2 (TF32 off), the routes' logits and loss within tight
     bounds; at both sizes the gates must fail a planted fault (every
     local window one kv tile wider on the kernel route);
 13. greedy serving of gemma2-9b in bf16: B=2 prompts of 4576 tokens, 32
     new tokens, ring caches on the local layers; two runs identical, and
     the teacher-forced forward's argmax against the tokens (exact in f32
     at depth 2); then the ``kernels`` line;
  6. torch.profiler breakdown of the kernel loops (three runs on "cuda",
     one on "cuda-multistep" at T=4): device time by kernel and the
     device's idle share;
  7. the stencil kernel's time for a range of its own CTA tiles and
     window slots (Helmholtz at T = 1, 4, 8; AMF k=3 and restore at
     1080x1920), the wrapper's choice marked.

Every phase runs, at the sizes above, in the order listed.  Phases 2-4, 9,
10 and 14 are the stencil main path: the kernel launch counts are zeroed
just before phase 2 and read just after phase 14 (the single-step
launches also by shape, the multistep launches by T).  Phases 12-13 are
the LM main path: the counts (the attention's by route) are zeroed just
before phase 12 and read just after phase 13; the bf16 layers must take the wgmma
route and the f32 ones the CUDA-core route, and each route is its own
entry of the ``kernels`` line.  Every phase's failure propagates: the
exit code is non-zero and the final ok line is not printed.  Without a
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
TOL_SWA_F32 = 2e-5     # attention kernel vs plain in float32 (the reference
                       # test's: online softmax over tiles vs dense softmax)
# bf16 at gemma2's shapes (S=8192): the outputs average thousands of keys
# and are ~0.02, so 3e-2 would pass a band off by a tile.  The kernel and
# the plain version round nearly the same float32 value to bf16 once, so
# they differ by at most one bf16 ulp (<= 2^-7 of the value) plus the
# float32 gap (~1e-6): rtol 1e-2 with atol 1e-4.  A planted fault (the band
# moved by one 128-key tile) must break this limit.
TOL_SWA_BF16_RTOL = 1e-2
TOL_SWA_BF16_ATOL = 1e-4
FAULT_SHIFT = 128      # planted fault: window widened by one kv tile
# bf16 gemma2-9b forward at full depth, kernel route vs einsum route (the
# einsum route rounds its scores and probabilities to bf16 where the kernel
# keeps float32).  The first full-depth runs read an lm_loss gap of 6.9e-6
# (relative), max|dlogits| 0.146 and top-1 agreement 0.9968; the limits
# leave room for that spread, no more.
TOL_LOSS_BF16 = 1e-4
TOL_LOGITS_BF16 = 0.5
MIN_TOP1_BF16 = 0.99
TOL_LOGITS_F32 = 1e-3  # f32 depth-2 forward, the two routes' logits (atol)
TOL_LOSS_F32 = 1e-5    # ... and their lm_loss (relative)
LM_ARCH = "gemma2-9b"  # phases 12-13: full width
LM_SEQ = 8192          # phase 12: the model's context
SERVE_PROMPT, SERVE_NEW = 4576, 32   # phase 13: max_seq 4608 > window 4096
# published H100 device-memory rates (NVIDIA data sheets), by part
MEM_RATE = {"PCIe": 2.0e12, "NVL": 3.9e12, "SXM": 3.35e12}
FP32_RATE = 67e12      # H100 SXM float32 outside the tensor cores
BF16_RATE = 989e12     # H100 SXM bf16 tensor cores, dense


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


def within(x, y, tol, atol=None) -> bool:
    """|x - y| <= atol + tol * |y| everywhere (atol defaults to tol),
    NaN == NaN."""
    import torch
    x, y = x.float(), y.float()
    atol = tol if atol is None else atol
    both = torch.isnan(x) & torch.isnan(y)
    ok = (x - y).abs() <= atol + tol * y.abs()
    return bool((ok | both).all())


def limit_use(x, y, rtol, atol) -> float:
    """max |x - y| / (atol + rtol |y|): the share of the limit used (above
    1 fails it)."""
    x, y = x.float(), y.float()
    return float(((x - y).abs() / (atol + rtol * y.abs())).max())


def zero_counts():
    from repro_torch.kernels import stencil2d as S
    from repro_torch.kernels import swa_attention as A
    for counts in (S.launch_counts, A.launch_counts):
        for key in counts:
            counts[key] = 0


def swa_launches() -> int:
    """swa_attention's launches on both routes."""
    from repro_torch.kernels import swa_attention as A
    return sum(A.launch_counts.values())


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
    storage = "bf16" if "nv_bfloat16" in mangled else "f32"
    if "swa_wgmma_kernel" in mangled:
        hd = mangled.split("swa_wgmma_kernel", 1)[1].split("Li", 1)[1] \
            .split("E", 1)[0]
        return f"swa_wgmma_kernel<bf16, hd={hd}>"
    if "swa_kernel" in mangled:
        hd = mangled.split("swa_kernel", 1)[1].split("Li", 1)[1] \
            .split("E", 1)[0]
        return f"swa_kernel<{storage}, hd={hd}>"
    kernel = "window_kernel"
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
    main_path = ("HelmholtzJacobi", "Sobel", "Restore")
    spilled = []
    for name, r, spill in entries:
        if spill:
            log(f"[phase0]   {short_name(name)}: {r} registers, {spill}")
        elif "window_kernel" in name and any(f in name for f in main_path):
            log(f"[phase0]   {short_name(name)}: {r} registers, no spills")
        if spill and "window_kernel" in name \
                and any(f in name for f in main_path):
            spilled.append(short_name(name))
    if spilled:
        raise AssertionError(f"phase0: main-path stencil instantiations "
                             f"spill: {spilled}")
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


def launch_note(info) -> str:
    """The last stencil launch's choices, as phases 5 and 7 print them."""
    sms = info["grid"] // max(1, info["ctas_per_sm"])
    return (f"tile {info['tm']}x{info['tn']} ring {info['ring']}, "
            f"{info['ctas_per_sm']} CTAs/SM x {sms} SMs, "
            f"{info['smem_bytes']} B smem/CTA, {info['registers']} "
            f"registers, {info['tiles']} tiles")


def device_us(fn, iters=20) -> float:
    """Device time of one call of ``fn`` (µs) from torch.profiler's kernel
    records: at 1080x1920 a launch is shorter than the host's cost of
    issuing it, so back-to-back event timing reads the host."""
    for _ in range(3):
        fn()
    _, busy, rows = profiled(lambda: [fn() for _ in range(iters)])
    return busy * 1e6 / iters


# AMF k=3 a cell: every level sorts its (2k+1)^2 window; the least work a
# comparison sort needs is n*log2(n) comparisons (n = 9, 25, 49), one
# operation each at the f32 CUDA-core rate
AMF3_OPS = sum(n * math.log2(n) for n in (9, 25, 49))


def phase5(gen, size, rate):
    """Device time of one sweep at the main path's shapes: the kernel, its
    plain version, the bound and the kernel's launch choices (tile, CTAs
    an SM, shared memory, registers).  Helmholtz at ``size`` and the
    restoration sweeps at 1080x1920 (there also the profiler's device
    time)."""
    import torch
    from repro_torch.core.frames import frame_env, frame_spec, make_frame
    from repro_torch.kernels import ref as R
    from repro_torch.kernels.stencil2d import (alloc_scratch, last_launch,
                                               stencil2d_fused_framed,
                                               stencil2d_fused_framed_ref)

    def sweep_times(f, m, n, boundary, combine, measure, n_env, iters,
                    profile=False):
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
        exact = bool(torch.equal(got[p:p + m, p:p + n],
                                 want[p:p + m, p:p + n]))
        rel = TOL_RED if combine == "sum" else 0.0
        if not (exact and same_scalar(red_k, red_p, rel)):
            raise AssertionError(f"phase5 {f.functor} kernel/plain "
                                 f"mismatch: {err!r} {red_k!r} {red_p!r}")
        del got, want

        def run():
            return stencil2d_fused_framed(frame, f, spec, scratch=scratch,
                                          out=out, **kw)
        ms_k = cuda_ms(run, iters=iters)
        info = last_launch()
        dev = device_us(run) if profile else None
        ms_p = cuda_ms(lambda: stencil2d_fused_framed_ref(
            frame, f, spec, out=out, **kw), iters=max(iters // 4, 2),
            warmup=1)
        del frame, out, env
        torch.cuda.empty_cache()
        return dict(ms=ms_k, plain_ms=ms_p, err=err, info=info,
                    device_us=dev)

    def bound(cells, n_fields, ops):
        """(ms, by): each field read once and the frame written once, or
        the operations at the f32 rate, whichever is longer."""
        t_bytes = (n_fields + 1) * cells * 4 / rate
        t_ops = ops * cells / FP32_RATE
        return max(t_bytes, t_ops) * 1e3, \
            "bytes" if t_bytes >= t_ops else "operations"

    rows = {}
    r = sweep_times(R.helmholtz_jacobi_taps(0.5, 1 / 512), size, size,
                    "zero", "max", R.abs_delta, 1, 50)
    r["bound_ms"], r["bound_by"] = bound(size * size, 2, 10)  # 10 flops
    rows["helmholtz"] = r
    log(f"[phase5] stencil_sweep helmholtz {size}x{size}: kernel "
        f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
        f"{r['bound_ms']:.4f} ms ({r['bound_by']}; 3 x {size}^2 x 4 B), "
        f"{3 * size * size * 4 / (r['ms'] * 1e-3) / 1e9:.0f} GB/s, "
        f"max_abs_err vs plain {r['err']!r}; {launch_note(r['info'])}")
    for label, f, b, comb, meas, n_env, ops in [
            ("sobel", R.sobel_taps(), "reflect", "max", None, 0, 21),
            ("amf_mask k=3", R.amf_detect_taps(3)[0], "reflect", "sum",
             None, 0, AMF3_OPS),
            ("amf_repl k=3", R.amf_detect_taps(3)[1], "reflect", "sum",
             None, 0, AMF3_OPS),
            ("restore", R.restore_taps(2.0), "reflect", "sum", R.abs_delta,
             2, 20)]:
        r = sweep_times(f, 1080, 1920, b, comb, meas, n_env, 20,
                        profile=True)
        r["bound_ms"], r["bound_by"] = bound(1080 * 1920, 1 + n_env, ops)
        rows[label] = r
        log(f"[phase5] stencil_sweep {label} 1080x1920: kernel "
            f"{r['ms']:.4f} ms (device {r['device_us']:.2f} us), plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}: {1 + n_env} fields read + 1 written, or "
            f"{ops:.1f} operations a cell), max_abs_err vs plain "
            f"{r['err']!r}; {launch_note(r['info'])}")
    return rows


def phase5_multistep(gen, size, rate):
    """Device time of one multistep launch (T fused sweeps) at the main
    path's shape for T in {2, 4, 8}: the kernel, its plain version, the
    bound and the kernel's launch choices."""
    import torch
    from repro_torch.core.frames import frame_env, frame_spec, make_frame
    from repro_torch.kernels import ref as R
    from repro_torch.kernels.multistep import (stencil2d_multistep_framed,
                                               stencil2d_multistep_framed_ref)
    from repro_torch.kernels.stencil2d import alloc_scratch, last_launch
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
        info = last_launch()
        ms_p = cuda_ms(lambda: stencil2d_multistep_framed_ref(
            frame, f, spec, out=out, **kw), iters=3, warmup=1)
        # least work: the frame and the env field read once, the frame
        # written once; T sweeps of 10 flops a cell
        nbytes, flops = 3 * cells * 4, 10 * cells * T
        bound_ms = max(nbytes / rate, flops / FP32_RATE) * 1e3
        bound_by = "bytes" if nbytes / rate >= flops / FP32_RATE \
            else "operations"
        # the kernel's own traffic: each tile reads its (tm+2T)(tn+2T)
        # window of both fields and writes its tile
        tm, tn = info["tm"], info["tn"]
        win = (1 + 2 * T / tm) * (1 + 2 * T / tn)
        design_ms = (win * 2 * 4 + 4) * cells / rate * 1e3
        log(f"[phase5] multistep_sweep helmholtz {size}x{size} T={T}: "
            f"kernel {ms_k:.4f} ms/launch = {ms_k / T:.4f} ms/sweep, plain "
            f"{ms_p:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), window "
            f"traffic {design_ms:.4f} ms at the HBM rate, "
            f"{nbytes / (ms_k * 1e-3) / 1e9:.0f} GB/s of least bytes, "
            f"max_abs_err vs plain {err!r}; {launch_note(info)}")
        rows[T] = dict(ms=ms_k, ms_sweep=ms_k / T, plain_ms=ms_p,
                       bound_ms=bound_ms, bound_by=bound_by,
                       window_ms=design_ms, err=err, info=info)
        del frame, out, env
        torch.cuda.empty_cache()
    return rows


def profiled(fn):
    """Run ``fn`` under torch.profiler: (wall seconds, device-busy seconds,
    [(device µs, count, kernel name)] sorted by time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, secs = wall(fn)
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
    return secs, sum(r[0] for r in rows) * 1e-6, rows


def phase6(gen, size, runs=3):
    """Where a check's time goes in the kernel loops — device time by
    kernel name and the device's busy share, from torch.profiler over 48
    sweeps of the Helmholtz loop: ``runs`` times on "cuda", once on
    "cuda-multistep" at T=4."""
    import torch
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
        secs, busy, rows = profiled(lambda: helmholtz_loop(
            u0, fxy, max_iters=sweeps, backend=backend, unroll=T, **kw))
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
    """The kernel's time for a range of its own CTA tiles (and window
    slots) on the frame's default block: the Helmholtz sweep at ``size``
    on both kernels (T = 1, 4, 8; bound by bytes, then operations) and the
    restoration sweeps at 1080x1920 (AMF k=3 is bound by operations).  The
    wrapper's choice is marked."""
    import torch
    from repro_torch.core.frames import frame_env, frame_spec, make_frame
    from repro_torch.kernels import ref as R
    from repro_torch.kernels.multistep import stencil2d_multistep_framed
    from repro_torch.kernels.stencil2d import (alloc_scratch, last_launch,
                                               stencil2d_fused_framed)
    helm = R.helmholtz_jacobi_taps(0.5, 1 / 512)
    wide = [(32, 64, 2), (64, 64, 2), (16, 128, 2), (32, 128, 2),
            (32, 128, 1), (64, 64, 1), (64, 128, 1)]
    cases = [("helmholtz", helm, size, size, "zero", "max", R.abs_delta, 1,
              1, wide),
             ("helmholtz", helm, size, size, "zero", "max", R.abs_delta, 1,
              4, wide),
             ("helmholtz", helm, size, size, "zero", "max", R.abs_delta, 1,
              8, [(32, 64, 2), (16, 128, 2), (32, 64, 1), (64, 64, 1),
                  (32, 128, 1), (64, 128, 1)]),
             ("amf_mask k=3", R.amf_detect_taps(3)[0], 1080, 1920,
              "reflect", "sum", None, 0, 1,
              [(8, 32, 2), (16, 32, 2), (32, 32, 2), (8, 64, 2),
               (32, 64, 2)]),
             ("restore", R.restore_taps(2.0), 1080, 1920, "reflect", "sum",
              R.abs_delta, 2, 1,
              [(8, 32, 2), (16, 64, 2), (32, 64, 2), (16, 128, 2),
               (32, 128, 2), (32, 128, 1)])]
    for label, f, m, n, b, comb, meas, n_env, T, tiles in cases:
        a = torch.rand((m, n), generator=gen, device="cuda")
        es = [torch.rand((m, n), generator=gen, device="cuda")
              for _ in range(n_env)]
        spec = frame_spec(m, n, k=f.k, sweeps=T)
        frame = make_frame(a, spec, b)
        out = torch.empty_like(frame)
        env = tuple(frame_env(e, spec, b, halo=T > 1) for e in es)
        scratch = alloc_scratch(spec, "cuda")
        kw = dict(env_framed=env, combine=comb, measure=meas, out=out,
                  scratch=scratch)
        if T > 1:
            kw.update(T=T, boundary=b)

        def run(tile):
            if T > 1:
                return stencil2d_multistep_framed(frame, f, spec, tile=tile,
                                                  **kw)
            return stencil2d_fused_framed(frame, f, spec, tile=tile, **kw)
        run(None)
        chosen = last_launch()
        chosen = (chosen["tm"], chosen["tn"], chosen["ring"])
        for tile in [chosen] + [t for t in tiles if t != chosen]:
            try:
                ms = cuda_ms(lambda: run(tile), iters=20)
            except ValueError as e:      # the window does not fit
                log(f"[phase7] {label} {m}x{n} T={T} tile {tile}: {e}")
                continue
            info = last_launch()
            gbs = (2 + n_env) * m * n * 4 / (ms * 1e-3) / 1e9
            log(f"[phase7] {label} {m}x{n} T={T} tile {tile[0]}x{tile[1]} "
                f"ring {tile[2]}{' (chosen)' if tile == chosen else ''}: "
                f"{ms:.4f} ms/launch, {gbs:.0f} GB/s of least bytes "
                f"({gbs * 1e9 / rate:.3f} of peak); {launch_note(info)}")
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
    from repro_torch.kernels import stencil2d as S
    u0 = torch.zeros((size, size), device="cuda")
    fxy = torch.randn((size, size), generator=gen, device="cuda")
    fixed = dict(alpha=0.5, dx=1.0 / 512, tol=0.0, cond=lambda r: False)
    conv = dict(alpha=2.0, dx=0.2, tol=1e-5, max_iters=2000)
    iters_t1 = int(helmholtz_loop(u0, fxy, backend="cuda", **conv).iters)
    sweeps, errs, rows = 200, [], {}
    for T in (2, 4, 8):
        before = S.launch_counts["multistep_sweep"]
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
                       solve_s=tck, launches=S.launch_counts[
                           "multistep_sweep"] - before)
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
        first = S.launch_counts[key]
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
        # the device's share of a farm run: the wall above is mostly the
        # host's loop (launch, ghost refresh, one flag read a check)
        _, busy, _ = profiled(lambda: lp.farm_run(init, env=(noisy, masks)))
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
            f"farm {tf * 1e3:.2f} ms ({tf * 1e3 / lanes:.3f} ms/frame; "
            f"device busy {busy * 1e3 / lanes:.3f} ms/frame), "
            f"solo {ts * 1e3 / lanes:.3f} ms/frame, torch farm "
            f"{tt * 1e3:.2f} ms")
        if not (iters == [int(r.iters) for r in solos]
                == ref.iters.tolist() and len(set(iters)) > 1
                and e_solo <= TOL_GRID and e_torch <= TOL_GRID
                and launched == want_launches):
            raise AssertionError(f"phase10 farm_run on {backend} mismatch")
        rows[backend] = dict(ms_frame=tf * 1e3 / lanes,
                             device_ms_frame=busy * 1e3 / lanes,
                             solo_ms_frame=ts * 1e3 / lanes, iters=iters,
                             err=max(e_solo, e_torch), unroll=T,
                             launches=S.launch_counts[key] - first)
    return rows


# ---------------------------------------------------------------------------
# phase 14: the §4.3 restoration stream through the streaming FarmEngine
# ---------------------------------------------------------------------------

STREAM_SHAPE = (1080, 1920)
STREAM_FRAMES, STREAM_LANES, STREAM_SEGMENT = 32, 8, 16
STREAM_NOISE = (0.02, 0.6)     # salt-and-pepper density, first to last frame


def stream_source(seed, shape, frames):
    """The stream: ``synth_video`` frames with noise from 2% to 60%, made
    on the host with numpy from ``seed`` (re-iterable, for the resume)."""
    import numpy as np
    from repro_torch.examples.video_restoration import synth_video
    levels = np.linspace(*STREAM_NOISE, frames)
    pairs = list(synth_video(shape, frames, levels, seed=seed))
    return [c for c, _ in pairs], [n for _, n in pairs], levels


def phase14(seed, shape=STREAM_SHAPE, frames=STREAM_FRAMES,
            lanes=STREAM_LANES, segment=STREAM_SEGMENT, device="cuda"):
    """The §4.3 stream, pipe(read, detect, ofarm(restore), write), through
    the port's FarmEngine: AMF detection (kmax 3) as ``prep`` on the
    kernel, restoration on 8 lane slots, segment 16.  Runs (a) round mode,
    (b) continuous classic, (c) continuous chained, all on "cuda"; (d)
    chained on "cuda-multistep" with unroll="auto"; (e) (c) under a seeded
    FaultPlan with max_attempts=2; (f) (c) with recovery, preempted near
    the middle and resumed by a fresh engine with 4 lanes.  (c), (d) and
    (e) are held against their plain twins: the same prepped items through
    the same streams with the restoration on "torch" (at (d)'s T for (d)),
    and a planted fault shows the gate's power.  Every check of the phase
    raises on failure."""
    import dataclasses
    import shutil
    import tempfile

    import numpy as np
    import torch
    from repro_torch.core.reduce import Sentinel
    from repro_torch.core.streaming import FarmEngine
    from repro_torch.examples.video_restoration import (detector, psnr,
                                                        restore_loop)
    from repro_torch.kernels import stencil2d as S
    from repro_torch.resilience import (FaultPlan, PreemptionError,
                                        RecoveryConfig)

    ms0 = S.launch_counts["multistep_sweep"]
    cleans, noisy, levels = stream_source(seed, shape, frames)
    detect = detector("cuda", device)
    prep_launches = [0]

    def prep(frame):
        before = S.launch_counts["stencil_sweep"]
        out = detect(frame)
        prep_launches[0] += S.launch_counts["stencil_sweep"] - before
        return out

    sentinel = Sentinel(nan=True)       # a NaN reduce poisons its lane

    def engine(backend="cuda", unroll=1, n=lanes, plan=None, prep=prep,
               **kw):
        loop = restore_loop(backend, device, unroll=unroll,
                            sentinel=sentinel)
        if plan is not None:
            loop = plan.instrument(loop)
        return FarmEngine(loop, lanes=n, prep=prep, segment=segment,
                          device=device, **kw)

    def run(eng, continuous=True, source=None, **kw):
        got = []
        secs = wall(lambda: eng.run(noisy if source is None else source,
                                    got.append, continuous=continuous,
                                    **kw))[1]
        if sorted(int(r.index) if continuous else i
                  for i, r in enumerate(got)) != list(range(frames)):
            raise AssertionError("phase14: a stream index was not emitted "
                                 "exactly once")
        # (the plain "torch" carry is replaced each step, not ping-ponged)
        if eng.loop.backend != "torch" and \
                eng.buffer_pointers() != eng.bound_pointers:
            raise AssertionError("phase14: a slot buffer was re-allocated "
                                 "during the stream")
        return got, secs

    def by_index(got):
        return {int(r.index): r for r in got}

    # warm-up, one whole stream in each mode: the kernels' first launches
    # at these shapes and the allocator's first blocks for the uploads
    for mode in (False, True):
        FarmEngine(restore_loop("cuda", device), lanes=lanes, prep=detect,
                   segment=segment, device=device).run(
            noisy, lambda r: None, continuous=mode)

    rows = {}
    eng_a = engine()
    got_a, t_a = run(eng_a, continuous=False)
    res = {"a": {i: r for i, r in enumerate(got_a)}}
    eng_b = engine(chained=False)
    got_b, t_b = run(eng_b)
    res["b"] = by_index(got_b)
    eng_c = engine()
    before, prep_launches[0] = S.launch_counts["stencil_sweep"], 0
    got_c, t_c = run(eng_c)
    detect_launches = prep_launches[0]
    restore_launches = (S.launch_counts["stencil_sweep"] - before
                        - detect_launches)
    res["c"] = by_index(got_c)
    eng_d = engine("cuda-multistep", unroll="auto")
    got_d, t_d = run(eng_d)
    T = eng_d._loop.unroll
    res["d"] = by_index(got_d)

    # each frame's prepped item (detection on the kernel), once, on the
    # card: the solo runs and the plain twins start from these
    prepped = []
    for x in noisy:
        a0, envs = detect(torch.as_tensor(x, device=device))
        prepped.append((a0, *envs))

    # solo runs of the same prepped items, on each kernel
    solo = {}
    for backend, unroll in (("cuda", 1), ("cuda-multistep", T)):
        loop = restore_loop(backend, device, unroll=unroll,
                            sentinel=sentinel)
        solo[backend] = []
        for a0, *envs in prepped:
            r = loop.run(a0, env=tuple(envs))
            solo[backend].append((int(r.iters), r.a.cpu()))

    # (e): (c) under a seeded fault plan
    plan = FaultPlan.seeded(seed, lanes=lanes, n_nan=1, n_stall=1,
                            n_corrupt=2, n_items=frames)
    eng_e = engine(plan=plan, max_attempts=2)
    got_e, t_e = run(eng_e, source=plan.corrupt_stream(noisy))
    res["e"] = by_index(got_e)

    # the plain twins of (c), (d) and (e): the prepped items as tuple
    # items (the default prep splits them) through the same streams, the
    # restoration on "torch" (no kernel launch), at (d)'s T for (d)
    plain, t_plain, eng_plain = {}, {}, {}
    for key, kw, src in (
            ("c", {}, prepped), ("d", dict(unroll=T), prepped),
            ("e", dict(plan=plan, max_attempts=2),
             plan.corrupt_stream(prepped))):
        eng_plain[key] = engine("torch", prep=None, **kw)
        plain[key], t_plain[key] = run(eng_plain[key], source=src)

    # the gate's power: a planted ghost-ring fault (the zero boundary in
    # place of reflect) on the stream's noisiest item, run solo on
    # "torch" at each T, must fail the gate the kernels pass
    j = frames - 1
    planted = {}
    for key, unroll in (("c", 1), ("d", T)):
        bad_loop = dataclasses.replace(
            restore_loop("torch", device, unroll=unroll, sentinel=sentinel),
            boundary="zero")
        a0, *envs = prepped[j]
        f = bad_loop.run(a0, env=tuple(envs))
        planted[key] = (int(f.iters), max_err(res[key][j].a, f.a.cpu()))

    # (f): (c) with recovery, killed near the middle, resumed on 4 lanes
    tmp = tempfile.mkdtemp(prefix="phase14_recovery_")
    try:
        rec = RecoveryConfig(tmp, snapshot_every=2)
        kill_at = max(2, eng_c.stats["segments"] // 2)
        eng_f0 = engine()
        got_f0 = []
        t_f0 = time.perf_counter()
        try:
            eng_f0.run(noisy, got_f0.append, continuous=True, recovery=rec,
                       on_segment=FaultPlan(
                           lanes=lanes, preempt_at_segment=kill_at
                       ).preempt_hook(mode="raise"))
            raise AssertionError("phase14: the seeded preemption never "
                                 "fired")
        except PreemptionError:
            t_f0 = time.perf_counter() - t_f0
        eng_f = engine(n=4)
        got_f, t_f = run(eng_f, recovery=rec, resume=True)
        res["f"] = by_index(got_f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # the spread of (a) and (c): fresh engines in turns, a c c a
    spread = {"a": [], "c": []}
    for key in "acca":
        secs = wall(lambda: engine().run(noisy, lambda r: None,
                                         continuous=key == "c"))[1]
        spread[key].append(secs * 1e3 / frames)

    # device-busy time of (a) and (c), each in a run of its own
    busy = {}
    for key, continuous in (("a", False), ("c", True)):
        secs, dev_s, _ = profiled(lambda: engine().run(
            noisy, lambda r: None, continuous=continuous))
        busy[key] = (secs, dev_s)

    # --- checks ------------------------------------------------------------
    fails = []
    iters = {k: [int(res[k][i].iters) for i in range(frames)]
             for k in "abcf"}
    solo_iters = [it for it, _ in solo["cuda"]]
    if not (iters["a"] == iters["b"] == iters["c"] == iters["f"]
            == solo_iters):
        fails.append(f"iters differ: {iters} solo {solo_iters}")
    if len(set(solo_iters)) < 2:
        fails.append("the stream's trip counts do not spread")
    err_solo = 0.0
    for i in range(frames):
        c = res["c"][i]
        for k in "abf":
            if not (torch.equal(res[k][i].a, c.a)
                    and torch.equal(res[k][i].reduced, c.reduced)):
                fails.append(f"item {i}: run ({k}) differs from (c)")
        err_solo = max(err_solo, max_err(c.a, solo["cuda"][i][1]))
    if err_solo > TOL_GRID:
        fails.append(f"(c) vs solo runs: max|d| {err_solo!r} > {TOL_GRID}")
    if [int(r.index) for r in got_b] != [int(r.index) for r in got_c]:
        fails.append("(b) and (c) emit in different orders")
    iters_d = [int(res["d"][i].iters) for i in range(frames)]
    err_d = max(max_err(res["d"][i].a, solo["cuda-multistep"][i][1])
                for i in range(frames))
    if iters_d != [it for it, _ in solo["cuda-multistep"]] \
            or any(it % T for it in iters_d) or err_d > TOL_GRID:
        fails.append(f"(d) at T={T}: iters {iters_d} vs solo, max|d| "
                     f"{err_d!r}")
    # kernel against plain: the same statuses and iters, item for item, and
    # grids and reduces within TOL_GRID; (e) and its twin emit the same
    # (index, status, attempts, iters) sequence
    def seq(got):
        return [(int(r.index), r.status, int(r.attempts), int(r.iters))
                for r in got]
    err_plain = {}
    for key in "cde":
        p = by_index(plain[key])
        err_plain[key] = 0.0
        for i in range(frames):
            k, q = res[key][i], p[i]
            if (k.status, int(k.iters)) != (q.status, int(q.iters)):
                fails.append(f"({key}) item {i}: {k.status}/{int(k.iters)} "
                             f"on the kernel, {q.status}/{int(q.iters)} "
                             "on torch")
            elif k.a is not None:
                err_plain[key] = max(err_plain[key], max_err(k.a, q.a),
                                     max_err(k.reduced, q.reduced))
        if err_plain[key] > TOL_GRID:
            fails.append(f"({key}) vs its plain twin: max|d| "
                         f"{err_plain[key]!r} > {TOL_GRID}")
    fault_keys = ("retries", "rejected", "quarantined_slots", "refills",
                  "segments")
    if seq(got_e) != seq(plain["e"]) or \
            [eng_e.stats[k] for k in fault_keys] != \
            [eng_plain["e"].stats[k] for k in fault_keys]:
        fails.append("(e) and its plain twin emit different sequences or "
                     f"counts ({fault_keys})")
    for key, (it_f, e_f) in planted.items():
        if it_f == int(res[key][j].iters) and e_f <= TOL_GRID:
            fails.append(f"({key}): the planted fault passes the gate "
                         f"(max|d| {e_f!r})")
    # (e): the plan's corrupt items are rejected at the door; a first
    # attempt that failed was retried once; an ok item equals (c) bit for
    # bit; a non-ok item used both attempts and is on the dead-letter list
    # (a fault's status, or the status (c) gave the item itself)
    bad = set(plan.corrupt_indices)
    for i in range(frames):
        e, c = res["e"][i], res["c"][i]
        if i in bad:
            ok = (e.status, e.attempts, e.a) == ("rejected", 0, None)
        elif e.status == "ok":
            ok = (c.status == "ok" and e.attempts in (1, 2)
                  and int(e.iters) == int(c.iters)
                  and torch.equal(e.a, c.a)
                  and torch.equal(e.reduced, c.reduced))
        else:
            ok = e.attempts == 2 and (
                e.status in ("poisoned", "timed_out")
                or e.status == c.status)
        if not ok:
            fails.append(f"(e) item {i}: {e.status}/{e.attempts} vs (c) "
                         f"{c.status}")
    dead = sorted(int(r.index) for r in eng_e.dead_letter)
    if dead != sorted(i for i in range(frames)
                      if res["e"][i].status != "ok"):
        fails.append(f"(e) dead letters {dead}")
    # the plan fired: each victim lane's slot retired, and more retries
    # than the fault-free stream's own non-ok items would cause
    victims = {lane for lane, _ in (*plan.nan_events, *plan.stall_events)}
    own_fails = sum(1 for i in range(frames)
                    if i not in bad and res["c"][i].status != "ok")
    if eng_e.stats["retries"] <= own_fails \
            or eng_e.stats["rejected"] != len(bad) \
            or eng_e.stats["quarantined_slots"] != len(victims):
        fails.append(f"(e) retries {eng_e.stats['retries']} (fault-free "
                     f"{own_fails}) rejected {eng_e.stats['rejected']} "
                     f"quarantined slots "
                     f"{eng_e.stats['quarantined_slots']} (victim lanes "
                     f"{sorted(victims)})")
    if not eng_c.wasted_lane_steps < eng_a.wasted_lane_steps:
        fails.append(f"(c) wastes {eng_c.wasted_lane_steps} lane steps, "
                     f"(a) {eng_a.wasted_lane_steps}")
    body_steps = eng_c.lane_steps // lanes
    if restore_launches != body_steps:
        fails.append(f"(c): {restore_launches} restoration launches for "
                     f"{body_steps} body steps")
    if eng_f.stats["replayed_items"] != len(got_f0) \
            or eng_f.stats["recovered_occupants"] == 0:
        fails.append(f"(f) replayed {eng_f.stats['replayed_items']} of "
                     f"{len(got_f0)}, recovered "
                     f"{eng_f.stats['recovered_occupants']}")

    # --- readings ----------------------------------------------------------
    engines = {"a": (eng_a, t_a), "b": (eng_b, t_b), "c": (eng_c, t_c),
               "d": (eng_d, t_d), "e": (eng_e, t_e), "f": (eng_f, t_f)}
    names = {"a": "round", "b": "classic", "c": "chained",
             "d": f"chained cuda-multistep T={T}", "e": "chained + faults",
             "f": "chained with recovery, the resumed run on 4 lanes"}
    ps_in = float(np.mean([psnr(noisy[i], cleans[i])
                           for i in range(frames)]))
    ps_out = float(np.mean([psnr(res["c"][i].a.numpy(), cleans[i])
                            for i in range(frames)]))
    log(f"[phase14] stream: {frames} x {shape[0]}x{shape[1]} f32, noise "
        f"{levels[0]:.2f}..{levels[-1]:.2f}, {lanes} lanes, segment "
        f"{segment}; iters {solo_iters}; PSNR {ps_in:.2f} -> {ps_out:.2f} "
        f"dB; (d) resolved T={T}, iters {iters_d}")
    for key, (eng, secs) in engines.items():
        st = eng.stats
        seg = max(st["segments"], 1)
        log(f"[phase14] ({key}) {names[key]}: wall {secs * 1e3:.1f} ms "
            f"({secs * 1e3 / frames:.3f} ms/frame); rounds {st['rounds']} "
            f"segments {st['segments']} refills {st['refills']}; lane "
            f"steps {eng.lane_steps} wasted {eng.wasted_lane_steps} "
            f"quarantined {eng.quarantined_lane_steps}; h2d "
            f"{st['h2d_bytes'] / frames:.0f} B/item d2h "
            f"{st['d2h_bytes'] / frames:.0f} B/item; host reads "
            f"{st['host_reads']} ({st['host_reads'] / seg:.2f} a segment)")
    log(f"[phase14] (c) stencil_sweep launches: {restore_launches} "
        f"restoration (body steps {body_steps}, each covering all "
        f"{lanes} lanes) + {detect_launches} detection; (b) vs (c) order "
        f"equal; max|d| (c) vs solo {err_solo!r}, (d) vs its solo "
        f"{err_d!r}")
    log(f"[phase14] (e) plan {plan}: statuses "
        f"{[res['e'][i].status[:4] for i in range(frames)]} attempts "
        f"{[res['e'][i].attempts for i in range(frames)]}; retries "
        f"{eng_e.stats['retries']} rejected {eng_e.stats['rejected']} "
        f"quarantined slots {eng_e.stats['quarantined_slots']} dead "
        f"letters {dead}")
    log(f"[phase14] kernel vs plain twin (restoration on torch, the same "
        f"prepped items and streams): max|d| (c) {err_plain['c']!r}, (d) "
        f"T={T} {err_plain['d']!r}, (e) {err_plain['e']!r} (limit "
        f"{TOL_GRID}); statuses and iters equal item for item, (e)'s "
        f"emission sequence equal; twin wall "
        f"{', '.join(f'({k}) {t * 1e3:.1f} ms' for k, t in t_plain.items())}"
        f"; planted fault (zero boundary, item {j}): "
        + ", ".join(f"({k}) iters {it} vs {int(res[k][j].iters)}, max|d| "
                    f"{e!r}" for k, (it, e) in planted.items())
        + " -- fails the gate")
    log(f"[phase14] (a) and (c) again, fresh engines in turns a c c a: "
        f"round {[round(x, 3) for x in spread['a']]} ms/frame, chained "
        f"{[round(x, 3) for x in spread['c']]} ms/frame")
    st = eng_f.stats
    log(f"[phase14] (f) killed at segment {kill_at} after "
        f"{len(got_f0)} emissions in {t_f0 * 1e3:.1f} ms "
        f"({eng_f0.stats['snapshots']} snapshots); "
        f"resumed on 4 lanes: replayed {st['replayed_items']} recovered "
        f"occupants {st['recovered_occupants']} snapshots "
        f"{st['snapshots']} recovery {st['recovery_seconds'] * 1e3:.1f} ms, "
        f"segments {st['segments']}")
    for key, (secs, dev_s) in busy.items():
        log(f"[phase14] ({key}) {names[key]} under the profiler: wall "
            f"{secs * 1e3 / frames:.3f} ms/frame, device busy "
            f"{dev_s * 1e3 / frames:.3f} ms/frame (idle share "
            f"{1 - dev_s / secs:.3f})")
    if fails:
        raise AssertionError("phase14: " + "; ".join(fails))
    rows = {key: dict(ms_frame=secs * 1e3 / frames,
                      segments=eng.stats["segments"],
                      wasted=eng.wasted_lane_steps,
                      lane_steps=eng.lane_steps)
            for key, (eng, secs) in engines.items()}
    for key, times in spread.items():
        rows[key]["ms_frame_again"] = times
    for key, (secs, dev_s) in busy.items():
        rows[key]["device_ms_frame"] = dev_s * 1e3 / frames
    rows["T"] = T
    rows["err_plain"] = err_plain
    rows["multistep_launches"] = S.launch_counts["multistep_sweep"] - ms0
    return rows


# ---------------------------------------------------------------------------
# the LM slice: sliding-window attention, gemma2-9b forward and serving
# ---------------------------------------------------------------------------


def band_pairs(S: int, window: int) -> int:
    """(q, k) pairs inside the causal band of one head: what the kernel
    must compute for this shape."""
    if not window or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def swa_bounds(S, window, H, KH, hd, elem, B=1, rate=3.35e12):
    """(bound_ms, bound_by, split_ms): bytes of q, k, v read once and o
    written once, against 4·hd flops per visible (q, k) pair and head (two
    products, multiply and add) at the type's peak rate (bf16: tensor
    cores; f32: CUDA cores); and for bf16 the split design's bound, whose
    P·V runs twice (P_hi and P_lo): 6·hd flops a pair (None for f32)."""
    nbytes = B * (2 * H + 2 * KH) * S * hd * elem
    flops = 4 * hd * band_pairs(S, window) * H * B
    peak = BF16_RATE if elem == 2 else FP32_RATE
    t_bytes, t_ops = nbytes / rate, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations",
            max(t_bytes, 1.5 * flops / BF16_RATE) * 1e3 if elem == 2
            else None)


def library_attention(q, k, v, window, cap):
    """One PyTorch call for the same function, as a yardstick the port
    never uses: ``flex_attention`` (compiled) with the softcap as
    ``score_mod`` and the band as a block mask; if that fails, SDPA with a
    boolean band mask and no softcap.  Returns (fn, label, note)."""
    import torch
    import torch.nn.functional as F
    BH, S, hd = q.shape
    q4, k4, v4 = (t.reshape(1, t.shape[0], S, hd) for t in (q, k, v))

    def band(b, h, q_idx, kv_idx):
        ok = kv_idx <= q_idx
        if window:
            ok = ok & (kv_idx > q_idx - window)
        return ok

    try:
        from torch.nn.attention.flex_attention import (create_block_mask,
                                                       flex_attention)

        def capped(score, b, h, q_idx, kv_idx):
            return cap * torch.tanh(score / cap)
        bm = create_block_mask(band, B=None, H=None, Q_LEN=S, KV_LEN=S,
                               device="cuda")
        flex = torch.compile(flex_attention, dynamic=False)

        def fn():
            return flex(q4, k4, v4, score_mod=capped, block_mask=bm,
                        enable_gqa=True)
        out = fn().reshape(BH, S, hd)
        sync()
        return fn, "flex_attention", out
    except Exception as e:                        # noqa: BLE001
        note = f"flex_attention failed ({type(e).__name__}: {e})"[:300]
        log(f"[phase11] {note}; timing SDPA with a boolean band mask on "
            "the softcap-free function instead")
    qp = torch.arange(S, device="cuda")[:, None]
    kp = torch.arange(S, device="cuda")[None, :]
    mask = band(None, None, qp, kp)
    try:
        def fn():
            return F.scaled_dot_product_attention(q4, k4, v4,
                                                  attn_mask=mask,
                                                  enable_gqa=True)
        fn()
        sync()
        return fn, "sdpa (bool band mask, no softcap)", None
    except Exception as e:                        # noqa: BLE001
        log(f"[phase11] SDPA failed too ({type(e).__name__}: {e})"[:300])
        return None, "none", None


def phase11(gen, rate):
    """swa_attention's kernels vs its plain version: registers and spills
    of both routes; the reference test's shapes (plus GQA, softcap, every
    head_dim) in f32 and in bf16 (each on its route); gemma2-9b's local
    and global layers at S=8192 on both routes as the LM path runs them
    (bf16 on the wgmma kernel, f32 on the CUDA-core one; the plain version
    one kv head group at a time), with per-launch times, the bounds, the
    plain version's time and a library call's; then the CUDA-core kernel
    in f32 at every head_dim.  Returns ({route: {layer: row}}, {route:
    worst max_abs_err}, {head_dim: row})."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import swa_attention as A

    spills = []
    for name, r, spill in ptxas_entries(
            (_build.build_dir() / "build.log").read_text()):
        if "swa_kernel" in name or "swa_wgmma_kernel" in name:
            log(f"[phase11] {short_name(name)}: {r} registers, "
                f"{spill or 'no spills'}")
            if spill:
                spills.append(short_name(name))
    if spills:
        raise AssertionError(f"phase11: the SWA kernels spill: {spills}")

    # cases added after the LM phases' draws were fixed take their inputs
    # from a side generator, so phases 12-13 see the same inputs as before
    side = torch.Generator(device="cuda").manual_seed(gen.initial_seed() + 16)

    def rnd(rows, S, hd, dtype, g=gen):
        return torch.randn((rows, S, hd), generator=g, device="cuda") \
            .to(dtype)

    def launch(route, *args, **kw):
        before = dict(A.launch_counts)
        out = A.swa_attention(*args, **kw)
        if A.launch_counts[route] != before[route] + 1:
            raise AssertionError(f"phase11: a call missed the {route} "
                                 "route")
        return out

    cases = [
        # (B·H, B·KH, S, hd, window, causal, softcap)
        (2, 2, 256, 64, 0, True, 0.0), (2, 2, 256, 64, 128, True, 0.0),
        (1, 1, 512, 128, 256, True, 0.0), (2, 2, 128, 64, 0, False, 0.0),
        (1, 1, 256, 64, 64, True, 0.0), (1, 1, 384, 64, 200, True, 0.0),
        (8, 4, 256, 64, 128, True, 0.0), (2, 2, 256, 64, 128, True, 50.0),
        (2, 2, 256, 16, 8, True, 50.0), (2, 1, 256, 32, 0, True, 0.0),
        (4, 2, 1024, 256, 300, True, 50.0), (1, 1, 64, 64, 0, True, 0.0)]
    side_cases = [(4, 2, 256, 96, 100, True, 50.0)]
    lims = {torch.bfloat16: (TOL_SWA_BF16_RTOL, TOL_SWA_BF16_ATOL),
            torch.float32: (0.0, TOL_SWA_F32)}
    err = dict.fromkeys(A.launch_counts, 0.0)
    err_f32 = use_twin = 0.0
    twin_routes = dict.fromkeys(A.launch_counts, 0)
    for case in cases + side_cases:
        bh, bkh, S, hd, window, causal, cap = case
        kw = dict(window=window, causal=causal, softcap=cap)
        g = side if case in side_cases else gen
        q, k, v = (rnd(n, S, hd, torch.float32, g) for n in (bh, bkh, bkh))
        e = max_err(launch("cuda_core", q, k, v, **kw),
                    A.swa_attention_plain(q, k, v, **kw))
        err_f32 = max(err_f32, e)
        err["cuda_core"] = max(err["cuda_core"], e)
        if not e <= TOL_SWA_F32:
            raise AssertionError(
                f"phase11 swa_attention f32 "
                f"{(bh, bkh, S, hd, window, causal, cap)} kernel/plain "
                f"max_abs_err {e!r}")
        # the bf16 twin, on the route its head_dim takes
        q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
        route = A._route(torch.bfloat16, hd)
        got = launch(route, q, k, v, **kw)
        want = A.swa_attention_plain(q, k, v, **kw)
        twin_routes[route] += 1
        err[route] = max(err[route], max_err(got, want))
        use = limit_use(got, want, *lims[torch.bfloat16])
        use_twin = max(use_twin, use)
        if not within(got, want, *lims[torch.bfloat16]):
            raise AssertionError(
                f"phase11 swa_attention bf16 "
                f"{(bh, bkh, S, hd, window, causal, cap)} kernel/plain "
                f"outside one bf16 ulp (use {use!r})")
    log(f"[phase11] {len(cases) + len(side_cases)} f32 cases ok, worst max_abs_err vs plain "
        f"{err_f32!r} (tol {TOL_SWA_F32}: {err_f32 / TOL_SWA_F32:.4f} of the "
        f"limit); their bf16 twins ok "
        f"(routes {twin_routes}), {use_twin:.4f} of the one-ulp limit; "
        f"worst max_abs_err by route {err}")

    cfg_H, cfg_KH, hd, cap, W = 16, 8, 256, 50.0, 4096
    G = cfg_H // cfg_KH
    rows = {}
    # each route at the shapes the LM path gives it: bf16 at full depth on
    # the wgmma kernel, f32 at depth 2 on the CUDA-core one, on one draw
    # of bf16 inputs per layer (the f32 route takes them widened, so the
    # generator reaches phase 12 in the same state as before the f32
    # check was added).  Planted faults, launched on the same inputs: the
    # local band one kv tile wider, and the global layer with the first
    # kv tile dropped for the last q tile (window S - 128)
    for label, window, fault in (("local", W, W + FAULT_SHIFT),
                                 ("global", 0, LM_SEQ - FAULT_SHIFT)):
        qkv = (rnd(cfg_H, LM_SEQ, hd, torch.bfloat16),
               *(rnd(cfg_KH, LM_SEQ, hd, torch.bfloat16) for _ in range(2)))
        for dtype, tol_name in ((torch.bfloat16, "one bf16 ulp"),
                                (torch.float32, f"atol {TOL_SWA_F32}")):
            route, lim = A._route(dtype, hd), lims[dtype]
            elem = torch.tensor([], dtype=dtype).element_size()
            q, k, v = (t.to(dtype) for t in qkv)
            kw = dict(window=window, causal=True, softcap=cap)
            got = launch(route, q, k, v, **kw)
            bad = launch(route, q, k, v, **dict(kw, window=fault))
            e = use = use_bad = 0.0
            for g in range(cfg_KH):
                want = A.swa_attention_plain(q[g * G:(g + 1) * G],
                                             k[g:g + 1], v[g:g + 1], **kw)
                part = got[g * G:(g + 1) * G]
                e = max(e, max_err(part, want))
                use = max(use, limit_use(part, want, *lim))
                use_bad = max(use_bad,
                              limit_use(bad[g * G:(g + 1) * G], want, *lim))
                if not within(part, want, *lim):
                    raise AssertionError(
                        f"phase11 swa_attention {route} {label} group {g} "
                        f"kernel/plain mismatch (max_abs_err {e!r}, limit "
                        f"use {use!r})")
                del want, part
            rms = float(got.float().pow(2).mean().sqrt())
            del got, bad
            log(f"[phase11] {route} {label} limit ({tol_name}: rtol "
                f"{lim[0]}, atol {lim[1]}; output rms {rms:.4g}): kernel vs"
                f" plain uses {use:.4f} of it, the planted fault (window "
                f"{fault}) {use_bad:.4f}")
            if not use_bad > 1.0:
                raise AssertionError(
                    f"phase11 {route} {label}: the limit passes a planted "
                    f"fault (window {fault} for {window}; use {use_bad!r})")
            err[route] = max(err[route], e)
            ms = cuda_ms(lambda: A.swa_attention(q, k, v, **kw), iters=5,
                         warmup=1)
            info = A.last_launch() if route == "cuda_core" else None
            plain_ms = cuda_ms(lambda: A.swa_attention_plain(q, k, v, **kw),
                               iters=2, warmup=1)
            torch.cuda.empty_cache()
            fn, lib_label, lib_out = library_attention(q, k, v, window, cap)
            lib_ms = cuda_ms(fn, iters=5, warmup=1) if fn else None
            lib_err = None
            if lib_out is not None:
                lib_err = max_err(lib_out, A.swa_attention(q, k, v, **kw))
            del fn, lib_out
            torch.cuda.empty_cache()
            bound_ms, bound_by, split_ms = swa_bounds(
                LM_SEQ, window, cfg_H, cfg_KH, hd, elem, rate=rate)
            tflops = 4 * hd * band_pairs(LM_SEQ, window) * cfg_H \
                / (ms * 1e-3) / 1e12
            rows.setdefault(route, {})[label] = dict(
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, split_bound_ms=split_ms, tflops=tflops,
                library_ms=lib_ms, library=lib_label, err=e, limit_use=use,
                fault_limit_use=use_bad, launch=info)
            split = "" if split_ms is None else \
                f", split-design bound {split_ms:.4f} ms"
            peak = "bf16 tensor cores" if elem == 2 else "f32 CUDA cores"
            log(f"[phase11] swa_attention gemma2 {label} (H 16, KH 8, hd "
                f"256, S {LM_SEQ}, window {window}, softcap 50, {dtype}, "
                f"{route} route): kernel {ms:.4f} ms ({tflops:.2f} TFLOP/s),"
                f" plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
                f"({bound_by}, {peak}){split}, {lib_label} "
                f"{'n/a' if lib_ms is None else f'{lib_ms:.4f}'} ms"
                f"{'' if lib_err is None else f' (max_abs_err vs kernel {lib_err:.3g})'}"
                f", max_abs_err vs plain {e!r}"
                f"{'' if info is None else '; ' + swa_launch_note(info)}")
            del q, k, v
            torch.cuda.empty_cache()
        del qkv
    return rows, err, swa_core_by_hd(side, rate)


def swa_launch_note(info) -> str:
    return (f"grid {info['grid_x']}x{info['grid_y']} of {info['threads']} "
            f"threads ({info['heads_per_cta']} heads x {info['bq']} "
            f"positions a CTA, {info['bk']}-key tiles, {info['stages']} "
            f"ring slots), {info['ctas_per_sm']} CTA(s) = "
            f"{info['warps_per_sm']} warps an SM, {info['smem_bytes']} B "
            f"shared, {info['registers']} registers")


def swa_core_by_hd(gen, rate):
    """The CUDA-core kernel in float32 at every head_dim it takes, at
    gemma2's local layer otherwise (S=8192, 16/8 heads, window 4096,
    softcap 50), on inputs from ``gen`` (phase 11's side generator): held
    against the plain version on one kv head's group (2e-5), then timed,
    with its bound and launch facts."""
    import torch
    from repro_torch.kernels import swa_attention as A
    window, H, KH = 4096, 16, 8
    out = {}
    for hd in A.HEAD_DIMS:
        q, k, v = (torch.randn((n, LM_SEQ, hd), generator=gen, device="cuda")
                   for n in (H, KH, KH))
        kw = dict(window=window, causal=True, softcap=50.0)
        got = A.swa_attention(q, k, v, **kw)[:H // KH]
        e = max_err(got, A.swa_attention_plain(q[:H // KH], k[:1], v[:1],
                                               **kw))
        if not e <= TOL_SWA_F32:
            raise AssertionError(f"phase11 cuda_core f32 hd {hd} S {LM_SEQ}:"
                                 f" kernel/plain max_abs_err {e!r}")
        ms = cuda_ms(lambda: A.swa_attention(q, k, v, **kw), iters=3,
                     warmup=1)
        info = A.last_launch()
        bound_ms, bound_by, _ = swa_bounds(LM_SEQ, window, H, KH, hd, 4,
                                           rate=rate)
        tflops = 4 * hd * band_pairs(LM_SEQ, window) * H / (ms * 1e-3) / 1e12
        out[hd] = dict(ms=ms, tflops=tflops, bound_ms=bound_ms,
                       bound_by=bound_by, err=e, launch=info)
        log(f"[phase11] cuda_core f32 hd {hd} (S {LM_SEQ}, H 16, KH 8, "
            f"window {window}, softcap 50): {ms:.4f} ms ({tflops:.2f} "
            f"TFLOP/s), bound {bound_ms:.4f} ms ({bound_by}), max_abs_err "
            f"vs plain {e!r}; {swa_launch_note(info)}")
        del q, k, v, got
        torch.cuda.empty_cache()
    return out


def lm_model(cfg, gen):
    from repro_torch.models import transformer as T
    model = T.init_params(cfg, generator=gen, device="cuda")
    sync()
    return model


def forward_runs(cfg, model, batch, *, reps=2):
    """A warm-up forward, then ``reps`` timed ones; returns (the last
    logits, seconds per forward, swa launches per forward)."""
    from repro_torch.models import transformer as T
    launches, secs, logits = [], [], None
    for i in range(reps + 1):
        logits = None
        before = swa_launches()
        (logits, _), s = wall(lambda: T.forward(cfg, model, batch))
        launches.append(swa_launches() - before)
        if i:
            secs.append(s)
    return logits, sum(secs) / len(secs), launches


def route_gap(logits, loss, logits_e, loss_e):
    """The readings that hold one forward against the einsum route's."""
    return dict(loss_rel=abs(loss - loss_e) / abs(loss_e),
                max_dlogits=max_err(logits, logits_e),
                top1=float((logits.argmax(dim=-1) == logits_e.argmax(dim=-1))
                           .float().mean()))


def route_compare(cfg, model, batch):
    """Kernel route (the default on the card) against the einsum route:
    logits of both, their lm_loss, the time per forward and the launches
    per forward of each; then the kernel route with a planted fault (every
    local layer's window one kv tile wider), held against the einsum route
    in the same way."""
    import dataclasses
    import torch
    from repro_torch.models import attention as TA
    from repro_torch.models import transformer as T
    from repro_torch.train.objective import lm_loss
    logits_k, s_k, n_k = forward_runs(cfg, model, batch)
    loss_k = float(lm_loss(cfg, model, batch)[0])
    finite_k = bool(torch.isfinite(logits_k).all())
    TA.set_flash_swa(False)
    try:
        logits_e, s_e, n_e = forward_runs(cfg, model, batch, reps=1)
        loss_e = float(lm_loss(cfg, model, batch)[0])
    finally:
        TA.set_flash_swa(None)
    finite_e = bool(torch.isfinite(logits_e).all())
    gap = route_gap(logits_k, loss_k, logits_e, loss_e)
    del logits_k
    specs = model.specs
    model.specs = T.layer_specs(dataclasses.replace(
        cfg, sliding_window=cfg.sliding_window + FAULT_SHIFT))
    before = swa_launches()
    try:
        logits_f, _ = T.forward(cfg, model, batch)
        fault = route_gap(logits_f, float(lm_loss(cfg, model, batch)[0]),
                          logits_e, loss_e)
    finally:
        model.specs = specs
    fault["launches"] = swa_launches() - before
    del logits_f, logits_e
    torch.cuda.empty_cache()
    return dict(s_kernel=s_k, s_einsum=s_e, launches_kernel=n_k,
                launches_einsum=n_e, loss_kernel=loss_k, loss_einsum=loss_e,
                finite=finite_k and finite_e, fault=fault, **gap)


def phase12(gen, model, cfg, label):
    """The gemma2-9b scoring forward at full width on both routes."""
    import torch
    S = LM_SEQ
    V = cfg.vocab_size
    batch = {"tokens": torch.randint(0, V, (1, S), generator=gen,
                                     device="cuda"),
             "labels": torch.randint(0, V, (1, S), generator=gen,
                                     device="cuda")}
    r = route_compare(cfg, model, batch)
    n_attn = cfg.num_layers
    log(f"[phase12] {label}: kernel route {r['s_kernel']:.4f} s/forward "
        f"({S / r['s_kernel']:.0f} tokens/s), swa launches per forward "
        f"{r['launches_kernel']}; einsum route {r['s_einsum']:.4f} "
        f"s/forward ({S / r['s_einsum']:.0f} tokens/s), launches "
        f"{r['launches_einsum']}; lm_loss kernel {r['loss_kernel']!r} "
        f"einsum {r['loss_einsum']!r} (rel {r['loss_rel']:.3g}); "
        f"max|dlogits| {r['max_dlogits']:.4g}, top-1 agreement "
        f"{r['top1']:.5f}, finite {r['finite']}; planted fault (window "
        f"+{FAULT_SHIFT}) vs einsum: lm_loss rel {r['fault']['loss_rel']:.3g}"
        f", max|dlogits| {r['fault']['max_dlogits']:.4g}, top-1 "
        f"{r['fault']['top1']:.5f}")
    if not (all(n == n_attn for n in r["launches_kernel"])
            and all(n == 0 for n in r["launches_einsum"])):
        raise AssertionError(
            f"phase12 {label}: launches per forward {r['launches_kernel']} "
            f"(kernel route), {r['launches_einsum']} (einsum route); want "
            f"{n_attn} and 0")
    if not r["finite"]:
        raise AssertionError(f"phase12 {label}: non-finite logits")
    return r


def phase13(gen, model, cfg, label, cache_dtype):
    """Greedy serving at full width: B=2 prompts of SERVE_PROMPT tokens,
    SERVE_NEW new tokens (max_seq 4608 > the 4096 window: ring caches on
    the local layers), run twice, and the teacher-forced forward over
    prompt + tokens on the kernel route (4608 = 36·128)."""
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.serve import GenerateConfig, generate, prefill
    B, P, N = 2, SERVE_PROMPT, SERVE_NEW
    max_seq = P + N
    prompt = torch.randint(2, cfg.vocab_size, (B, P), generator=gen,
                           device="cuda")
    (_, caches), t_cold = wall(lambda: prefill(
        cfg, model, prompt, max_seq=max_seq, cache_dtype=cache_dtype))
    rings = sum("pos" in c for c in caches)
    del caches
    gcfg = GenerateConfig(max_new_tokens=N, eos_id=1)
    runs = []
    for _ in range(2):
        runs.append(wall(lambda: generate(cfg, model, prompt, gcfg,
                                          max_seq=max_seq,
                                          cache_dtype=cache_dtype)))
    (out, lengths, iters), t_gen = runs[0]
    (out2, lengths2, iters2), t_gen2 = runs[1]
    same = (torch.equal(out, out2) and torch.equal(lengths, lengths2)
            and int(iters) == int(iters2))
    before = swa_launches()
    full = torch.cat([prompt, out.long()], dim=1)
    logits, _ = T.forward(cfg, model, {"tokens": full})
    launched = swa_launches() - before
    exp = logits[:, P - 1:-1].argmax(dim=-1)
    del logits
    torch.cuda.empty_cache()
    hits = total = 0
    for b in range(B):
        L = int(lengths[b])
        hits += int((out[b, :L].long() == exp[b, :L]).sum())
        total += L
    agree = hits / total
    # the generate runs each paid a warm prefill: subtract one timed warm
    # (the first prefill above, t_cold, was the model's coldest)
    pre = [wall(lambda: prefill(cfg, model, prompt, max_seq=max_seq,
                                cache_dtype=cache_dtype)) for _ in range(2)]
    t_pre = sum(t for _, t in pre) / len(pre)
    (_, caches), _ = pre[-1]
    del pre
    t_gen_mean = (t_gen + t_gen2) / 2
    decode_ms = (t_gen_mean - t_pre) / max(int(iters), 1) * 1e3
    # decode steps on their own, after the prefill, under no_grad as in
    # generate: 16 timed twice, then 4 under the profiler to see where a
    # step's time goes
    @torch.no_grad()
    def decode(steps):
        for i in range(steps):
            T.decode_step(cfg, model, caches, out[:, i:i + 1], P + i)
    decode(4)                                          # warm-up
    step_ms = sum(wall(lambda: decode(16))[1] for _ in range(2)) / 32 * 1e3
    steps = 4
    secs, busy, rows = profiled(lambda: decode(steps))
    del caches
    torch.cuda.empty_cache()
    log(f"[phase13] {label}: {steps} decode steps under the profiler: wall "
        f"{secs / steps * 1e3:.3f} ms a step, device busy "
        f"{busy / steps * 1e3:.3f} ms (idle share {1 - busy / secs:.3f}), "
        f"{sum(r[1] for r in rows) / steps:.0f} kernels a step")
    for us, count, key in rows[:6]:
        log(f"[phase13]   {us / 1e3:9.3f} ms  x{count:<5d} {key[:90]}")
    log(f"[phase13] {label}: B={B} prompt {P} + {N} new, max_seq {max_seq},"
        f" {rings} ring-cache layers; prefill {t_pre:.4f} s (warm; the "
        f"first {t_cold:.4f} s), generate {t_gen:.4f} / {t_gen2:.4f} s, "
        f"iters {int(iters)}, decode {decode_ms:.3f} ms per step ((generate"
        f" - warm prefill) / iters), decode_step alone {step_ms:.3f} ms; "
        f"lengths {lengths.tolist()}; two runs identical {same}; "
        f"teacher-forced forward {launched} swa launches, greedy = argmax "
        f"on {hits}/{total} tokens ({agree:.4f})")
    if not same:
        raise AssertionError(f"phase13 {label}: two greedy runs differ")
    if launched != cfg.num_layers or rings != cfg.num_layers // 2:
        raise AssertionError(
            f"phase13 {label}: teacher-forced forward launched {launched} "
            f"kernels, {rings} ring caches")
    return dict(prefill_s=t_pre, generate_s=(t_gen, t_gen2),
                decode_ms=decode_ms, step_ms=step_ms, iters=int(iters),
                agree=agree,
                same=same, decode_idle=1 - busy / secs)


def lm_phases(gen):
    """Phases 12-13 (the main path of this slice): bf16 gemma2-9b at full
    width and depth, then the tight f32 gates at full width and depth 2."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    cfg = get_config(LM_ARCH)
    model = lm_model(cfg, gen)
    log(f"[phase12] {LM_ARCH} bf16: {cfg.num_layers} layers, d "
        f"{cfg.d_model}, {sum(p.numel() for p in model.parameters()) / 1e9:.3f}"
        f" B parameters, {torch.cuda.memory_allocated() / 1e9:.2f} GB")
    r12 = phase12(gen, model, cfg, "bf16 full depth")
    r13 = phase13(gen, model, cfg, "bf16 full depth", torch.bfloat16)
    del model
    torch.cuda.empty_cache()
    cfg2 = dataclasses.replace(cfg, num_layers=2, dtype="float32")
    model = lm_model(cfg2, gen)
    r12f = phase12(gen, model, cfg2, "f32 depth 2")
    r13f = phase13(gen, model, cfg2, "f32 depth 2", torch.float32)
    del model
    torch.cuda.empty_cache()
    # the routes' gates, each held against its planted fault too: a gate
    # that passes the fault cannot see a band off by one tile
    gates = {"bf16 full depth": (r12, lambda g: (
                 g["loss_rel"] <= TOL_LOSS_BF16
                 and g["max_dlogits"] <= TOL_LOGITS_BF16
                 and g["top1"] >= MIN_TOP1_BF16)),
             "f32 depth 2": (r12f, lambda g: (
                 g["loss_rel"] <= TOL_LOSS_F32
                 and g["max_dlogits"] <= TOL_LOGITS_F32))}
    for label, (r, passes) in gates.items():
        log(f"[phase12] {label}: routes pass the gates {passes(r)}, the "
            f"planted fault passes them {passes(r['fault'])}")
        if not passes(r):
            raise AssertionError(
                f"phase12 {label}: routes differ: lm_loss rel "
                f"{r['loss_rel']!r}, max|dlogits| {r['max_dlogits']!r}, "
                f"top-1 {r['top1']!r}")
        if passes(r["fault"]):
            raise AssertionError(
                f"phase12 {label}: the gates pass a planted fault "
                f"({r['fault']})")
    if r13f["agree"] != 1.0:
        raise AssertionError("phase13 f32: greedy tokens differ from the "
                             "teacher-forced argmax")
    return r12, r13, r12f, r13f


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
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 gates: true f32
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import stencil2d as S
    from repro_torch.kernels import swa_attention as A

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    card = phase0()
    rate = mem_rate(card.split(",")[0])
    phase1(gen)
    err8, err8_bf16 = phase8(gen)
    zero_counts()                              # main path: 2-4, 9, 10, 14
    by_phase = {}

    def counted(phase, fn, *a):
        """Run a main-path phase; note its stencil_sweep launches."""
        before = S.launch_counts["stencil_sweep"]
        out = fn(*a)
        by_phase[phase] = S.launch_counts["stencil_sweep"] - before
        return out
    err2, ms_loop, _ = counted(2, phase2, gen, SIZE, rate)
    err3 = counted(3, phase3, gen, SIZE)
    err4 = counted(4, phase4, gen)
    err9, rows9 = counted(9, phase9, gen, SIZE, ms_loop)
    rows10 = counted(10, phase10, gen)
    rows14 = counted(14, phase14, args.seed)
    launches = dict(S.launch_counts)
    log(f"[main] launches on the main path (phases 2-4, 9, 10, 14): "
        f"{launches}")
    ss_by_shape = {
        f"Helmholtz {SIZE}x{SIZE} (phases 2, 3, 9)":
            by_phase[2] + by_phase[3] + by_phase[9],
        "1080x1920: AMF k=3, restore, Sobel (phase 4)": by_phase[4],
        "8 x 1080x1920 restore (phase 10)": by_phase[10],
        f"{STREAM_FRAMES} x 1080x1920 stream: AMF k=3 prep, restore on "
        f"{STREAM_LANES} lanes (phase 14)": by_phase[14]}
    log(f"[main] stencil_sweep launches by shape: {ss_by_shape}")
    ms_by_T = {f"T={T} (phase 9, Helmholtz {SIZE}x{SIZE})": r["launches"]
               for T, r in rows9.items()}
    ms_by_T["T=3 (phase 10, 8 x 1080x1920 restoration)"] = \
        rows10["cuda-multistep"]["launches"]
    ms_by_T[f"T={rows14['T']} (phase 14, {STREAM_FRAMES} x 1080x1920 "
            f"stream)"] = rows14["multistep_launches"]
    log(f"[main] multistep_sweep launches by T: {ms_by_T}")
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"the main path never launched {name}")
    rows5s = phase5(gen, SIZE, rate)
    helm5 = rows5s["helmholtz"]
    rows5 = phase5_multistep(gen, SIZE, rate)
    rows11, err11, by_hd11 = phase11(gen, rate)
    zero_counts()                                  # main path: 12-13
    r12, r13, r12f, r13f = lm_phases(gen)
    lm_launches = dict(A.launch_counts)
    planted = r12["fault"]["launches"] + r12f["fault"]["launches"]
    log(f"[main] swa_attention launches on the LM path (phases 12-13) by "
        f"route: {lm_launches} (bf16: wgmma, f32: cuda_core), {planted} of "
        f"them by the planted-fault forwards")
    for route, count in lm_launches.items():
        if count == 0:
            raise AssertionError(f"the LM path never took the {route} "
                                 "route of swa_attention")

    def swa_entry(route, source, **extra):
        """The kernels-line entry of one swa_attention route: its times
        are the mean of gemma2's local and global layers (phase 11)."""
        layers = rows11[route]
        mean = {key: sum(r[key] for r in layers.values()) / len(layers)
                for key in ("ms", "plain_ms", "bound_ms")}
        libs = [r["library_ms"] for r in layers.values()]
        return {"name": f"swa_attention[{route}]", "route": "cuda",
                "source": source,
                "replaces": "src/repro/kernels/swa_attention.py:32",
                "launches": lm_launches[route],
                "max_abs_err": err11[route], **mean,
                "bound_by": layers["global"]["bound_by"],
                "library_ms": None if None in libs else sum(libs) / 2,
                "library": layers["global"]["library"], **extra,
                "by_layer": layers,
                "phases": {"launched": [12, 13],
                           "held_against_plain": [11]}}
    swa_wgmma = swa_entry(
        "wgmma", "src/repro_torch/kernels/csrc/swa_wgmma.cu",
        takes="bfloat16 at hd 64/128/256",
        split_bound_ms=sum(r["split_bound_ms"]
                           for r in rows11["wgmma"].values()) / 2,
        lm={"forward_s": r12["s_kernel"], "einsum_forward_s":
            r12["s_einsum"], "tokens_per_s": LM_SEQ / r12["s_kernel"],
            "launches_per_forward": r12["launches_kernel"][0],
            "loss_rel_bf16": r12["loss_rel"],
            "max_dlogits_bf16": r12["max_dlogits"], "top1_bf16": r12["top1"],
            "fault_bf16": r12["fault"], "prefill_s": r13["prefill_s"],
            "decode_ms": r13["decode_ms"], "decode_step_ms": r13["step_ms"],
            "decode_idle_share": r13["decode_idle"], "iters": r13["iters"],
            "greedy_agree_bf16": r13["agree"]})
    swa_core = swa_entry(
        "cuda_core", "src/repro_torch/kernels/csrc/swa_attention.cu",
        takes="float32 at every hd, bfloat16 at hd 16/32/96",
        launch=rows11["cuda_core"]["local"]["launch"], by_hd=by_hd11,
        lm={"max_dlogits_f32": r12f["max_dlogits"],
            "loss_rel_f32": r12f["loss_rel"], "fault_f32": r12f["fault"],
            "greedy_agree_f32": r13f["agree"]})
    def launch_of(info):
        return {k: info[k] for k in ("tm", "tn", "ring", "ctas_per_sm",
                                     "smem_bytes", "registers")}
    log(json.dumps({"kernels": [{
        "name": "stencil_sweep",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/window.cuh",
        "entry": "src/repro_torch/kernels/csrc/stencil2d.cu",
        "replaces": "src/repro/kernels/stencil2d.py:138",
        "launches": launches["stencil_sweep"],
        "max_abs_err": max([err2, err3, err4, rows10["cuda"]["err"],
                            rows14["err_plain"]["c"],
                            rows14["err_plain"]["e"]]
                           + [r["err"] for r in rows5s.values()]),
        "ms": helm5["ms"],
        "plain_ms": helm5["plain_ms"],
        "bound_ms": helm5["bound_ms"],
        "bound_by": helm5["bound_by"],
        "library_ms": None,
        "launch": launch_of(helm5["info"]),
        "launches_by_shape": ss_by_shape,
        "by_shape": {(f"helmholtz {SIZE}x{SIZE}" if label == "helmholtz"
                      else f"{label} 1080x1920"): {
                          "ms": r["ms"], "device_us": r["device_us"],
                          "plain_ms": r["plain_ms"],
                          "bound_ms": r["bound_ms"],
                          "bound_by": r["bound_by"],
                          "launch": launch_of(r["info"])}
                     for label, r in rows5s.items()},
        "bf16_max_abs_err": err8_bf16,
        "phases": {"launched": [2, 3, 4, 9, 10, 14],
                   "held_against_plain": [1, 2, 3, 4, 5, 8, 10, 14]},
    }, {
        "name": "multistep_sweep",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/window.cuh",
        "entry": "src/repro_torch/kernels/csrc/multistep.cu",
        "replaces": "src/repro/kernels/multistep.py:101",
        "launches": launches["multistep_sweep"],
        "max_abs_err": max([err8, err9, rows10["cuda-multistep"]["err"],
                            rows14["err_plain"]["d"]]
                           + [r["err"] for r in rows5.values()]),
        "ms": rows5[4]["ms"],
        "plain_ms": rows5[4]["plain_ms"],
        "bound_ms": rows5[4]["bound_ms"],
        "bound_by": rows5[4]["bound_by"],
        "library_ms": None,
        "T": 4,
        "launches_by_T": ms_by_T,
        "by_T": {T: {"ms_launch": r["ms"], "ms_sweep": r["ms_sweep"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "loop_ms_sweep": rows9[T]["ms_sweep"],
                     "launch": launch_of(r["info"])}
                 for T, r in rows5.items()},
        "bf16_max_abs_err": err8_bf16,
        "phases": {"launched": [9, 10, 14],
                   "held_against_plain": [5, 8, 9, 10, 14]},
    }, swa_wgmma, swa_core]}))
    phase6(gen, SIZE)
    phase7(gen, SIZE, rate)
    log(card_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
