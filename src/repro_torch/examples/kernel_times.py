"""Device times of the port's kernels at the main paths' shapes, for one
checkout of the port: run it once per tree in one process each, in turns
(parent, change, change, parent), to compare two versions on one card.

* ``swa_attention`` at gemma2-9b's local (window 4096) and global layers
  (S 8192, 16 query / 8 kv heads, hd 256, softcap 50): float32 on the
  CUDA-core kernel and bfloat16 on the wgmma kernel, each held against
  the plain version on one kv head's group first (float32 within 2e-5,
  bf16 within one bf16 ulp); TFLOP/s of the band's 4·hd flops a pair;
* ``swa_attention`` at phi-3-vision-4.2b's shape (B 4, 32/32 heads, hd 96,
  S 1024, causal, global, bf16) on whichever route the tree takes there
  (named in its row), held against the plain version within one bf16 ulp;
* ``stencil_sweep`` on a Helmholtz 8192² frame and ``multistep_sweep`` at
  T = 2, 4 and 8 (``chip_smoke.py`` phase 5's shapes).

``--src`` names the ``src`` directory whose ``repro_torch`` is timed (its
kernels build into that checkout's ``build/``); the default is the one
this file lies in.  The last line is one JSON object with every time.

    python src/repro_torch/examples/kernel_times.py
    python src/repro_torch/examples/kernel_times.py --src _parent/src
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

SEQ, H, KH, HD, CAP, WINDOW = 8192, 16, 8, 256, 50.0, 4096
F32_TOL = 2e-5
BF16_RTOL, BF16_ATOL = 1e-2, 1e-4     # one bf16 ulp, as chip_smoke.py
SIZE = 8192
VLM_B, VLM_H, VLM_HD, VLM_SEQ = 4, 32, 96, 1024   # phi-3-vision-4.2b


def band_pairs(S: int, window: int) -> int:
    """(q, k) pairs inside one head's causal band (``chip_smoke.py``'s
    count; a copy, since the script also times trees that predate it)."""
    if not window or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def device_ms(fn, iters, warmup=2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def swa_times(gen, iters):
    import torch
    from repro_torch.kernels import swa_attention as A
    rows = {}
    for label, window in (("local", WINDOW), ("global", 0)):
        qkv = [torch.randn((n, SEQ, HD), generator=gen, device="cuda")
               for n in (H, KH, KH)]
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (t.to(dtype) for t in qkv)
            kw = dict(window=window, causal=True, softcap=CAP)
            got = A.swa_attention(q, k, v, **kw)[:H // KH].float()
            want = A.swa_attention_plain(q[:H // KH], k[:1], v[:1],
                                         **kw).float()
            err = float((got - want).abs().max())
            if dtype == torch.float32:
                use = err / F32_TOL
            else:
                use = float(((got - want).abs()
                             / (BF16_ATOL + BF16_RTOL * want.abs())).max())
            if not use <= 1.0:
                raise AssertionError(f"swa_attention {dtype} {label}: "
                                     f"kernel/plain limit use {use!r}")
            ms = device_ms(lambda: A.swa_attention(q, k, v, **kw), iters)
            key = f"{'f32' if dtype == torch.float32 else 'bf16'} {label}"
            rows[key] = dict(
                ms=ms, max_abs_err=err, limit_use=use,
                tflops=4 * HD * band_pairs(SEQ, window) * H / (ms * 1e-3)
                / 1e12)
            launch = getattr(A, "last_launch", None)
            if dtype == torch.float32 and launch is not None:
                rows[key]["launch"] = launch()
            print(f"swa_attention {key}: {ms:.4f} ms "
                  f"({rows[key]['tflops']:.2f} TFLOP/s), max_abs_err vs "
                  f"plain {err:.3g} ({use:.4f} of the limit)", flush=True)
            del q, k, v, got, want
        del qkv
        torch.cuda.empty_cache()
    return rows


def vlm_swa_times(gen, iters):
    """The bf16 attention at phi-3-vision's shape: the route the tree's
    wrapper took (from its launch counts), the time a launch, TFLOP/s."""
    import torch
    from repro_torch.kernels import swa_attention as A
    q, k, v = (torch.randn((VLM_B * VLM_H, VLM_SEQ, VLM_HD), generator=gen,
                           device="cuda").to(torch.bfloat16)
               for _ in range(3))
    kw = dict(window=0, causal=True)
    before = dict(A.launch_counts)
    got = A.swa_attention(q, k, v, **kw).float()
    route = next(r for r in before if A.launch_counts[r] != before[r])
    want = A.swa_attention_plain(q, k, v, **kw).float()
    err = float((got - want).abs().max())
    use = float(((got - want).abs()
                 / (BF16_ATOL + BF16_RTOL * want.abs())).max())
    del got, want
    torch.cuda.empty_cache()
    if not use <= 1.0:
        raise AssertionError(f"swa_attention bf16 phi-3-vision: kernel/plain"
                             f" limit use {use!r}")
    ms = device_ms(lambda: A.swa_attention(q, k, v, **kw), iters)
    tflops = (4 * VLM_HD * band_pairs(VLM_SEQ, 0) * VLM_B * VLM_H
              / (ms * 1e-3) / 1e12)
    row = dict(route=route, ms=ms, max_abs_err=err, limit_use=use,
               tflops=tflops)
    print(f"swa_attention bf16 phi-3-vision (B {VLM_B}, {VLM_H}/{VLM_H} "
          f"heads, hd {VLM_HD}, S {VLM_SEQ}, causal) on {row['route']}: "
          f"{ms:.4f} ms ({tflops:.2f} TFLOP/s), max_abs_err vs plain "
          f"{err:.3g} ({use:.4f} of the limit)", flush=True)
    del q, k, v
    torch.cuda.empty_cache()
    return row


def stencil_times(gen, iters):
    import torch
    from repro_torch.core.frames import frame_env, frame_spec, make_frame
    from repro_torch.kernels import ref as R
    from repro_torch.kernels.multistep import stencil2d_multistep_framed
    from repro_torch.kernels.stencil2d import (alloc_scratch,
                                               stencil2d_fused_framed)
    f = R.helmholtz_jacobi_taps(0.5, 1 / 512)
    rows = {}
    for T in (1, 2, 4, 8):
        spec = frame_spec(SIZE, SIZE, k=1, sweeps=T)
        frame = make_frame(torch.rand((SIZE, SIZE), generator=gen,
                                      device="cuda"), spec, "zero")
        env = (frame_env(torch.rand((SIZE, SIZE), generator=gen,
                                    device="cuda"), spec, "zero",
                         halo=T > 1),)
        out = torch.zeros_like(frame)
        scratch = alloc_scratch(spec, "cuda")
        if T == 1:
            def run():
                return stencil2d_fused_framed(
                    frame, f, spec, env_framed=env, combine="max",
                    measure=R.abs_delta, scratch=scratch, out=out)
        else:
            def run():
                return stencil2d_multistep_framed(
                    frame, f, spec, T=T, env_framed=env, combine="max",
                    measure=R.abs_delta, boundary="zero", scratch=scratch,
                    out=out)
        ms = device_ms(run, iters)
        name = "stencil_sweep" if T == 1 else f"multistep_sweep T={T}"
        rows[name] = dict(ms=ms)
        print(f"{name} helmholtz {SIZE}x{SIZE}: {ms:.4f} ms", flush=True)
        del frame, out, env, scratch
        torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    here = Path(__file__).resolve().parents[2]
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(here),
                    help="the src directory whose repro_torch is timed")
    ap.add_argument("--label", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    import repro_torch
    from repro_torch.kernels import _build
    _build.library()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"{card}; repro_torch from {Path(repro_torch.__file__).parent}",
          flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    result = {"label": args.label or args.src, "card": card}
    result["swa_attention"] = swa_times(gen, iters=10)
    result["swa_attention"]["bf16 phi-3-vision"] = vlm_swa_times(gen,
                                                                 iters=20)
    result["stencil"] = stencil_times(gen, iters=20)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
