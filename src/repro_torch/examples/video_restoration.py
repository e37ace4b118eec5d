"""Paper §4.3 — two-phase video restoration over a frame stream, on the
port (twin of ``examples/video_restoration.py``).

pipe(read, detect, ofarm(restore), write): adaptive-median detection
(escalating 3×3 → 7×7 stencil) as the farm's per-item ``prep``, then the
iterative edge-preserving regularisation (Loop-of-stencil-reduce -d) in
the lane slots of a :class:`~repro_torch.core.streaming.FarmEngine`,
which are refilled in place with each next frame.  ``--continuous``
streams with per-lane refill (results in completion order) instead of
rounds.

    PYTHONPATH=src python -m repro_torch.examples.video_restoration \\
        [--frames 8] [--noise 0.3] [--res 1080p] [--lanes 8] \\
        [--continuous] [--backend cuda|cuda-multistep|torch] \\
        [--device cuda|cpu]

The default device is the CUDA card; ``--device cpu --backend torch`` runs
the plain path on the CPU.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

RES = {"tiny": (96, 160), "vga": (480, 640), "720p": (720, 1280),
       "1080p": (1080, 1920)}


def synth_video(shape, frames, noise, seed=0):
    """Yield ``(clean, noisy)`` float32 frames: the reference example's
    moving pattern with salt-and-pepper noise at density ``noise`` (a
    number, or one per frame)."""
    levels = np.broadcast_to(np.asarray(noise, np.float64), (frames,))
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]]
    rng = np.random.default_rng(seed)
    for t in range(frames):
        base = 0.5 + 0.3 * np.sin(xx / 25.0 + t / 3) \
            * np.cos(yy / 18.0) + 0.2 * (((xx + 4 * t) // 40 + yy // 30)
                                         % 2)
        clean = np.clip(base, 0, 1).astype(np.float32)
        imp = rng.uniform(size=shape) < levels[t]
        sp = np.where(rng.uniform(size=shape) < 0.5, 0.0, 1.0)
        yield clean, np.where(imp, sp, clean).astype(np.float32)


def psnr(a, b):
    return float(-10 * np.log10(np.mean((np.asarray(a) - np.asarray(b)) ** 2)
                                + 1e-12))


def detector(backend, device):
    """The detection stage as a farm ``prep``: AMF mask + repaired initial
    guess become the lane's grid and env fields."""
    from ..kernels import ops

    def detect(frame):
        mask, repaired = ops.adaptive_median_detect(frame, backend=backend,
                                                    device=device)
        return repaired, (repaired, mask)
    return detect


def restore_loop(backend, device, unroll=1, sentinel=None):
    """The restoration worker of the stream (the reference example's)."""
    from ..core.pattern import LoopOfStencilReduce
    from ..kernels import ref as R
    return LoopOfStencilReduce(
        f=R.restore_taps(2.0), k=1, combine="max", delta=R.abs_delta,
        cond=lambda r: r < 1e-3, boundary="reflect", max_iters=50,
        unroll=unroll, backend=backend, sentinel=sentinel, device=device)


def main(argv=None):
    from ..core.streaming import FarmEngine

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--noise", type=float, default=0.3)
    ap.add_argument("--res", choices=list(RES), default="tiny")
    ap.add_argument("--lanes", type=int, default=2)
    ap.add_argument("--continuous", action="store_true",
                    help="per-lane refill, results in completion order")
    ap.add_argument("--backend", default="cuda",
                    choices=("cuda", "cuda-multistep", "torch"))
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card")
    args = ap.parse_args(argv)

    pairs = list(synth_video(RES[args.res], args.frames, args.noise))
    cleans = [c for c, _ in pairs]
    noisys = [n for _, n in pairs]
    loop = restore_loop(args.backend, args.device,
                        unroll="auto" if args.backend == "cuda-multistep"
                        else 1)
    eng = FarmEngine(loop, lanes=args.lanes,
                     prep=detector(args.backend, loop.device),
                     device=loop.device)
    done = {}
    t0 = time.perf_counter()
    if args.continuous:
        n = eng.run(noisys, lambda r: done.__setitem__(r.index, r),
                    continuous=True)
    else:
        n = eng.run(noisys, lambda r: done.__setitem__(len(done), r))
    dt = time.perf_counter() - t0

    ps_in = np.mean([psnr(noisys[i], cleans[i]) for i in range(n)])
    ps_out = np.mean([psnr(done[i].a, cleans[i]) for i in range(n)])
    its = [int(done[i].iters) for i in range(n)]
    mode = (f"{eng.stats['segments']} segments" if args.continuous
            else f"{eng.stats['rounds']} rounds")
    print(f"restored {n} {args.res} frames @ {args.noise:.0%} noise on "
          f"{args.backend} ({loop.device}) in {dt:.2f}s ({n / dt:.2f} fps; "
          f"{mode} through {args.lanes} lane slots)")
    print(f"host transfer: {eng.stats['h2d_bytes'] / max(n, 1):.0f} B/item"
          f" in, {eng.stats['d2h_bytes'] / max(n, 1):.0f} B/item out")
    print(f"PSNR {ps_in:.1f} -> {ps_out:.1f} dB; iterations/frame: {its}")


if __name__ == "__main__":
    main()
