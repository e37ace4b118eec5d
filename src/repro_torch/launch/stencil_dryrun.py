"""Dry run of the paper's OWN application at production scale: the Jacobi
Loop-of-stencil-reduce (``jac``, max |Δ| < 1e-4) on the (16, 16) pod —
2-D halo decomposition, one frame a device, the partial maxima folded —
for the paper's largest grid (16384², Table 1), each device holding a
1024² block (twin of :mod:`repro.launch.stencil_dryrun`).

The reference compiles the distributed loop and reads its HLO; the port's
sharded tier is a host loop over per-shard frames, so the per-sweep,
per-device terms are analytic, for an interior device:

    t_m  the stencil kernel's frame read and write, over HBM_BW
    t_c  4 FLOPs a cell (three adds, a multiply) plus the delta (a
         subtract and an absolute value) and the max: 7, over the
         float32 rate of the CUDA cores (the kernel runs there)
    t_x  4 edge strips × k × 1024 cells × 4 B a check, at the cross-node
         rate (IB_BW: "data" and "model" of 16 both leave a node)

and the exchange of the whole mesh per check, which the sharded tier's
own counters (:data:`repro_torch.core.frames.exchange_counts`) give for a
real exchange: :func:`exchange_per_check`.

    PYTHONPATH=src python -m repro_torch.launch.stencil_dryrun [--size 16384]

writes ``runs/dryrun_torch/stencil_<n>.json`` (the reference's records
are under ``runs/dryrun``).

It computes shapes only and runs nothing on a device.
"""
from __future__ import annotations

import argparse
import json
import os
import time

JAC_FLOPS = 4         # a cell of jac: three adds and one multiply
DELTA_MAX_FLOPS = 3   # |new - old| and its max into the partial reduce
TOL = 1e-4            # the condition: max |Δ| < TOL


def jacobi_loop(max_iters: int, *, backend=None, device=None):
    """The dry run's application on one device: ``jac`` to max |Δ| <
    :data:`TOL`, at most ``max_iters`` sweeps (a
    :class:`~repro_torch.core.pattern.LoopOfStencilReduce`; ``run`` it on
    a grid)."""
    from ..core.pattern import LoopOfStencilReduce
    from ..kernels import ref as R
    return LoopOfStencilReduce(
        f=R.jacobi_taps(), k=1, combine="max", identity=float("-inf"),
        cond=lambda r: r < TOL, delta=R.abs_delta, max_iters=max_iters,
        backend=backend, device=device)


def exchange_per_check(mesh_shape, block, *, k: int = 1,
                       unroll: int = 1) -> dict:
    """Strips and cells the sharded tier's exchange copies between
    devices in one check (every ``unroll`` sweeps) over a mesh of
    ``mesh_shape`` (rows, columns of devices), each holding a ``block``
    (rows, columns) domain with a ghost ring of ``k · unroll``: axis-0
    strips span the block's columns, axis-1 strips the frame's full
    height (corners come from the diagonal neighbour); a global edge
    (a non-wrapping boundary) copies nothing."""
    P, Q = mesh_shape
    m, n = block
    pad = k * unroll
    links0, links1 = 2 * (P - 1) * Q, 2 * (Q - 1) * P
    return {"strips": links0 + links1,
            "cells": links0 * pad * n + links1 * pad * (m + 2 * pad)}


def plan(n: int, *, iters: int = 10, mesh_shape=(16, 16)) -> dict:
    """The dry run's record for an n × n float32 grid over ``mesh_shape``
    (k = 1, a check every sweep)."""
    from ..core.frames import frame_spec
    from .roofline import FP32_RATE, HBM_BW, IB_BW
    P, Q = mesh_shape
    if n % P or n % Q:
        raise ValueError(f"a {n}² grid does not split over a {P}x{Q} mesh")
    m, b = n // P, n // Q
    k, unroll, itemsize = 1, 1, 4
    spec = frame_spec(m, b, k=k, sweeps=unroll)
    frame_bytes = spec.shape[0] * spec.shape[1] * itemsize
    cells = m * b
    flops = cells * (JAC_FLOPS + DELTA_MAX_FLOPS)
    mem = 2 * frame_bytes                        # read + write a sweep
    halo = 4 * k * b * itemsize                  # 4 strips a sweep
    x = exchange_per_check(mesh_shape, (m, b), k=k, unroll=unroll)
    t_c, t_m, t_x = flops / FP32_RATE, mem / HBM_BW, halo / IB_BW
    return {
        "app": "helmholtz_stencil", "stencil": "jac", "grid": n,
        "iters": iters, "chips": P * Q, "mesh": list(mesh_shape),
        "block": [m, b], "frame": list(spec.shape), "k": k,
        "unroll": unroll, "ok": True,
        "flops_per_device": iters * flops,
        "bytes_per_device": iters * mem,
        "collective_bytes_per_device": iters * halo,
        "per_collective": {"collective-permute": iters * halo},
        "trip_counts": {},
        "t_compute": iters * t_c, "t_memory": iters * t_m,
        "t_collective": iters * t_x,
        "sweep": {"t_compute": t_c, "t_memory": t_m, "t_collective": t_x},
        "strips_per_check": x["strips"], "cells_per_check": x["cells"],
        "temp_bytes": 2 * frame_bytes,           # the frame and the next
        "model": "analytic: an interior device, datasheet rates",
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=16384)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--out", default="runs/dryrun_torch")
    args = ap.parse_args(argv)
    t0 = time.time()
    rec = plan(args.size, iters=args.iters)
    rec["compile_s"] = round(time.time() - t0, 3)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"stencil_{args.size}.json"), "w") as f:
        json.dump(rec, f, indent=1)
    sw = rec["sweep"]
    print(f"[stencil-dryrun] {args.size}x{args.size} on 16x16 pod: "
          f"per-iter/chip tc={sw['t_compute'] * 1e6:.1f}us "
          f"tm={sw['t_memory'] * 1e6:.1f}us "
          f"tx={sw['t_collective'] * 1e6:.1f}us "
          f"(halo strips a check over the mesh: {rec['strips_per_check']})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
