"""Quickstart: the Loop-of-stencil-reduce pattern in five minutes, on the
port.

Twin of ``examples/quickstart.py``: Conway's Game of Life (the paper's
Fig. 1 example) and a Jacobi solve through the public API, then the -d
and -s variants, the lane farm and the streaming ``FarmEngine``.  It runs
on the CUDA card through the hand-written kernel (backend ``"cuda"``)
unless ``--device cpu`` is given (the plain path, backend ``"torch"``);
the printed integers are the same on both.

    PYTHONPATH=src python -m repro_torch.examples.quickstart
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import (FarmEngine, LoopOfStencilReduce,
                              loop_of_stencil_reduce,
                              loop_of_stencil_reduce_d,
                              loop_of_stencil_reduce_s)
from repro_torch.device import resolve_device
from repro_torch.kernels import ref as R


def main(argv=None) -> dict:
    """Prints the reference's lines; returns their integers."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' for the plain path")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    backend = "cuda" if dev.type == "cuda" else "torch"
    kw = dict(backend=backend, device=dev)
    rng = np.random.default_rng(0)
    out = {}

    # -- Game of Life: base variant --------------------------------------
    # stencil f = the GoL rule over a 3×3 neighbourhood (taps protocol);
    # reduce ⊕ = sum of alive cells; condition c = extinction.
    world = rng.integers(0, 2, (64, 64)).astype(np.float32)
    res = loop_of_stencil_reduce(1, R.gol_taps(), "sum",
                                 lambda alive: alive <= 0, world,
                                 max_iters=200, **kw)
    out["gol"] = (int(res.iters), int(res.reduced))
    print(f"[GoL]     ran {out['gol'][0]} generations, "
          f"{out['gol'][1]} cells alive")

    # -- Jacobi: -d variant (convergence on the delta) --------------------
    jacobi = R.jacobi_taps()
    u0 = rng.normal(size=(96, 96)).astype(np.float32)
    res = loop_of_stencil_reduce_d(1, jacobi, R.abs_delta, "max",
                                   lambda d: d < 1e-4, u0, max_iters=5000,
                                   **kw)
    out["jacobi"] = int(res.iters)
    print(f"[Jacobi]  converged in {out['jacobi']} iterations "
          f"(max |Δ| = {float(res.reduced):.2e})")

    # -- -s variant: loop state in the condition --------------------------
    res = loop_of_stencil_reduce_s(
        1, jacobi, "sum", lambda r, steps: steps >= 10, u0,
        init=lambda: torch.tensor(0, dtype=torch.int32, device=dev),
        update=lambda s, a, it: s + 1, **kw)
    out["jacobi_s"] = int(res.iters)
    print(f"[Jacobi-s] fixed-budget run stopped at {out['jacobi_s']} steps")

    # -- streaming farm (1:1 mode): items converge independently ----------
    # farm_run drives the whole batch as ONE done-masked loop over a
    # stacked (lanes, grid) carry — each lane to its own trip count
    runner = LoopOfStencilReduce(
        f=jacobi, k=1, combine="max", identity=-np.inf,
        cond=lambda d: d < 1e-4, delta=R.abs_delta, max_iters=5000, **kw)
    batch = np.stack([u0, u0 * 5.0, u0 * 0.1])
    res = runner.farm_run(batch)
    out["farm"] = [int(i) for i in res.iters.tolist()]
    print(f"[farm]    per-item trip counts: {out['farm']}")

    # -- FarmEngine: a whole stream through persistent lane slots ---------
    # frames are built once per lane slot and REFILLED in place with each
    # next item — no re-pad, no re-alloc, no host round-trip of the frame
    # (the reference's demo grid and tolerance)
    v0 = u0[:48, :48]
    streamer = LoopOfStencilReduce(
        f=jacobi, k=1, combine="max", identity=-np.inf,
        cond=lambda d: d < 1e-2, delta=R.abs_delta, max_iters=600, **kw)
    eng = FarmEngine(streamer, lanes=2, device=dev)
    iters = []
    n = eng.run([v0 * s for s in (1.0, 5.0, 0.1, 2.0, 0.5)],
                lambda r: iters.append(int(r.iters)))
    out["stream"] = {"items": n, "rounds": int(eng.stats["rounds"]),
                     "iters": iters}
    print(f"[stream]  {n} items through 2 persistent lane slots "
          f"({out['stream']['rounds']} rounds, backend={backend}); "
          f"trip counts: {iters}")
    return out


if __name__ == "__main__":
    main()
