"""Paper §4.1 — Helmholtz equation solver (iterative Jacobi), on the port.

Twin of ``examples/helmholtz.py``: solves (∇² − α)u = −f with the fused
stencil+reduce sweep inside one device-resident loop, then checks the
discrete residual.  By default it runs on the CUDA card through the
hand-written kernel (built at first use); ``--plain`` runs the plain
PyTorch path on the same device, ``--device cpu`` on the CPU.
``--backend cuda-multistep --unroll T`` fuses T sweeps into each launch of
the temporal-blocking kernel (the condition is checked every T sweeps).

    PYTHONPATH=src python -m repro_torch.examples.helmholtz --size 1024
    PYTHONPATH=src python -m repro_torch.examples.helmholtz --size 1024 \\
        --backend cuda-multistep --unroll 4
    PYTHONPATH=src python -m repro_torch.examples.helmholtz --size 128 \\
        --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.kernels import ops


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--alpha", type=float, default=2.0)
    ap.add_argument("--tol", type=float, default=1e-5)
    ap.add_argument("--plain", action="store_true",
                    help="the plain PyTorch path instead of the kernel")
    ap.add_argument("--backend", default=None,
                    choices=["torch", "cuda", "cuda-multistep"],
                    help="default: 'cuda' on the card, 'torch' on the CPU")
    ap.add_argument("--unroll", type=int, default=1,
                    help="sweeps per check (fused into one launch on "
                         "cuda-multistep)")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' for the CPU "
                         "(plain path only)")
    args = ap.parse_args(argv)

    n = args.size
    dx = 1.0 / n
    rng = np.random.default_rng(0)
    fxy = rng.normal(size=(n, n)).astype(np.float32)
    u0 = np.zeros((n, n), np.float32)
    backend = "torch" if args.plain else args.backend

    t0 = time.perf_counter()
    u, delta, iters = ops.jacobi_solve(
        u0, fxy, alpha=args.alpha, dx=dx, tol=args.tol, max_iters=20000,
        backend=backend, unroll=args.unroll, device=args.device)
    if u.is_cuda:
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0

    f = torch.as_tensor(fxy, device=u.device)
    up = torch.nn.functional.pad(u, (1, 1, 1, 1))
    neigh = up[:-2, 1:-1] + up[2:, 1:-1] + up[1:-1, :-2] + up[1:-1, 2:]
    res = (4 + args.alpha * dx * dx) * u - neigh - dx * dx * f
    where = (torch.cuda.get_device_name(u.device) if u.is_cuda
             else "cpu")
    print(f"size={n}x{n}  iters={int(iters)}  max|Δ|={float(delta):.2e}  "
          f"residual={float(res[1:-1, 1:-1].abs().max()):.2e}  "
          f"wall={dt:.2f}s  backend={backend or 'default'}  "
          f"unroll={args.unroll}  "
          f"device={where}")


if __name__ == "__main__":
    main()
