"""Noisy frames for a restoration stream, made from the seed.

The clean frames are the moving pattern of the repo's restoration example
(``synth_video`` in ``examples/video_restoration.py``), copied here so that
a change to the example cannot move the yardstick; each carries
salt-and-pepper noise at a density of its own.  The traffic file gives the
number of distinct frames and a list of noise densities, each taking an
equal share of the frames.  Every seed gets the same densities in the same
order (one shuffle, drawn from ``order_seed``), with noise pixels drawn from
the seed: the seed changes which pixels are noisy, not how much work the
stream holds or when it arrives.
"""
from __future__ import annotations

import numpy as np
import torch


def densities(traffic: dict) -> np.ndarray:
    """One density a distinct frame: the traffic's levels in equal shares
    (the first levels take one more where they do not divide evenly), in
    the order drawn from ``order_seed``."""
    levels = [float(d) for d in traffic["density"]]
    n = int(traffic["distinct"])
    order = np.random.default_rng(int(traffic["order_seed"]))
    return np.array([levels[i % len(levels)] for i in range(n)])[
        order.permutation(n)]


def clean_frame(t: int, yy: torch.Tensor, xx: torch.Tensor) -> torch.Tensor:
    """Frame ``t`` of the moving pattern (float32 in [0, 1]); ``yy`` and
    ``xx`` are int64 index grids."""
    yf, xf = yy.to(torch.float64), xx.to(torch.float64)
    base = 0.5 + 0.3 * torch.sin(xf / 25.0 + t / 3) * torch.cos(yf / 18.0) \
        + 0.2 * ((torch.div(xx + 4 * t, 40, rounding_mode="floor")
                  + torch.div(yy, 30, rounding_mode="floor")) % 2)
    return base.clamp(0, 1).to(torch.float32)


def make(shape, traffic: dict, seed: int, device) -> torch.Tensor:
    """The stream's distinct noisy frames as an (n, m, w) float32 tensor on
    ``device``, made one at a time."""
    m, w = shape
    dens = densities(traffic)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    yy, xx = torch.meshgrid(torch.arange(m, device=device),
                            torch.arange(w, device=device), indexing="ij")
    out = torch.empty((len(dens), m, w), dtype=torch.float32, device=device)
    for t, d in enumerate(dens):
        clean = clean_frame(t, yy, xx)
        imp = torch.rand((m, w), generator=gen, device=device) < float(d)
        salt = torch.rand((m, w), generator=gen, device=device) >= 0.5
        out[t] = torch.where(imp, salt.to(torch.float32), clean)
    return out
