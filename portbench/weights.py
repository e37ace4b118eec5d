"""Random weights for a served model, drawn on the card from the seed.

The benchmark makes the weights, hands the same tensors to the program and
to the plain reference, and names them by the dotted path of the model's
parameter tree (``layers.3.moe.w_up``).  The draw is a few large calls: one
flat buffer a dtype, filled with N(0, 1) in the served dtype from one
``torch.Generator`` on the card in chunks, then each weight a view of it
scaled by 1/sqrt(its fan-in) (the embedding by 1/sqrt(hidden)).  Norm scales
are 0, in the (1 + scale) form the configuration uses.
"""
from __future__ import annotations

import math

import torch

CHUNK = 1 << 28        # elements a draw


def fan_in(name: str, shape: tuple) -> int:
    """The inputs each output of the weight ``name`` sums over."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "embed":
        return shape[1]
    if leaf == "wo":                         # (H, hd, D)
        return shape[0] * shape[1]
    if leaf in ("w_up", "w_gate", "w_down"):  # (E, in, out)
        return shape[1]
    return shape[0]                          # (in, ...)


def is_norm(name: str) -> bool:
    leaf = name.rsplit(".", 1)[-1]
    return leaf.startswith(("ln", "post_ln")) or leaf.endswith("norm")


def materialize(module: torch.nn.Module, seed: int, device) -> dict:
    """Give every parameter of ``module`` (built on the meta device) its
    storage on ``device``, drawn from ``seed``; returns {name: tensor}."""
    params = [(n, p) for n, p in module.named_parameters() if not is_norm(n)]
    norms = [(n, p) for n, p in module.named_parameters() if is_norm(n)]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flats = {}
    for dt in sorted({p.dtype for _, p in params}, key=str):
        total = sum(p.numel() for _, p in params if p.dtype == dt)
        flat = torch.empty(total, dtype=dt, device=device)
        for s in range(0, total, CHUNK):
            flat[s:s + CHUNK].normal_(generator=gen)
        flats[dt] = [flat, 0]
    out = {}
    for name, p in params:
        flat = flats[p.dtype]
        n = p.numel()
        t = flat[0][flat[1]:flat[1] + n].view(p.shape)
        flat[1] += n
        t.mul_(1.0 / math.sqrt(fan_in(name, tuple(p.shape))))
        out[name] = t
    for name, p in norms:
        out[name] = torch.zeros(p.shape, dtype=p.dtype, device=device)
    for name, t in out.items():
        mod_name, _, leaf = name.rpartition(".")
        owner = module.get_submodule(mod_name) if mod_name else module
        owner._parameters[leaf] = torch.nn.Parameter(t, requires_grad=False)
    return out
