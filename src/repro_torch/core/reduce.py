"""/(⊕) — parallel reduce, and the per-lane health word.

PyTorch twin of :mod:`repro.core.reduce`.  On the card the first phase of
the paper's two-phase reduce runs inside the stencil kernel (one partial
per CTA and lane) and the final combine runs in the same launch
(:mod:`repro_torch.kernels.stencil2d`); the functions here are the plain
realisations the ``"torch"`` backend and the tests use.

``max``/``min`` are ``torch.maximum``/``torch.minimum``, which propagate
NaN exactly as ``jnp.maximum``/``jnp.minimum`` do.
"""
from __future__ import annotations

import dataclasses
import operator
from typing import Callable

import torch

# Named monoids usable across the port (op, identity).
MONOIDS = {
    "sum": (operator.add, 0.0),
    "prod": (operator.mul, 1.0),
    "max": (torch.maximum, float("-inf")),
    "min": (torch.minimum, float("inf")),
    "any": (torch.logical_or, False),
    "all": (torch.logical_and, True),
}


def resolve_monoid(op, identity):
    """Accept either a named monoid ('sum') or an (op, identity) pair."""
    if isinstance(op, str):
        return MONOIDS[op]
    if identity is None:
        raise ValueError("identity required for custom combinator")
    return op, identity


def monoid_name(op) -> str | None:
    """The name of a named monoid's op, or None for a custom combinator."""
    for name, (mop, _) in MONOIDS.items():
        if op is mop:
            return name
    return None


def collective_combine(op: Callable, partials) -> torch.Tensor:
    """The cross-shard phase of the two-phase reduce: the per-shard
    partials (a list in mesh order) folded into one value, on the first
    partial's device (twin of the reference's ``collective_combine``, whose
    collectives hand every shard this value).  Each partial is a 0-d value
    or a (lanes,) vector of one value a lane; a vector folds lane by lane.

    ``max``/``min`` fold with ``torch.maximum``/``torch.minimum`` and keep
    the reference's explicit NaN re-propagation (its all-reduce drops NaN;
    a NaN partial makes the result NaN).  ``any``/``all`` go through
    indicator counts, as in the reference.  Every other ⊕ folds in mesh
    order (the reference's ``psum`` serves sums only).
    """
    lead = partials[0].device
    vals = torch.stack([p.to(lead) for p in partials])
    if op in (torch.logical_or, torch.logical_and):
        count = vals.to(torch.float32).sum(0)
        return count > 0 if op is torch.logical_or else \
            count >= float(len(partials))
    r = vals[0]
    for v in vals[1:]:
        r = op(r, v)
    if (op is torch.maximum or op is torch.minimum) \
            and vals.dtype.is_floating_point:
        r = torch.where(torch.isnan(vals).any(0),
                        torch.full_like(r, float("nan")), r)
    return r


# ---------------------------------------------------------------------------
# Convergence sentinels — the per-lane health word (same bit layout as the
# reference, so words compare bit for bit across the two packages).
#
#     bits 0..15   stall counter (consecutive non-decreasing checks)
#     bit  16      CONVERGED — the condition c fired
#     bit  17      POISONED — the reduce value went NaN/Inf
#     bit  18      DIVERGED — the stall counter hit the sentinel patience
# ---------------------------------------------------------------------------

HEALTH_STALL_MASK = (1 << 16) - 1
HEALTH_CONVERGED = 1 << 16
HEALTH_POISONED = 1 << 17
HEALTH_DIVERGED = 1 << 18

STATUS_OK = "ok"
STATUS_NONCONVERGED = "nonconverged"
STATUS_POISONED = "poisoned"


@dataclasses.dataclass(frozen=True)
class Sentinel:
    """Per-lane health policy riding the fused reduce.

    ``nan``       — poison a lane whose reduce value goes non-finite
                    (float reduce dtypes only).
    ``patience``  — quarantine a lane whose reduce value has not
                    DECREASED for this many consecutive checks (0 = off).
    """
    nan: bool = True
    patience: int = 0


def _bool_on(x, shape, device) -> torch.Tensor:
    """``x`` as a bool tensor on ``device``; a Python bool becomes a fill
    on the device (no blocking host-to-device copy)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.bool)
    return torch.full(shape, bool(x), dtype=torch.bool, device=device)


def health_update(hw, r_new, r_prev, live, converged, it, sentinel):
    """One sentinel step on device tensors: fold this check's reduce value
    into the packed health words.  ``it`` may be a tensor or an int.
    Returns ``(hw', quarantine)``; ``quarantine`` marks lanes the driver
    must mask done now (poisoned or diverged)."""
    hw = torch.as_tensor(hw, dtype=torch.int32)
    dev = hw.device
    r_new = torch.as_tensor(r_new, device=dev)
    live = _bool_on(live, hw.shape, dev)
    converged = _bool_on(converged, hw.shape, dev)
    stall = hw & HEALTH_STALL_MASK
    flags = hw - stall
    floatlike = r_new.dtype.is_floating_point
    false = torch.zeros(hw.shape, dtype=torch.bool, device=dev)
    if sentinel is not None and sentinel.nan and floatlike:
        poison = live & ~torch.isfinite(r_new)
    else:
        poison = false
    if sentinel is not None and sentinel.patience > 0 and floatlike:
        # the first check compares against the identity element, which is
        # not a real iterate — let it pass
        stalled = live & (r_new >= r_prev) & (it > 0)
        stall = torch.where(live, torch.where(stalled, stall + 1,
                                              torch.zeros_like(stall)),
                            stall)
        diverged = stall >= sentinel.patience
    else:
        diverged = false
    flags = torch.where(live & converged, flags | HEALTH_CONVERGED, flags)
    flags = torch.where(poison, flags | HEALTH_POISONED, flags)
    flags = torch.where(diverged, flags | HEALTH_DIVERGED, flags)
    quarantine = live & (poison | diverged)
    return flags | stall, quarantine


def health_status(hw) -> str:
    """Host-side status of one packed health word.  Poison wins over
    everything; a clean CONVERGED bit is the only path to 'ok'."""
    hw = int(hw)
    if hw & HEALTH_POISONED:
        return STATUS_POISONED
    if hw & HEALTH_DIVERGED:
        return STATUS_NONCONVERGED
    if hw & HEALTH_CONVERGED:
        return STATUS_OK
    return STATUS_NONCONVERGED


def tree_reduce(op: Callable, a: torch.Tensor, identity) -> torch.Tensor:
    """Balanced-tree fold of the associative ⊕ over all items of ``a``
    (log-depth pairwise combine, identity-padded to a power of two)."""
    flat = a.reshape(-1)
    n = flat.shape[0]
    size = 1 if n == 0 else 1 << (n - 1).bit_length()
    if size != n:
        flat = torch.cat([flat, torch.full((size - n,), identity,
                                           dtype=flat.dtype,
                                           device=flat.device)])
    while flat.shape[0] > 1:
        flat = op(flat[0::2], flat[1::2])
    return flat[0]


def two_phase_reduce(op: Callable, a: torch.Tensor, identity,
                     tile: int = 4096) -> torch.Tensor:
    """The paper's two-phase reduce: per-tile partials, then a final
    combine of the partials."""
    flat = a.reshape(-1)
    n = flat.shape[0]
    ntiles = max(1, -(-n // tile))
    size = ntiles * tile
    if size != n:
        flat = torch.cat([flat, torch.full((size - n,), identity,
                                           dtype=flat.dtype,
                                           device=flat.device)])
    partials = flat.reshape(ntiles, tile)
    while partials.shape[1] > 1:
        half = partials.shape[1] // 2
        partials = op(partials[:, :half], partials[:, half:])
    return tree_reduce(op, partials[:, 0], identity)
