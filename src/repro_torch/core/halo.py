"""Multi-device 1:n deployment: domain decomposition + halo exchange.

PyTorch twin of :mod:`repro.core.halo`.  The paper's 1:n mode splits one
input across n GPUs ("evenly for 1D array and by rows for 2D matrix") and
keeps the k-deep borders aligned after every iteration.  The reference runs
the loop inside ``shard_map`` and swaps halos by ppermute; the port is
single-controller too: the shards of a grid are a list of blocks in mesh
order (:mod:`repro_torch.sharding.specs`), each on its device, a halo swap
is a ``copy_`` of edge strips between them (peer to peer across cards, on
the card where two shards share one), and the convergence reduce is the
fold of the per-shard partials
(:func:`repro_torch.core.reduce.collective_combine`).

Two loop-body realisations, both run by the pattern's repeat/until loop
:meth:`repro_torch.core.pattern.LoopOfStencilReduce._drive`:

``backend="torch"``
    the plain path (twin of the reference's ``"jnp"``): per sweep,
    :func:`exchange_halo` grows each block by 2k along every decomposed
    axis, the other stencil axes are ⊥-padded locally, and the tap-style
    ``f`` runs on the grown block.  General (any ndim, any
    ``stencil_axes``) but builds a fresh grown block every sweep.  The
    tests and ``chip_smoke.py`` hold the kernel route against it.

``backend="cuda-sharded"``
    the persistent path (:class:`repro_torch.core.executor.
    ShardedStencilEngine`): one halo frame per shard, the kernels of the
    single-device backends, O(k·n) edge strips copied straight into the
    neighbours' ghost rings, and with ``unroll=T`` one k·T-deep exchange
    per T fused sweeps.  2-D ``taps`` arrays only.

Corner halos propagate through the two-pass order: axis 0 first, then the
already-grown axis 1.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from ..sharding.specs import GridPartition, gather_grid, scatter_grid
from .pattern import LoopOfStencilReduce, LoopResult
from .reduce import collective_combine, resolve_monoid, tree_reduce
from .semantics import Boundary
from .stencil import TapAccessor


def _edge(x, axis, lo, hi):
    idx = [slice(None)] * x.ndim
    idx[axis] = slice(lo, hi)
    return x[tuple(idx)]


def exchange_halo(blocks: Sequence[torch.Tensor], k: int, axis: int,
                  part: GridPartition,
                  boundary: Boundary | str = Boundary.ZERO) -> list:
    """Extend every shard's block with k-deep halos from its neighbours
    along the mesh axis that splits array ``axis``.

    ``blocks`` are the shards' blocks in mesh order; returns them grown by
    2k along ``axis``, each on its own device.  Edge shards fill the
    missing side by the boundary model: ZERO/NaN constants, REFLECT mirrors
    locally (no edge repeat), WRAP closes the mesh ring.
    """
    boundary = Boundary(boundary)
    name = part.axis_names[part.array_axes.index(axis)]
    n, stride = part.axis_size(name), part.stride(name)
    wrap = boundary is Boundary.WRAP
    out = []
    for i, x in enumerate(blocks):
        me = (i // stride) % n
        size = x.shape[axis]
        if me > 0 or wrap:
            prev = blocks[i + (((me - 1) % n) - me) * stride]
            from_prev = _edge(prev, axis, prev.shape[axis] - k,
                              prev.shape[axis]).to(x.device)
        elif boundary is Boundary.REFLECT:
            from_prev = _edge(x, axis, 1, k + 1).flip(axis)
        else:
            from_prev = torch.full_like(
                _edge(x, axis, 0, k),
                0.0 if boundary is Boundary.ZERO else float("nan"))
        if me < n - 1 or wrap:
            nxt = blocks[i + (((me + 1) % n) - me) * stride]
            from_next = _edge(nxt, axis, 0, k).to(x.device)
        elif boundary is Boundary.REFLECT:
            from_next = _edge(x, axis, size - k - 1, size - 1).flip(axis)
        else:
            from_next = torch.full_like(
                _edge(x, axis, 0, k),
                0.0 if boundary is Boundary.ZERO else float("nan"))
        out.append(torch.cat([from_prev, x, from_next], dim=axis))
    return out


def _apply_prepadded(f_taps: Callable, ext: torch.Tensor, k: int,
                     axes: Sequence[int], out_shape) -> torch.Tensor:
    """Run a tap-style elemental function on an already-grown block."""
    acc = TapAccessor.__new__(TapAccessor)
    acc._k = k
    acc._axes = tuple(axes)
    acc._p = ext
    acc._shape = out_shape
    return f_taps(acc)


def distributed_loop_of_stencil_reduce(
        f_taps: Callable, combine, cond: Callable, a: torch.Tensor, *,
        k: int, part: GridPartition, identity=None,
        boundary: Boundary | str = Boundary.ZERO, max_iters: int = 10_000,
        delta: Optional[Callable] = None, unroll: int = 1,
        stencil_axes: Sequence[int] | None = None, env=(),
        backend: str = "torch", block: Optional[tuple] = None
        ) -> LoopResult:
    """The pattern's 1:n mode over the shards of ``part``.

    ``backend="torch"`` re-aligns borders every sweep by growing the
    blocks (the plain path); ``backend="cuda-sharded"`` iterates the
    persistent per-shard frames with the edge-strip exchange and, with
    ``unroll=T``, one deep exchange per T fused sweeps.  Both share the
    pattern's repeat/until loop and the fold of the partial reduces; the
    loop runs on the partition's lead device, which receives the gathered
    grid.
    """
    if backend not in ("torch", "cuda-sharded"):
        raise ValueError(
            f"unknown distributed backend {backend!r}; "
            "choose 'torch' or 'cuda-sharded'")
    boundary = Boundary(boundary)
    pat = LoopOfStencilReduce(
        f=f_taps, k=k, combine=combine, identity=identity, cond=cond,
        delta=delta, boundary=boundary, max_iters=max_iters, unroll=unroll,
        backend=backend,
        partition=part if backend == "cuda-sharded" else None,
        block=block, device=part.lead)
    if backend == "cuda-sharded":
        return pat.run(a, env=env)

    op, ident = resolve_monoid(combine, identity)
    a = torch.as_tensor(a)
    st_axes = (tuple(stencil_axes) if stencil_axes is not None
               else tuple(range(a.ndim)))
    local_axes = tuple(ax for ax in st_axes if ax not in part.array_axes)
    env_blocks = [scatter_grid(e, part) for e in env]
    env_local = [tuple(e[i] for e in env_blocks)
                 for i in range(part.n_shards)]

    def local_steps(blocks):
        ext = list(blocks)
        for ax in part.array_axes:
            ext = exchange_halo(ext, k, ax, part, boundary)
        return [_apply_prepadded(
                    lambda g, e=e: f_taps(g, *e),
                    boundary.pad(x, k, axes=local_axes), k, st_axes,
                    b.shape)
                for x, b, e in zip(ext, blocks, env_local)]

    def step(blocks):
        prev, new = blocks, blocks
        for _ in range(unroll):
            prev, new = new, local_steps(new)
        partials = [tree_reduce(op, pat._measure(n, p), ident)
                    for n, p in zip(new, prev)]
        return new, collective_combine(op, partials)

    return pat._drive(scatter_grid(a, part), None, step=step,
                      state_view=lambda b: gather_grid(b, part),
                      finalize=lambda b: gather_grid(b, part))
