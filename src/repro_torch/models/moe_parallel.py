"""Expert-parallel MoE dispatch on the port's mesh.

PyTorch twin of :mod:`repro.models.moe_parallel`.  The reference runs one
``shard_map`` program per device; the port is single-controller, as its
sharded stencil tier is (:mod:`repro_torch.sharding`), so one process
drives every shard of a :class:`~repro_torch.sharding.Mesh` in mesh order:

* tokens are split over the data axes that divide the batch (the others
  hold replicas, computed once) and go whole to every model shard;
* model shard ``m`` holds experts ``m·E/tp .. (m+1)·E/tp`` and dispatches
  only into them, with the capacity of its data shard,
  ``C_loc = ceil(T_loc·k/E · cf)``;
* the partial outputs of a data shard are summed on the lead device in
  model-shard order (the reference's ``psum``), and the aux terms are
  averaged over the data shards (its ``pmean``\\ s);
* the shared expert runs on the whole batch.

On a mesh that repeats a device, a shard's expert slice is a view of the
stacked weights, not a copy.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..sharding.specs import Mesh
from .layers import (MoE, capacity, expert_ffn, mlp, moe_aux, route,
                     sort_assignments)

EP_AXIS = "model"   # the mesh axis the experts are split over


def data_axes(mesh: Mesh, dp_axes: Sequence[str], batch: int) -> tuple:
    """The data axes the batch is split over: each of ``dp_axes`` in turn
    whose size divides what is left of the batch (B = 1 stays whole)."""
    dp, rem = [], batch
    for ax in dp_axes:
        n = mesh.shape[ax]
        if rem % n == 0:
            dp.append(ax)
            rem //= n
    return tuple(dp)


def _shard_device(mesh: Mesh, coords: dict) -> torch.device:
    """The device at ``coords`` (axis name -> index; other axes at 0)."""
    at = tuple(coords.get(name, 0) for name in mesh.axis_names)
    return mesh.devices[at]


def expert_parallel_moe(params: MoE, x: torch.Tensor, *, top_k: int,
                        act: str, capacity_factor: float, mesh: Mesh,
                        dp_axes: Sequence[str]):
    """Drop-in for :func:`repro_torch.models.layers.moe` on ``mesh``.
    Returns (y, aux) on ``x``'s device."""
    B, S, D = x.shape
    E = params.w_up.shape[0]
    tp = mesh.shape[EP_AXIS]
    if E % tp:
        raise ValueError(f"{E} experts do not split over {tp} model shards")
    e_loc = E // tp
    dp = data_axes(mesh, dp_axes, B)
    dp_shape = tuple(mesh.shape[ax] for ax in dp)
    n_dp = int(np.prod(dp_shape, dtype=np.int64))
    lead = mesh.devices.flat[0]
    b_loc = B // n_dp

    ys, auxes = [], []
    for d in range(n_dp):                      # data shards, row-major
        coords = dict(zip(dp, np.unravel_index(d, dp_shape)))
        xt = x[d * b_loc:(d + 1) * b_loc].reshape(-1, D)
        C = capacity(xt.shape[0], top_k, E, capacity_factor, False)
        y = aux = None
        for m in range(tp):                    # model shards, in order
            dev = _shard_device(mesh, dict(coords, **{EP_AXIS: m}))
            xs = xt.to(dev)
            logits, probs, top_p, top_i = route(params.router.to(dev), xs,
                                                top_k)
            a = sort_assignments(top_i, top_p)
            local = (a.eid >= m * e_loc) & (a.eid < (m + 1) * e_loc)
            sl = slice(m * e_loc, (m + 1) * e_loc)
            part = expert_ffn(xs, a, (a.pos < C) & local,
                              params.w_gate[sl].to(dev),
                              params.w_up[sl].to(dev),
                              params.w_down[sl].to(dev), e_first=m * e_loc,
                              capacity=C, act=act).to(lead)
            y = part if y is None else y + part
            if aux is None:                    # equal on every model shard
                aux = moe_aux(logits, probs, top_i, a.pos, C)
        ys.append(y.reshape(b_loc, S, D))
        auxes.append(torch.stack([aux["lb_loss"], aux["router_z"],
                                  aux["drop_frac"]]).to(lead))
    y = torch.cat(ys, dim=0).to(x.device)
    # the pmeans: over each data axis in turn (a mean of equal-size means)
    aux_v = torch.stack(auxes).reshape(dp_shape + (3,))
    for _ in dp:
        aux_v = aux_v.mean(dim=0)
    aux_v = aux_v.to(x.device)
    if hasattr(params, "shared"):
        y = y + mlp(params.shared, x.reshape(-1, D), act).reshape(x.shape)
    return y, {"lb_loss": aux_v[0], "router_z": aux_v[1],
               "drop_frac": aux_v[2]}
