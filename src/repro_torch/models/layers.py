"""Shared model layers: norms, RoPE, sinusoidal positions, the dense MLP,
the token-choice MoE.

PyTorch twin of :mod:`repro.models.layers`.  Parameters live in
:class:`torch.nn.Module`\\ s under the reference's names and shapes; the
functions take tensors and keep the reference's arithmetic: norms and RoPE
in float32, cast back to the input dtype; the MoE router in float32 end to
end.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import obs

# the MoE layer's spans (repro_torch.obs): timed on the device in an eager
# forward, inside the model's other work, so they take no part in idle
MOE_SPANS = ("moe.route", "moe.dispatch", "moe.experts", "moe.combine",
             "moe.shared")


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    """``(1 + scale) · x / rms(x)``, in float32, cast to ``x``'s dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return ((1.0 + scale.float()) * out).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5):
    """``(x - mean) / sqrt(var + eps) · scale + bias`` (population
    variance), in float32, cast to ``x``'s dtype.  No model calls it, as in
    the reference."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * scale + bias).to(x.dtype)


def softcap(x: torch.Tensor, cap: float):
    """Gemma-2 style logit soft-capping: cap·tanh(x/cap)."""
    if not cap:
        return x
    return cap * torch.tanh(x / cap)


ACTS = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
}


# -- RoPE -------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


@functools.lru_cache(maxsize=None)
def _rope_freqs_on(head_dim: int, theta: float, device: torch.device):
    """:func:`rope_freqs` as float32 on ``device``, copied there once: a
    copy from host memory per call would stall the host on the device."""
    return torch.as_tensor(rope_freqs(head_dim, theta).astype(np.float32),
                           device=device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: (..., S, H, hd); positions: broadcastable to (..., S).  The
    frequencies come from float64 numpy cast to float32, and the rotation
    runs in float32."""
    hd = x.shape[-1]
    freqs = _rope_freqs_on(hd, float(theta), x.device)
    ang = positions[..., None].float() * freqs                # (..., S, hd/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(seq: int, dim: int) -> np.ndarray:
    """Whisper-style fixed sinusoidal embeddings (seq, dim): sines then
    cosines, computed in float64 numpy and returned as float32."""
    pos = np.arange(seq)[:, None]
    inv = 1.0 / (10000 ** (np.arange(0, dim, 2) / dim))
    ang = pos * inv[None, :]
    return np.concatenate([np.sin(ang), np.cos(ang)],
                          axis=-1).astype(np.float32)


# -- init helpers -----------------------------------------------------------

def normal(shape, scale: float, *, generator, device, dtype) -> nn.Parameter:
    """``N(0, 1) · scale`` drawn in ``dtype`` (as the reference draws in
    the model dtype, then scales); a frozen parameter.  ``generator=None``
    leaves the storage uninitialised, for a caller that copies weights in
    (:func:`repro_torch.interop.params_from_reference`)."""
    if generator is None:
        w = torch.empty(shape, device=device, dtype=dtype)
    else:
        w = torch.randn(shape, generator=generator, device=device,
                        dtype=dtype).mul_(scale)
    return nn.Parameter(w, requires_grad=False)


def zeros(shape, *, device) -> nn.Parameter:
    """A float32 zero parameter (norm scales)."""
    return nn.Parameter(torch.zeros(shape, device=device,
                                    dtype=torch.float32),
                        requires_grad=False)


# -- MLP --------------------------------------------------------------------

class MLP(nn.Module):
    """``init_mlp``'s parameters: ``up`` (D, F), ``down`` (F, D) and, when
    gated, ``gate`` (D, F)."""

    def __init__(self, d_model: int, d_ff: int, gated: bool, *, device,
                 dtype, generator=None):
        super().__init__()
        g = dict(generator=generator, device=device, dtype=dtype)
        s_in, s_out = 1.0 / math.sqrt(d_model), 1.0 / math.sqrt(d_ff)
        self.up = normal((d_model, d_ff), s_in, **g)
        self.down = normal((d_ff, d_model), s_out, **g)
        if gated:
            self.gate = normal((d_model, d_ff), s_in, **g)


def mlp(params: MLP, x: torch.Tensor, act: str = "silu"):
    a = ACTS[act]
    up = x @ params.up
    h = a(x @ params.gate) * up if hasattr(params, "gate") else a(up)
    return h @ params.down


# -- MoE --------------------------------------------------------------------

class MoE(nn.Module):
    """``init_moe``'s parameters: ``router`` (D, E) float32, ``w_up`` and
    ``w_gate`` (E, D, F), ``w_down`` (E, F, D) in the model dtype (experts
    stacked on a leading axis, so a mesh shard's experts are a slice), and
    with shared experts ``shared``, an :class:`MLP` of ``shared_d_ff``."""

    def __init__(self, d_model: int, n_experts: int, expert_d_ff: int,
                 n_shared: int, shared_d_ff: int, gated: bool, *, device,
                 dtype, generator=None):
        super().__init__()
        g = dict(generator=generator, device=device, dtype=dtype)
        s_in, s_out = 1.0 / math.sqrt(d_model), 1.0 / math.sqrt(expert_d_ff)
        self.router = normal((d_model, n_experts), s_in,
                             **dict(g, dtype=torch.float32))
        self.w_up = normal((n_experts, d_model, expert_d_ff), s_in, **g)
        self.w_gate = normal((n_experts, d_model, expert_d_ff), s_in, **g)
        self.w_down = normal((n_experts, expert_d_ff, d_model), s_out, **g)
        if n_shared:
            self.shared = MLP(d_model, shared_d_ff, gated, **g)


def route(router: torch.Tensor, xt: torch.Tensor, top_k: int):
    """The router, in float32 end to end: (logits, probs, top_p, top_i)
    for tokens ``xt`` (T, D).  The top k come from a stable descending
    sort, so equal probabilities pick the lower expert id first, as
    ``lax.top_k`` does; ``top_p`` is renormalised (clamped at 1e-9)."""
    logits = xt.float() @ router
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[:, :top_k], top_i[:, :top_k]
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    return logits, probs, top_p, top_i


class Assignments(NamedTuple):
    """The (token, choice) assignments sorted by expert: the permutation
    from the flat (T·k,) order, and in sorted order each one's expert,
    token, weight and rank within its expert."""
    order: torch.Tensor
    eid: torch.Tensor
    tid: torch.Tensor
    wgt: torch.Tensor
    pos: torch.Tensor


def sort_assignments(top_i: torch.Tensor, top_p: torch.Tensor):
    """Flatten the (token, choice) assignments and sort them by expert id,
    stably, so earlier tokens win a full expert."""
    T, k = top_i.shape
    eid, order = torch.sort(top_i.reshape(-1), stable=True)
    first = torch.searchsorted(eid, eid, side="left")
    return Assignments(order, eid, torch.div(order, k, rounding_mode="floor"),
                       top_p.reshape(-1)[order],
                       torch.arange(T * k, device=top_i.device) - first)


def dispatch_index(keep, le, pos, e_loc: int):
    """Where each sorted assignment lands in the (e_loc + 1, C, D)
    dispatch buffer: a kept one at (its local expert, its rank); a dropped
    or non-local one at row ``e_loc``, which is sliced away.  (The
    reference routes those out of bounds, where ``mode="drop"`` discards
    them; an in-range clamp would overwrite slot (e, 0).)"""
    return torch.where(keep, le, e_loc), torch.where(keep, pos, 0)


def dispatch(xt, a: Assignments, keep, *, e_first: int, e_loc: int,
             capacity: int):
    """Scatter the kept assignments' token rows into an (e_loc, C, D)
    buffer (experts ``e_first .. e_first + e_loc``).  Returns (xe, le, pc):
    the buffer and each sorted assignment's row and slot in it."""
    le, pc = dispatch_index(keep, a.eid - e_first, a.pos, e_loc)
    xe = xt.new_zeros((e_loc + 1, capacity, xt.shape[1]))
    xe[le, pc] = xt[a.tid]
    return xe[:e_loc], le, pc


def experts(xe, w_gate, w_up, w_down, act: str):
    """Every expert on its capacity rows: three batched products."""
    h = ACTS[act](torch.bmm(xe, w_gate)) * torch.bmm(xe, w_up)
    return torch.bmm(h, w_down)


def combine(ye, a: Assignments, keep, le, pc, T: int):
    """The weighted expert rows back in token order, deterministically:
    each token's k rows are gathered in ascending expert order (as the
    reference's scatter-add applies them) and summed in the model dtype
    from zeros, with no atomics.  The weights are cast to the model dtype
    before the product, as the reference does."""
    k = a.order.numel() // T
    back = ye[torch.where(keep, le, 0), pc] \
        * (a.wgt * keep).to(ye.dtype)[:, None]
    inv = torch.empty_like(a.order)
    inv[a.order] = torch.arange(a.order.numel(), device=a.order.device)
    rows = back[inv.view(T, k).sort(dim=1).values]            # (T, k, D)
    y = torch.zeros((T, ye.shape[-1]), dtype=ye.dtype, device=ye.device)
    for c in range(k):
        y = y + rows[:, c]
    return y


def expert_ffn(xt, a: Assignments, keep, w_gate, w_up, w_down, *,
               e_first: int, capacity: int, act: str):
    """Dispatch the kept assignments, run the experts ``e_first ..
    e_first + E_loc`` and combine their weighted rows in token order."""
    dev = xt.device
    with obs.span("moe.dispatch", device=dev, idle=False):
        xe, le, pc = dispatch(xt, a, keep, e_first=e_first,
                              e_loc=w_up.shape[0], capacity=capacity)
    with obs.span("moe.experts", device=dev, idle=False):
        ye = experts(xe, w_gate, w_up, w_down, act)
    del xe
    with obs.span("moe.combine", device=dev, idle=False):
        return combine(ye, a, keep, le, pc, xt.shape[0])


def moe_aux(logits, probs, top_i, pos_s, capacity: int) -> dict:
    """Switch-style load-balance loss, the router z-loss and the share of
    assignments past capacity, all float32."""
    T, E = probs.shape
    flat = top_i.reshape(-1)
    # scatter_add_ of ones: bincount's counts at a static (E,) shape, which
    # the meta device traces (bincount has no meta kernel)
    counts = torch.zeros(E, dtype=flat.dtype, device=flat.device) \
        .scatter_add_(0, flat, torch.ones_like(flat)).float()
    ce = counts / (T * top_i.shape[1])
    return {"lb_loss": E * torch.sum(probs.mean(dim=0) * ce),
            "router_z": torch.mean(torch.logsumexp(logits, dim=-1) ** 2),
            "drop_frac": 1.0 - (pos_s < capacity).float().mean()}


def capacity(T: int, top_k: int, E: int, capacity_factor: float,
             dropless: bool) -> int:
    """Per-expert capacity ``C = ceil(T·k/E · cf)`` (at least 1); ``T``
    when dropless (one expert may take every token)."""
    if dropless:
        return T
    return max(1, int(math.ceil(T * top_k / E * capacity_factor)))


def moe(params: MoE, x: torch.Tensor, *, top_k: int, act: str = "silu",
        capacity_factor: float = 1.25, dropless: bool = False):
    """Token-choice top-k MoE with capacity-based sorted dispatch
    (GShard-style), as the reference: route in float32, sort the
    assignments by expert, rank each token within its expert, drop past
    capacity, run the experts batched, combine weighted.  Returns (y,
    aux) with ``lb_loss``, ``router_z`` and ``drop_frac``."""
    B, S, D = x.shape
    E = params.w_up.shape[0]
    xt = x.reshape(-1, D)
    C = capacity(xt.shape[0], top_k, E, capacity_factor, dropless)
    with obs.span("moe.route", device=x.device, idle=False):
        logits, probs, top_p, top_i = route(params.router, xt, top_k)
        a = sort_assignments(top_i, top_p)
        keep = a.pos < C
    y = expert_ffn(xt, a, keep, params.w_gate, params.w_up, params.w_down,
                   e_first=0, capacity=C, act=act)
    if hasattr(params, "shared"):
        with obs.span("moe.shared", device=x.device, idle=False):
            y = y + mlp(params.shared, xt, act)
    return y.reshape(B, S, D), moe_aux(logits, probs, top_i, a.pos, C)
