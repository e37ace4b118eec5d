"""Shared model layers: norms, RoPE, the dense MLP.

PyTorch twin of :mod:`repro.models.layers` (the dense part).  Parameters
live in :class:`torch.nn.Module`\\ s under the reference's names and
shapes; the functions take tensors and keep the reference's arithmetic:
norms and RoPE in float32, cast back to the input dtype.  ``moe`` and
``layer_norm`` come with a later slice (ROADMAP.md A8).
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    """``(1 + scale) · x / rms(x)``, in float32, cast to ``x``'s dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return ((1.0 + scale.float()) * out).to(x.dtype)


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
