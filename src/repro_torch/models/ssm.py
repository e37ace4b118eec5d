"""Mamba-2 (SSD, state-space duality — arXiv:2405.21060).

PyTorch twin of :mod:`repro.models.ssm`, in the pattern's vocabulary:

* the depthwise causal conv (width 4) is a one-sided 1-D stencil along
  the sequence;
* the chunked scan is a stencil with a carry: quadratic attention-like
  work within a chunk plus a linear recurrence between chunk states (the
  reference's ``lax.scan`` over chunks is a loop over chunks here, the
  state in float32);
* decode keeps O(1) state: the conv's last W-1 inputs and ``h``.

Scalar-per-head A (the Mamba-2 restriction), grouped B/C (ngroups=1).
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import normal, rms_norm

CHUNK = 128  # SSD chunk length


def ssm_dims(d_model: int, expand: int = 2, head_dim: int = 64,
             state: int = 128, conv_width: int = 4, ngroups: int = 1):
    d_inner = expand * d_model
    nheads = d_inner // head_dim
    return dict(d_inner=d_inner, nheads=nheads, head_dim=head_dim,
                state=state, conv_width=conv_width, ngroups=ngroups)


def _f32(values: np.ndarray, device) -> nn.Parameter:
    return nn.Parameter(torch.as_tensor(values.astype(np.float32),
                                        device=device), requires_grad=False)


class SSM(nn.Module):
    """``init_ssm``'s parameters: ``in_proj`` (D, 2·di + 2·g·n + nh)
    emitting [z, x, B, C, dt], ``conv_w`` (W, di + 2·g·n), ``conv_b``
    (zeros), ``out_proj`` (di, D) in the model dtype; ``A_log`` (log of
    1..16 over the heads), ``D`` (ones), ``dt_bias`` (the reference's draw
    from ``np.random.default_rng(0)``) and ``norm`` (zeros) in float32."""

    def __init__(self, d_model: int, dims: dict, *, device, dtype,
                 generator=None):
        super().__init__()
        g = dict(generator=generator, device=device, dtype=dtype)
        di, nh, n, cw = (dims["d_inner"], dims["nheads"], dims["state"],
                         dims["conv_width"])
        gn = dims["ngroups"] * n
        self.in_proj = normal((d_model, 2 * di + 2 * gn + nh),
                              1.0 / math.sqrt(d_model), **g)
        self.conv_w = normal((cw, di + 2 * gn), 0.2, **g)
        self.conv_b = nn.Parameter(torch.zeros((di + 2 * gn,), device=device,
                                               dtype=dtype),
                                   requires_grad=False)
        self.A_log = _f32(np.log(np.linspace(1.0, 16.0, nh)
                                 .astype(np.float32)), device)
        self.D = _f32(np.ones((nh,)), device)
        self.dt_bias = _f32(np.log(np.expm1(np.random.default_rng(0)
                                            .uniform(1e-3, 0.1, nh))), device)
        self.norm = _f32(np.zeros((di,)), device)
        self.out_proj = normal((di, d_model), 1.0 / math.sqrt(di), **g)


def _einsum(eq, *ops):
    """``torch.einsum`` with JAX's dtype promotion (bf16 with float32
    computes in float32)."""
    dt = ops[0].dtype
    for o in ops[1:]:
        dt = torch.promote_types(dt, o.dtype)
    return torch.einsum(eq, *(o.to(dt) for o in ops))


def causal_conv(x, w, b, cache: Optional[torch.Tensor] = None):
    """Depthwise causal conv along the sequence (a one-sided 1-D stencil).

    x: (B, S, C); w: (W, C).  With ``cache`` (B, W-1, C), the inputs
    before ``x``: returns (silu(y), new_cache), else (silu(y), None)."""
    W = w.shape[0]
    if cache is None:
        xp = F.pad(x, (0, 0, W - 1, 0))
        new_cache = None
    else:
        xp = torch.cat([cache.to(x.dtype), x], dim=1)
        new_cache = xp[:, -(W - 1):].to(cache.dtype)
    S = x.shape[1]
    # taps: y_t = sum_w x_{t-(W-1)+w} · w_w
    y = sum(xp[:, i:i + S] * w[i] for i in range(W)) + b
    return F.silu(y), new_cache


def _heads(t, nh: int):
    """Broadcast (Bt, S, g, n) groups over the heads."""
    g = t.shape[2]
    return t if g == nh else t.repeat_interleave(nh // g, dim=2)


def ssd_chunked(x, dt, A, B, C, D, *, dims, h0=None):
    """SSD over a full sequence (scoring / prefill).

    x: (Bt, S, nh, hd); dt: (Bt, S, nh) float32; A: (nh,) log-rates (the
    decay is -exp(A)); B, C: (Bt, S, g, n).  Returns (y, h_last), h:
    (Bt, nh, hd, n) float32.  Within a chunk the masked (C·Bᵀ) kernel;
    between chunks the recurrence over chunk states, a loop over chunks."""
    Bt, S, nh, hd = x.shape
    n = dims["state"]
    Q = min(CHUNK, S)
    S_orig = S
    if S % Q:
        # dt = 0 steps: exp(0) = 1 keeps the state and dt·x·B adds nothing,
        # so the padding is exactly inert
        pad = Q - S % Q
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
        S = S + pad
    nc = S // Q
    xc = x.reshape(Bt, nc, Q, nh, hd)
    dtc = dt.reshape(Bt, nc, Q, nh)
    Bc = _heads(B, nh).reshape(Bt, nc, Q, nh, n)
    Cc = _heads(C, nh).reshape(Bt, nc, Q, nh, n)

    dA = dtc * (-torch.exp(A))[None, None, None, :]      # log-decay <= 0
    La = torch.cumsum(dA, dim=2)                          # (Bt,nc,Q,nh)
    Ltot = La[:, :, -1]                                   # (Bt,nc,nh)

    # intra-chunk: y_i = sum_{j<=i} exp(La_i - La_j) (C_i·B_j) dt_j x_j
    CB = _einsum("bcqhn,bckhn->bchqk", Cc, Bc)            # (Bt,nc,nh,Q,Q)
    Li = La.permute(0, 1, 3, 2)                           # (Bt,nc,nh,Q)
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    # the exponent is masked before the exp (the reference masks after):
    # above the diagonal La_i - La_j > 0 overflows once a chunk's decay
    # spans ~88, and the where's backward would take 0 · inf = NaN into
    # every gradient; the kept entries' values are the same
    decay = torch.exp(torch.where(mask, Li[..., :, None] - Li[..., None, :],
                                  -math.inf))
    kernel = torch.where(mask, CB * decay, 0.0)
    del CB, decay
    dx = dtc[..., None] * xc                              # (Bt,nc,Q,nh,hd)
    y_intra = _einsum("bchqk,bckhp->bcqhp", kernel, dx)
    del kernel

    # chunk states: S_c = sum_j exp(Ltot - La_j) dt_j x_j (x) B_j
    sdecay = torch.exp(Ltot[:, :, None] - La)             # (Bt,nc,Q,nh)
    states = _einsum("bcqh,bcqhp,bcqhn->bchpn", sdecay, dx, Bc)

    # inter-chunk recurrence: h_c = exp(Ltot_c) h_{c-1} + S_c (the carry)
    h = (torch.zeros((Bt, nh, hd, n), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = torch.exp(Ltot[:, c])[..., None, None] * h + states[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)                 # (Bt,nc,nh,hd,n)

    # inter-chunk contribution: y_i += exp(La_i) C_i · h_{c-1}
    y_inter = _einsum("bcqh,bcqhn,bchpn->bcqhp", torch.exp(La), Cc, h_prevs)
    y = (y_intra + y_inter).reshape(Bt, S, nh, hd)
    y = y + D[None, None, :, None] * x
    return y[:, :S_orig].to(x.dtype), h


def ssd_ref(x, dt, A, B, C, D, *, dims, h0=None):
    """Sequential-scan oracle for :func:`ssd_chunked` (S steps); decode's
    single step."""
    Bt, S, nh, hd = x.shape
    n = dims["state"]
    Bh, Ch = _heads(B, nh), _heads(C, nh)
    h = (torch.zeros((Bt, nh, hd, n), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    decay = -torch.exp(A)[None, :]
    ys = []
    for t in range(S):
        a = torch.exp(dt[:, t] * decay)                    # (Bt,nh)
        h = a[..., None, None] * h + _einsum(
            "bh,bhp,bhn->bhpn", dt[:, t], x[:, t], Bh[:, t])
        ys.append(_einsum("bhn,bhpn->bhp", Ch[:, t], h))
    y = torch.stack(ys, dim=1) + D[None, None, :, None] * x
    return y.to(x.dtype), h


def softplus(x):
    """``jax.nn.softplus``: log(1 + e^x) with no switch to the identity."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def mamba2_block(params: SSM, x, *, dims, norm_eps=1e-6,
                 ssm_cache: Optional[dict] = None, use_ref=False):
    """The Mamba-2 block.  Returns (out, cache or None).

    cache = {'conv': (B, W-1, di+2gn), 'h': (B, nh, hd, n)}, written in
    place (as the port's KV caches are).  Decode (S = 1 with a cache)
    takes the sequential step, prefill the chunked form from ``h``."""
    Bt, S, _ = x.shape
    di, nh, hd, n = (dims["d_inner"], dims["nheads"], dims["head_dim"],
                     dims["state"])
    gn = dims["ngroups"] * n
    proj = x @ params.in_proj
    z, xs, Bv, Cv, dt = torch.split(proj, [di, di, gn, gn, nh], dim=-1)
    conv_in = torch.cat([xs, Bv, Cv], dim=-1)
    conv_out, new_conv = causal_conv(
        conv_in, params.conv_w, params.conv_b,
        None if ssm_cache is None else ssm_cache["conv"])
    xs, Bv, Cv = torch.split(conv_out, [di, gn, gn], dim=-1)
    xs = xs.reshape(Bt, S, nh, hd)
    Bv = Bv.reshape(Bt, S, dims["ngroups"], n)
    Cv = Cv.reshape(Bt, S, dims["ngroups"], n)
    dt = softplus(dt.float() + params.dt_bias[None, None, :])

    h0 = None if ssm_cache is None else ssm_cache["h"]
    step = ssd_ref if use_ref or (ssm_cache is not None and S == 1) \
        else ssd_chunked
    y, h_last = step(xs, dt, params.A_log, Bv, Cv, params.D, dims=dims,
                     h0=h0)
    y = y.reshape(Bt, S, di)
    # gated RMSNorm (Mamba-2): norm(y * silu(z))
    y = rms_norm(y * F.silu(z), params.norm, norm_eps)
    out = y @ params.out_proj
    if ssm_cache is not None:
        ssm_cache["conv"].copy_(new_conv)
        ssm_cache["h"].copy_(h_last)
    return out, ssm_cache


def init_ssm_cache(batch, dims, dtype=torch.float32, *, device):
    """The conv cache in the model dtype (it joins activations directly);
    the recurrent state ``h`` in float32 (the recurrence stays exact)."""
    di, nh, hd, n = (dims["d_inner"], dims["nheads"], dims["head_dim"],
                     dims["state"])
    cw, g = dims["conv_width"], dims["ngroups"]
    return {"conv": torch.zeros((batch, cw - 1, di + 2 * g * n), dtype=dtype,
                                device=device),
            "h": torch.zeros((batch, nh, hd, n), dtype=torch.float32,
                             device=device)}
