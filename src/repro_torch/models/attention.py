"""Attention: GQA with RoPE, sliding-window (sequence-stencil) masking,
soft-capping, qk-norm, cross-attention and KV-cache decode.

PyTorch twin of :mod:`repro.models.attention`.  The grouped-query einsum
keeps K/V unrepeated ((B, S, KH, hd) throughout).  Train/prefill
self-attention may take the flash route, the hand-written kernel of
:mod:`repro_torch.kernels.swa_attention`, under the reference's own
condition; cross-attention never does.  Caches are written in place (the
reference returns new arrays); each call returns the cache dict it wrote.

Not in this slice: the int8 cache, the ragged ``kv_len`` mask and
per-sequence ``cache_pos`` (ROADMAP.md A9).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from .layers import apply_rope, normal, rms_norm, softcap, zeros

NEG_INF = -2.0 ** 30  # large-negative mask value, safe in bf16/f32

# Route train/prefill self-attention through the flash kernel.  None (the
# default) takes it when the tensors lie on a CUDA card — the port's twin of
# the reference's launcher flipping the flag on a TPU.  False forces the
# einsum route; True on CPU tensors runs the kernel's plain version (as the
# reference's CPU test runs its kernel in interpret mode).
USE_FLASH_SWA: Optional[bool] = None


def set_flash_swa(enabled: Optional[bool]):
    global USE_FLASH_SWA
    USE_FLASH_SWA = enabled


def _flash_enabled(device: torch.device) -> bool:
    if USE_FLASH_SWA is None:
        return device.type == "cuda"
    return USE_FLASH_SWA


class Attention(nn.Module):
    """``init_attention``'s parameters: ``wq`` (D, H, hd), ``wk``/``wv``
    (D, KH, hd), ``wo`` (H, hd, D), and with qk-norm ``q_norm``/``k_norm``
    (hd,) float32 zeros."""

    def __init__(self, d_model, num_heads, num_kv_heads, head_dim, *,
                 qk_norm=False, device, dtype, generator=None):
        super().__init__()
        g = dict(generator=generator, device=device, dtype=dtype)
        s = 1.0 / math.sqrt(d_model)
        so = 1.0 / math.sqrt(num_heads * head_dim)
        self.wq = normal((d_model, num_heads, head_dim), s, **g)
        self.wk = normal((d_model, num_kv_heads, head_dim), s, **g)
        self.wv = normal((d_model, num_kv_heads, head_dim), s, **g)
        self.wo = normal((num_heads, head_dim, d_model), so, **g)
        if qk_norm:
            self.q_norm = zeros((head_dim,), device=device)
            self.k_norm = zeros((head_dim,), device=device)


def _einsum(eq, a, b):
    """``torch.einsum`` with JAX's dtype promotion (a bf16 cache against
    float32 queries computes in float32)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


def _mask_bias(q_pos, k_pos, *, causal: bool, window: int):
    """Additive attention bias (B, Q, S) from position constraints: key j
    is visible to query i iff ``i - window < j <= i``; ring-buffer slots
    marked -1 are empty and never visible."""
    qp = q_pos[:, :, None]                       # (B, Q, 1)
    kp = k_pos[:, None, :]                       # (B|1, 1, S)
    ok = kp >= 0
    if causal:
        ok = ok & (kp <= qp)
    if window:
        ok = ok & (kp > qp - window)
    zero = torch.zeros((), dtype=torch.float32, device=ok.device)
    return torch.where(ok, zero, torch.full_like(zero, NEG_INF))


def attention(params: Attention, x, *, positions, num_heads, num_kv_heads,
              head_dim, rope_theta=10000.0, causal=True, window=0,
              attn_softcap=0.0, qk_norm=False, norm_eps=1e-6, x_kv=None,
              kv_cache: Optional[dict] = None, cache_pos=None, kv_len=None):
    """Returns (out, kv_cache or None), as the reference's ``attention``.

    Train/prefill: ``kv_cache=None``; keys and values from ``x``, or from
    ``x_kv`` for cross-attention (no RoPE, no mask there).  Decode:
    ``kv_cache={'k','v'}`` (B, S_cache, KH, hd), written at ``cache_pos``
    (an int, or a (1, 1) or 0-d tensor: one position for the whole batch),
    or a ring buffer ``{'k','v','pos'}`` of W slots for a sliding-window
    layer.  A cross cache (precomputed from the encoder output) is
    read-only."""
    if kv_len is not None:
        raise NotImplementedError(
            "the ragged kv_len mask belongs to a later slice of the port "
            "(ROADMAP.md A9)")
    if kv_cache is not None and "k_scale" in kv_cache:
        raise NotImplementedError(
            "the int8 KV cache belongs to a later slice of the port "
            "(ROADMAP.md A9)")
    B, S, D = x.shape
    q = torch.einsum("bsd,dhk->bshk", x, params.wq)
    if qk_norm:
        q = rms_norm(q, params.q_norm, norm_eps)
    is_cross = x_kv is not None

    new_cache = None
    if is_cross and kv_cache is not None:
        k, v = kv_cache["k"], kv_cache["v"]          # precomputed, read-only
        new_cache = kv_cache
    else:
        src = x_kv if is_cross else x
        k = torch.einsum("bsd,dhk->bshk", src, params.wk)
        v = torch.einsum("bsd,dhk->bshk", src, params.wv)
        if qk_norm:
            k = rms_norm(k, params.k_norm, norm_eps)
    if is_cross:
        k_pos = torch.arange(k.shape[1], device=x.device)[None, :]
    else:
        if rope_theta:
            # keys take the same absolute positions as the queries;
            # cache_pos only sets the write offset (prefill writes S keys)
            k = apply_rope(k, positions, rope_theta)
            q = apply_rope(q, positions, rope_theta)
        k_pos = positions
        if kv_cache is not None:
            pos0 = _uniform_pos(cache_pos)
            if "pos" in kv_cache:
                # ring buffer (sliding-window layers): slot = position mod W
                new_cache = _ring_write(kv_cache, k, v, positions)
                if S == 1:
                    k, v, k_pos = (kv_cache["k"], kv_cache["v"],
                                   kv_cache["pos"])
                # a prefill chunk attends its OWN keys (the ring keeps
                # only the last W); single-chunk prefill from position 0
                # is the engine's contract
            else:
                k = _scatter_cache(kv_cache["k"], k, pos0)
                v = _scatter_cache(kv_cache["v"], v, pos0)
                new_cache = kv_cache
                k_pos = torch.arange(k.shape[1], device=x.device)[None, :]

    if (_flash_enabled(x.device) and kv_cache is None and not is_cross
            and causal and S % 128 == 0 and not qk_norm and kv_len is None):
        # flash route: (B,S,H,hd) -> (B·H,S,hd); kv stay per-group (at
        # B=1 the reshape is a strided view, so copy to the kernel's layout)
        from ..kernels.swa_attention import swa_attention
        qf, kf, vf = (t.transpose(1, 2).reshape(B * t.shape[2], S, head_dim)
                      .contiguous() for t in (q, k, v))
        of = swa_attention(qf, kf, vf, window=window, causal=True,
                           softcap=attn_softcap)
        out = of.reshape(B, num_heads, S, head_dim).transpose(1, 2)
        return torch.einsum("bqhk,hkd->bqd", out, params.wo), new_cache

    # grouped-query attention einsum: (B,S,KH,G,hd) vs (B,T,KH,hd)
    G = num_heads // num_kv_heads
    qg = q.reshape(B, S, num_kv_heads, G, head_dim)
    scores = _einsum("bqhgk,bshk->bhgqs", qg, k).float()
    scores = scores * float(1.0 / math.sqrt(head_dim))
    if attn_softcap:
        scores = softcap(scores, attn_softcap)
    bias = _mask_bias(positions, k_pos, causal=causal and not is_cross,
                      window=0 if is_cross else window)
    scores = scores + bias[:, None, None]            # (B,1,1,Q,S)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    del scores
    out = _einsum("bhgqs,bshk->bqhgk", probs, v)
    out = out.reshape(B, S, num_heads, head_dim)
    return _einsum("bqhk,hkd->bqd", out, params.wo), new_cache


def _uniform_pos(cache_pos) -> int:
    """The one write position of a uniform batch (an int, or a 0-d or
    (1, 1) tensor); per-sequence positions raise."""
    if isinstance(cache_pos, torch.Tensor):
        if cache_pos.numel() != 1:
            raise NotImplementedError(
                "per-sequence cache positions (continuous batching) belong "
                "to a later slice of the port (ROADMAP.md A9)")
        return int(cache_pos.reshape(()))
    return int(cache_pos)


def _ring_write(cache, k, v, positions):
    """Write S_new keys into the W-slot ring at slots ``pos mod W``, in
    place.  Keys are stored post-RoPE, so the ring only remembers each
    slot's absolute position for masking (-1 = empty).  When S_new ≥ W
    only the last W entries survive."""
    W = cache["k"].shape[1]
    S_new = k.shape[1]
    pos_row = positions[0]                        # uniform across batch
    if S_new >= W:
        keep = slice(S_new - W, S_new)
        k, v, pos_row = k[:, keep], v[:, keep], pos_row[keep]
    idx = pos_row % W
    cache["k"][:, idx] = k.to(cache["k"].dtype)
    cache["v"][:, idx] = v.to(cache["v"].dtype)
    cache["pos"][:, idx] = pos_row.to(torch.int32)[None]
    return cache


def _scatter_cache(cache, new, pos0: int):
    """Write (B, S_new, KH, hd) at row ``pos0`` of the cache, in place; the
    start is clamped so the rows fit, as ``dynamic_update_slice`` does."""
    S_new = new.shape[1]
    start = min(max(pos0, 0), cache.shape[1] - S_new)
    cache[:, start:start + S_new] = new.to(cache.dtype)
    return cache


def init_kv_cache(batch, max_seq, num_kv_heads, head_dim,
                  dtype=torch.bfloat16, window: int = 0, *, device):
    """Decode cache.  Sliding-window layers with ``window < max_seq`` get a
    ring buffer of W slots plus a per-slot absolute-position array
    (-1 = empty)."""
    if window and window < max_seq:
        z = torch.zeros((batch, window, num_kv_heads, head_dim), dtype=dtype,
                        device=device)
        return {"k": z, "v": torch.zeros_like(z),
                "pos": torch.full((batch, window), -1, dtype=torch.int32,
                                  device=device)}
    z = torch.zeros((batch, max_seq, num_kv_heads, head_dim), dtype=dtype,
                    device=device)
    return {"k": z, "v": torch.zeros_like(z)}
