"""Attention: GQA with RoPE, sliding-window (sequence-stencil) masking,
soft-capping, qk-norm, cross-attention and KV-cache decode.

PyTorch twin of :mod:`repro.models.attention`.  The grouped-query einsum
keeps K/V unrepeated ((B, S, KH, hd) throughout).  Train/prefill
self-attention may take the flash route, the hand-written kernel of
:mod:`repro_torch.kernels.swa_attention`, under the reference's own
condition; cross-attention never does.  Caches are written in place (the
reference returns new arrays); each call returns the cache dict it wrote.

Cached single-token decode over a full bf16 cache on the card takes the
hand-written decode kernel (:mod:`repro_torch.kernels.decode_attention`),
which reads the pool in place over each sequence's visible keys; ring,
int8 and cross caches, other dtypes, S > 1 and the CPU keep the einsum.
:data:`decode_route_calls` counts the cached-decode calls of each route.

Cache positions are device tensors on the serving paths: a (B, 1)
``cache_pos`` writes each sequence at its own depth (continuous batching),
and a ragged prefill's ``kv_len`` masks the pad keys of right-padded
prompts; neither is read on the host.  ``init_kv_cache(quant=True)`` gives
the int8 cache (per-(token, kv-head) scales).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..kernels import decode_attention as decode_kernel
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


# Cached single-token attention calls (S == 1 over a cache) by route, as
# Python issues them: a captured CUDA graph's replays add nothing here (the
# engine counts one step's calls times the steps it issued).
decode_route_calls = {"kernel": 0, "einsum": 0}


def _on_card(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def _decode_kernel_takes(q, k, kv_cache, *, is_cross: bool,
                         causal: bool) -> bool:
    """Whether a cached decode call takes the decode kernel: a full cache
    (no ring, not int8, not a cross cache) read causally, on the card, with
    a bf16 query and cache and a head layout the kernel has."""
    return (not is_cross and causal and "pos" not in kv_cache
            and "k_scale" not in kv_cache and _on_card(q)
            and q.dtype == torch.bfloat16 and k.dtype == q.dtype
            and decode_kernel.takes(q.shape[2], k.shape[2], q.shape[3]))


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


def _mask_bias(q_pos, k_pos, *, causal: bool, window: int, kv_len=None):
    """Additive attention bias (B, Q, S) from position constraints: key j
    is visible to query i iff ``i - window < j <= i``; ring-buffer slots
    marked -1 are empty and never visible.  ``kv_len`` ((B,) or (B, 1)
    int, a ragged prefill's prompt lengths): keys at positions >= the
    sequence's own length are pads, invisible to every query."""
    qp = q_pos[:, :, None]                       # (B, Q, 1)
    kp = k_pos[:, None, :]                       # (B|1, 1, S)
    ok = kp >= 0
    if causal:
        ok = ok & (kp <= qp)
    if window:
        ok = ok & (kp > qp - window)
    if kv_len is not None:
        ok = ok & (kp < kv_len.reshape(-1)[:, None, None])
    zero = torch.zeros((), dtype=torch.float32, device=ok.device)
    return torch.where(ok, zero, torch.full_like(zero, NEG_INF))


def attention(params: Attention, x, *, positions, num_heads, num_kv_heads,
              head_dim, rope_theta=10000.0, causal=True, window=0,
              attn_softcap=0.0, qk_norm=False, norm_eps=1e-6, x_kv=None,
              kv_cache: Optional[dict] = None, cache_pos=None, kv_len=None):
    """Returns (out, kv_cache or None), as the reference's ``attention``.

    Train/prefill: ``kv_cache=None``; keys and values from ``x``, or from
    ``x_kv`` for cross-attention (no RoPE, no mask there).  Decode:
    ``kv_cache={'k','v'}`` (B, S_cache, KH, hd), written at ``cache_pos``:
    an int or a 0-d or (1, 1) tensor (one position for the whole batch), or
    a (B, 1) tensor (each sequence at its own depth); the int8 cache
    ``{'k','v','k_scale','v_scale'}`` is written quantised and read
    dequantised; a ring buffer ``{'k','v','pos'}`` of W slots serves a
    sliding-window layer.  A cross cache (precomputed from the encoder
    output) is read-only.

    ``kv_len`` ((B,) int, a ragged prefill of right-padded prompts): pad
    keys are masked out of every window, and a ring keeps each sequence's
    own last ``min(W, len)`` real keys.  A full cache may keep pad rows:
    decode overwrites row ``len + t - 1`` before any query reaches it."""
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
        if kv_cache is not None and "pos" in kv_cache:
            # ring buffer (sliding-window layers): slot = position mod W
            ragged = isinstance(cache_pos, torch.Tensor) and \
                cache_pos.numel() > 1
            new_cache = _ring_write(kv_cache, k, v, positions,
                                    ragged=ragged,
                                    kv_len=kv_len if S > 1 else None)
            if S == 1:
                k, v, k_pos = kv_cache["k"], kv_cache["v"], kv_cache["pos"]
            # a prefill chunk attends its OWN keys (the ring keeps only
            # the last W); single-chunk prefill from position 0 is the
            # engine's contract
        elif kv_cache is not None and "k_scale" in kv_cache:
            # int8 cache: write quantised, read dequantised
            qk, sk = _quantize_kv(k)
            qv, sv = _quantize_kv(v)
            for key, new in (("k", qk), ("v", qv), ("k_scale", sk),
                             ("v_scale", sv)):
                _scatter_cache(kv_cache[key], new, cache_pos)
            new_cache = kv_cache
            k = _dequantize_kv(kv_cache["k"], kv_cache["k_scale"], x.dtype)
            v = _dequantize_kv(kv_cache["v"], kv_cache["v_scale"], x.dtype)
            k_pos = torch.arange(k.shape[1], device=x.device)[None, :]
        elif kv_cache is not None:
            k = _scatter_cache(kv_cache["k"], k, cache_pos)
            v = _scatter_cache(kv_cache["v"], v, cache_pos)
            new_cache = kv_cache
            k_pos = torch.arange(k.shape[1], device=x.device)[None, :]

    if kv_cache is not None and S == 1:
        kernel = _decode_kernel_takes(q, k, kv_cache, is_cross=is_cross,
                                      causal=causal)
        decode_route_calls["kernel" if kernel else "einsum"] += 1
        if kernel:
            out = decode_kernel.decode_attention(
                q.contiguous(), k, v, positions, window=window,
                softcap=attn_softcap, scale=float(1.0 / math.sqrt(head_dim)))
            return _einsum("bqhk,hkd->bqd", out, params.wo), new_cache

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
                      window=0 if is_cross else window,
                      kv_len=None if is_cross else kv_len)
    scores = scores + bias[:, None, None]            # (B,1,1,Q,S)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    del scores
    out = _einsum("bhgqs,bshk->bqhgk", probs, v)
    out = out.reshape(B, S, num_heads, head_dim)
    return _einsum("bqhk,hkd->bqd", out, params.wo), new_cache


def _ring_write(cache, k, v, positions, ragged: bool = False, kv_len=None):
    """Write S_new keys into the W-slot ring at slots ``pos mod W``, in
    place.  Keys are stored post-RoPE, so the ring only remembers each
    slot's absolute position for masking (-1 = empty).  When S_new ≥ W
    only the last W entries survive.

    ``ragged`` (continuous batching, S_new == 1): each sequence writes its
    own slot.  ``kv_len`` (a ragged prefill, S_new > 1): each sequence
    keeps only its own real keys at positions in ``[len - W, len)``; the
    reference sends the other rows to slot W, out of bounds, where the
    write drops them.  Here each slot gathers the one row, if any, that
    lands on it, so nothing is written past the ring and no two rows race
    for a slot."""
    W = cache["k"].shape[1]
    B, S_new = k.shape[:2]
    if kv_len is not None and S_new > 1:
        pp = positions.expand(B, S_new).to(torch.int64)
        L = kv_len.reshape(-1, 1).to(torch.int64)
        valid = (pp < L) & (pp >= L - W)
        # the chunk row that lands on each slot, -1 where none does
        src = torch.full((B, W), -1, dtype=torch.int64, device=k.device)
        rows = torch.arange(S_new, device=k.device).expand(B, S_new)
        src.scatter_reduce_(1, pp % W, torch.where(valid, rows, -1),
                            reduce="amax")
        hit = src >= 0
        take = src.clamp(min=0)
        for key, new in (("k", k), ("v", v)):
            got = new.to(cache[key].dtype).gather(
                1, take[:, :, None, None].expand(-1, -1, *new.shape[2:]))
            cache[key].copy_(torch.where(hit[:, :, None, None], got,
                                         cache[key]))
        cache["pos"].copy_(torch.where(hit, pp.gather(1, take).to(
            torch.int32), cache["pos"]))
        return cache
    if ragged:
        if S_new != 1:
            raise ValueError(
                "per-sequence ring writes are decode-only (S_new == 1); "
                "continuous prefill stages one sequence at a time")
        pos = positions[:, 0]                             # (B,)
        rows = torch.arange(B, device=k.device)
        idx = pos % W
        cache["k"][rows, idx] = k[:, 0].to(cache["k"].dtype)
        cache["v"][rows, idx] = v[:, 0].to(cache["v"].dtype)
        cache["pos"][rows, idx] = pos.to(torch.int32)
        return cache
    pos_row = positions[0]                        # uniform across batch
    if S_new >= W:
        keep = slice(S_new - W, S_new)
        k, v, pos_row = k[:, keep], v[:, keep], pos_row[keep]
    idx = pos_row % W
    cache["k"][:, idx] = k.to(cache["k"].dtype)
    cache["v"][:, idx] = v.to(cache["v"].dtype)
    cache["pos"][:, idx] = pos_row.to(torch.int32)[None]
    return cache


def _scatter_cache(cache, new, cache_pos):
    """Write (B, S_new, ...) at row ``cache_pos`` of the cache, in place.
    ``cache_pos`` is an int, a (1, 1) tensor (one row for the whole batch)
    or a (B, 1) tensor (each sequence its own row).  Each start is placed
    as ``dynamic_update_slice`` places it: a negative start counts from the
    end, then the start is clamped so the rows fit.  A tensor start stays
    on the device."""
    S_new, S = new.shape[1], cache.shape[1]
    hi = S - S_new
    if not isinstance(cache_pos, torch.Tensor):
        start = int(cache_pos)
        start = min(max(start + S if start < 0 else start, 0), hi)
        cache[:, start:start + S_new] = new.to(cache.dtype)
        return cache
    B = cache.shape[0]
    start = cache_pos.reshape(-1, 1).to(torch.int64)
    start = torch.where(start < 0, start + S, start).clamp(0, hi)
    idx = (start + torch.arange(S_new, device=cache.device)).expand(B, S_new)
    rows = torch.arange(B, device=cache.device)[:, None]
    cache[rows, idx] = new.to(cache.dtype).expand(B, *new.shape[1:])
    return cache


def init_kv_cache(batch, max_seq, num_kv_heads, head_dim,
                  dtype=torch.bfloat16, window: int = 0, quant: bool = False,
                  *, device):
    """Decode cache.  Sliding-window layers with ``window < max_seq`` get a
    ring buffer of W slots plus a per-slot absolute-position array
    (-1 = empty).  ``quant=True``: int8 ``k``/``v`` with float32
    per-(token, kv-head) scales ``k_scale``/``v_scale`` (B, S, KH); ring
    layers keep the model dtype."""
    if window and window < max_seq:
        z = torch.zeros((batch, window, num_kv_heads, head_dim), dtype=dtype,
                        device=device)
        return {"k": z, "v": torch.zeros_like(z),
                "pos": torch.full((batch, window), -1, dtype=torch.int32,
                                  device=device)}
    if quant:
        z = torch.zeros((batch, max_seq, num_kv_heads, head_dim),
                        dtype=torch.int8, device=device)
        s = torch.zeros((batch, max_seq, num_kv_heads), dtype=torch.float32,
                        device=device)
        return {"k": z, "v": torch.zeros_like(z), "k_scale": s,
                "v_scale": torch.zeros_like(s)}
    z = torch.zeros((batch, max_seq, num_kv_heads, head_dim), dtype=dtype,
                    device=device)
    return {"k": z, "v": torch.zeros_like(z)}


def _quantize_kv(x):
    """Symmetric int8 per (token, head): returns (q, scale).  The scale
    floor is 1e-10; ``torch.round`` rounds half to even, as ``jnp.round``
    does."""
    xf = x.float()
    scale = (xf.abs().amax(dim=-1) / 127.0).clamp_min(1e-10)
    q = torch.round(xf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def _dequantize_kv(q, scale, dtype):
    return (q.float() * scale[..., None]).to(dtype)
