"""Cached single-token decode attention over a bf16 KV pool, read in place.

Replaces no Pallas TPU kernel.  The reference decodes with a grouped-query
einsum (``repro.models.attention``) that XLA lowers to a ``dot_general``
reading the (B, T, KH, hd) cache where it lies; ``torch.einsum`` instead
copies the whole K and V pool into its bmm's layout in every layer at every
step, then multiplies over the pool's full width.  This kernel
(``csrc/decode_attention.cu``, built at first use by :mod:`._build`) computes
the einsum route's function without the copy: each sequence ``b`` attends
its keys ``max(0, pos_b - window + 1) .. pos_b`` (the keys the route's mask
leaves visible in a full cache), and only those are read.

It is bound by bytes: each visible key and value row is read once for the G
query heads of its kv head.  The design (flash-decoding splits of 64-256
keys along T, fixed by the static shapes so that a CUDA graph replays one
grid; one block a (sequence, kv head, split); 16-byte loads, many in flight;
float32 scores, online softmax and sums; a second pass merging the splits)
is set out in the source.

* :func:`decode_attention` — the wrapper: on CUDA tensors it launches the
  kernel or raises; on CPU tensors it runs the plain version.  It has no
  backward (decode runs under ``torch.no_grad``), so it refuses inputs that
  require grad while grad is enabled.
* :func:`decode_attention_plain` — the same function in torch ops: a dense
  float32 softmax over the visible keys.  For the tests and the CPU.
* :func:`takes` — whether the kernel takes a head layout (G and hd).
"""
from __future__ import annotations

import ctypes
import math

import torch

HEAD_DIMS = (64, 96, 128, 256)
GROUPS = (1, 2, 4, 8)          # query heads a kv head

# launches of the kernel (the wrapper adds one per launch, nowhere else)
launch_counts = {"decode_attention": 0}


def takes(num_heads: int, num_kv_heads: int, head_dim: int) -> bool:
    """Whether the kernel has an instantiation for this head layout."""
    return (num_kv_heads > 0 and num_heads % num_kv_heads == 0
            and num_heads // num_kv_heads in GROUPS
            and head_dim in HEAD_DIMS)


MAX_SPLIT_KEYS, MIN_SPLIT_KEYS = 256, 64
GRID_BLOCKS = 3072     # split blocks a launch should offer the card


def split_keys(B: int, KH: int, T: int) -> int:
    """Keys a split: 256, halved (down to 64) while the grid of B × KH ×
    splits blocks is smaller than :data:`GRID_BLOCKS`, so that a pool of
    few sequences still spreads over every SM.  Fixed by the static shapes
    alone, never by the positions, so the grid is the same at every decode
    step."""
    keys = MAX_SPLIT_KEYS
    while keys > MIN_SPLIT_KEYS and B * KH * splits(T, keys) < GRID_BLOCKS:
        keys //= 2
    return keys


def splits(T: int, keys: int) -> int:
    """Splits along the pool's width."""
    return -(-T // keys)


def _positions(pos, B: int, device) -> torch.Tensor:
    """Each sequence's query position as a (B,) int32 device tensor: an int
    or a one-element tensor is broadcast on the device (no host read)."""
    if not isinstance(pos, torch.Tensor):
        return torch.full((B,), int(pos), dtype=torch.int32, device=device)
    p = pos.reshape(-1)
    if p.numel() not in (1, B):
        raise ValueError(f"pos must hold 1 or {B} positions; got "
                         f"{tuple(pos.shape)}")
    return p.to(device=device, dtype=torch.int32).expand(B).contiguous()


def _check(q, k, v):
    if q.ndim != 4 or q.shape[1] != 1:
        raise ValueError(f"q must be (B, 1, H, hd); got {tuple(q.shape)}")
    B, _, H, hd = q.shape
    if k.ndim != 4 or k.shape != v.shape or k.shape[0] != B \
            or k.shape[3] != hd:
        raise ValueError(
            f"k and v must be (B={B}, T, KH, hd={hd}); got "
            f"{tuple(k.shape)} and {tuple(v.shape)}")
    if not takes(H, k.shape[2], hd):
        raise ValueError(
            f"no kernel for {H} query heads over {k.shape[2]} kv heads at "
            f"head_dim {hd}; G must be one of {GROUPS} and hd one of "
            f"{HEAD_DIMS}")


def decode_attention_plain(q, k, v, pos, *, window: int = 0,
                           softcap: float = 0.0, scale: float = None):
    """softmax(softcap(q·k · scale)) · v in float32 over each sequence's
    keys ``max(0, pos - window + 1) .. min(pos, T - 1)`` (a sequence with
    none gets zeros, as the kernel gives); kv head ``h // G`` for query head
    ``h``.  Returns q's shape and dtype."""
    _check(q, k, v)
    B, _, H, hd = q.shape
    T, KH = k.shape[1], k.shape[2]
    G = H // KH
    scale = 1.0 / math.sqrt(hd) if scale is None else scale
    p = _positions(pos, B, q.device).to(torch.int64)[:, None]     # (B, 1)
    t = torch.arange(T, device=q.device)[None]                    # (1, T)
    ok = t <= p
    if window:
        ok = ok & (t > p - window)
    qf = q.float().reshape(B, KH, G, hd) * scale
    s = torch.einsum("bhgd,bthd->bhgt", qf, k.float())
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    s = s.masked_fill(~ok[:, None, None], -math.inf)
    w = torch.softmax(s, dim=-1).nan_to_num(0.0)      # no key: all-nan row
    out = torch.einsum("bhgt,bthd->bhgd", w, v.float())
    return out.reshape(B, 1, H, hd).to(q.dtype)


def decode_attention(q, k, v, pos, *, window: int = 0, softcap: float = 0.0,
                     scale: float = None):
    """Single-token attention of ``q`` (B, 1, H, hd), rotated, over a full
    KV cache ``k``, ``v`` (B, T, KH, hd) read in place, each sequence up to
    its own position ``pos`` ((B,) device tensor, or an int or one-element
    tensor for the whole batch) and back ``window`` keys (0: all).

    On CUDA: bfloat16 throughout, q contiguous, each cache row's (KH, hd)
    dense with batch and row strides that keep 16-byte alignment; the
    kernel launches on the current stream, with no host synchronisation, or
    this raises.  On the CPU: :func:`decode_attention_plain`."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "decode_attention has no backward: call it under "
            "torch.no_grad(), as decoding does")
    _check(q, k, v)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, pos, window=window,
                                      softcap=softcap, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    if not (k.device == q.device and v.device == q.device):
        raise ValueError("q, k and v must lie on one device")
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise ValueError(f"the kernel takes bfloat16 q, k and v; got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not q.is_contiguous():
        raise ValueError("the kernel takes a contiguous q")
    B, _, H, hd = q.shape
    T, KH = k.shape[1], k.shape[2]
    for name, t in (("k", k), ("v", v)):
        if t.stride(3) != 1 or t.stride(2) != hd or t.stride(0) % 8 \
                or t.stride(1) % 8 or t.data_ptr() % 16:
            raise ValueError(
                f"the kernel reads {name} by 16-byte pieces: each row's "
                f"(KH, hd) dense, 16-byte aligned, with strides of whole "
                f"8-element pieces; got strides {t.stride()}")
    if q.data_ptr() % 16:
        raise ValueError("the kernel takes a 16-byte aligned q")
    if window < 0 or softcap < 0:
        raise ValueError(f"window and softcap must be >= 0; got {window}, "
                         f"{softcap}")
    keys = split_keys(B, KH, T)
    n = splits(T, keys)
    p = _positions(pos, B, q.device)
    out = torch.empty_like(q)
    part_o = torch.empty((B, KH, n, H // KH, hd), dtype=torch.float32,
                         device=q.device)
    part_ml = torch.empty((B, KH, n, H // KH, 2), dtype=torch.float32,
                          device=q.device)
    scale = 1.0 / math.sqrt(hd) if scale is None else scale

    from . import _build
    lib = _build.library()
    rc = lib.decode_attention_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), p.data_ptr(),
        out.data_ptr(), part_o.data_ptr(), part_ml.data_ptr(), B, H, KH, hd,
        T, n, keys, k.stride(0), k.stride(1), v.stride(0), v.stride(1),
        int(window), ctypes.c_float(scale), ctypes.c_float(softcap),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention launch failed ({rc}): "
                           f"{lib.stencil_error_string(rc).decode()}")
    launch_counts["decode_attention"] += 1
    return out
