"""Sliding-window flash attention (sequence stencil) with native GQA.

PyTorch/CUDA twin of :mod:`repro.kernels.swa_attention`.  The TPU kernel
``_swa_kernel`` becomes two hand-written CUDA kernels (built at first use
by :mod:`._build`), both an online softmax over the kv tiles inside the
band only, m/l/acc in float32, kv head = query head // G; the route is
chosen by dtype and head_dim alone (:func:`_route`):

* ``"wgmma"`` — ``csrc/swa_wgmma.cu``, bfloat16 at head_dim 64, 96, 128
  and 256 (every ported config's): Hopper tensor cores (wgmma) fed by TMA,
  one CTA per (128-row q block, query head), P·V with P split into two
  bf16 parts so the output stays within one bf16 ulp of the float32
  version; hd 96 runs in the hd-128 layout, its 32 extra columns
  zero-filled in shared memory by TMA (q, k and v are read as they are);
* ``"cuda_core"`` — ``csrc/swa_attention.cu``, float32 at every head_dim
  and bfloat16 at 16 and 32: float FMAs on the CUDA cores, one CTA of
  512 threads per (q block, kv head) serving up to 8 query heads of the
  kv group (64 rows), 256-key tiles staged by ``cp.async`` into a ring;
  :func:`last_launch` reports what its last launch chose.

* :func:`swa_attention` — the wrapper: on CUDA tensors it launches the
  route's kernel or raises; on CPU tensors it runs the plain version.  It
  has no backward (neither has the reference's kernel), so it refuses
  inputs that require grad while grad is enabled, on every device.
* :func:`swa_attention_plain` — the same function in torch ops: dense
  masked softmax in float32 with the kernel's scaling order (q scaled
  before the dot), softcap, ``NEG_INF`` and GQA by index.  For the tests
  and the CPU; its (B·H, S, S) scores make it no path for long sequences.

Layouts are the reference's: q (B·H, S, hd), k and v (B·KH, S, hd), the
output in q's shape and dtype.
"""
from __future__ import annotations

import ctypes
import math

import torch

NEG_INF = -2.0 ** 30
HEAD_DIMS = (16, 32, 64, 96, 128, 256)
TENSOR_CORE_HEAD_DIMS = (64, 96, 128, 256)
DTYPE_IDS = {torch.float32: 0, torch.bfloat16: 1}
TILE = 128            # the reference's bq = bk: S must tile by min(128, S)

# launches by route (the wrapper adds one per launch, nowhere else)
launch_counts = {"wgmma": 0, "cuda_core": 0}


def _route(dtype, hd: int) -> str:
    """The kernel a CUDA call launches: ``"wgmma"`` for bfloat16 at a head
    dim in :data:`TENSOR_CORE_HEAD_DIMS`, else ``"cuda_core"`` (a TF32
    product would miss the float32 gate)."""
    if dtype == torch.bfloat16 and hd in TENSOR_CORE_HEAD_DIMS:
        return "wgmma"
    return "cuda_core"


def last_launch() -> dict:
    """What the last launch of the CUDA-core kernel chose
    (``csrc/swa_attention.cu`` ``swa_launch_info``): grid (q blocks × CTAs
    per batch-and-kv-head row), threads, shared memory a CTA, registers a
    thread, CTAs and warps resident an SM, q positions a CTA (``bq``), query
    heads a CTA, kv keys a tile (``bk``), ring stages, head_dim."""
    from . import _build
    out = (ctypes.c_int * 11)()
    _build.library().swa_launch_info(out)
    keys = ("grid_x", "grid_y", "threads", "smem_bytes", "registers",
            "ctas_per_sm", "bq", "heads_per_cta", "bk", "stages",
            "head_dim")
    info = dict(zip(keys, out))
    info["warps_per_sm"] = info["ctas_per_sm"] * info["threads"] // 32
    return info


def _check(q, k, v, window: int):
    if q.ndim != 3 or k.ndim != 3 or v.ndim != 3:
        raise ValueError(
            f"q, k, v must be (rows, S, hd); got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}")
    BH, S, hd = q.shape
    if k.shape != v.shape or k.shape[1:] != (S, hd):
        raise ValueError(
            f"k and v must be (B·KH, {S}, {hd}); got {tuple(k.shape)} and "
            f"{tuple(v.shape)}")
    if k.shape[0] == 0 or BH % k.shape[0]:
        raise ValueError(
            f"q heads must be a multiple of kv heads; got {BH} q rows and "
            f"{k.shape[0]} kv rows")
    if q.dtype not in DTYPE_IDS or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"q, k, v must share one dtype of float32 or bfloat16; got "
            f"{q.dtype}, {k.dtype}, {v.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} has no kernel; choose from "
                         f"{HEAD_DIMS}")
    if S % min(TILE, S):
        raise ValueError(f"S must tile: S={S} is no multiple of {TILE}")
    if window < 0:
        raise ValueError(f"window must be >= 0; got {window}")


def swa_attention_plain(q, k, v, *, window: int = 0, causal: bool = True,
                        softcap: float = 0.0):
    """Masked softmax attention in float32, as the kernel computes it:
    ``q · (1/√hd)`` before the dot, then ``softcap·tanh(s/softcap)``, then
    the causal/window mask at ``NEG_INF``; kv row ``b // G`` for q row
    ``b``.  Returns q's shape and dtype."""
    BH, S, hd = q.shape
    G = BH // k.shape[0]
    scale = float(1.0 / math.sqrt(hd))
    rows = torch.arange(BH, device=q.device) // G
    qf = q.float() * scale
    s = qf @ k.float()[rows].transpose(-1, -2)              # (BH, S, S)
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    qp = torch.arange(S, device=q.device)[:, None]
    kp = torch.arange(S, device=q.device)[None, :]
    ok = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kp <= qp
    if window:
        ok &= kp > qp - window
    s = torch.where(ok[None], s, torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    return (p @ v.float()[rows]).to(q.dtype)


def swa_attention(q, k, v, *, window: int = 0, causal: bool = True,
                  softcap: float = 0.0):
    """Flash sliding-window attention with native GQA.

    q: (B·H, S, hd); k, v: (B·KH, S, hd), float32 or bfloat16, with hd in
    :data:`HEAD_DIMS` and S a multiple of min(128, S).  On a CUDA tensor
    this launches the kernel of :func:`_route` (contiguous, 16-byte aligned
    inputs: both kernels copy rows by 16-byte pieces, TMA or ``cp.async``)
    or raises; on a CPU tensor it runs :func:`swa_attention_plain`.

    Raises :class:`RuntimeError` when grad is enabled and q, k or v
    requires grad: the kernel has no backward, and its output would carry
    no gradient to them."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "swa_attention has no backward: its output would carry no "
            "gradient to q, k or v.  Differentiate through the einsum route"
            " (repro_torch.models.attention.set_flash_swa(False)), or call "
            "it under torch.no_grad()")
    _check(q, k, v, window)
    if q.device.type == "cpu":
        return swa_attention_plain(q, k, v, window=window, causal=causal,
                                   softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    if not (k.device == q.device and v.device == q.device):
        raise ValueError("q, k and v must lie on one device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("the kernel takes contiguous q, k and v")
    BH, S, hd = q.shape
    route = _route(q.dtype, hd)
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("the kernels take 16-byte aligned q, k and v")
    out = torch.empty_like(q)

    from . import _build
    lib = _build.library()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), BH,
            k.shape[0], S, int(window), int(bool(causal)),
            ctypes.c_float(1.0 / math.sqrt(hd)), ctypes.c_float(softcap),
            torch.cuda.current_stream(q.device).cuda_stream)
    if route == "wgmma":
        rc = lib.swa_attention_wgmma(hd, *args)
    else:
        rc = lib.swa_attention_fwd(DTYPE_IDS[q.dtype], hd, *args)
    if rc != 0:
        raise RuntimeError(
            f"swa_attention launch failed ({route}, {rc}): "
            f"{lib.stencil_error_string(rc).decode()}")
    launch_counts[route] += 1
    return out
