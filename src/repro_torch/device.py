"""Device and backend resolution shared by every entry point of the port.

Entry points take ``device=None``, which means the CUDA card.  The plain
PyTorch path runs on the CPU only when the caller asks for it
(``device="cpu"``); nothing moves to the CPU because no card was found.

The backend axis of the port:

``"torch"``
    The plain shift-algebra path (twin of the reference's ``"jnp"``).
``"cuda"``
    The hand-written stencil+reduce kernel iterated on a persistent halo
    frame (twin of ``"pallas"``).  Needs tensors on a CUDA device.
``"cuda-multistep"``
    Temporal blocking: ``unroll=T`` sweeps fused into one launch of the
    hand-written multistep kernel (twin of ``"pallas-multistep"``).  Needs
    tensors on a CUDA device.

``"cuda-sharded"``
    The 1:n deployment: one frame per shard of a device mesh
    (:mod:`repro_torch.sharding`), each swept by the kernels above, with an
    edge-strip exchange and a fold of the partial reduces between checks
    (twin of ``"pallas-sharded"``).  Needs a ``partition=``.  Inside
    ``FarmEngine(mesh=...)`` it is the composed lanes × spatial farm: lanes
    over another axis of the same mesh, each lane's frame split by the
    partition.

``FarmEngine(mesh=...)`` with ``"torch"``, ``"cuda"`` or
``"cuda-multistep"`` spreads the farm's lanes over a mesh axis, each lane
shard on its own device (:mod:`repro_torch.core.streaming`).

``backend=None`` resolves to ``"cuda"`` on a CUDA device and to
``"torch"`` on the CPU.
"""
from __future__ import annotations

import torch

BACKENDS = ("torch", "cuda", "cuda-multistep", "cuda-sharded")
# the backends that run a hand-written kernel (CUDA tensors only)
KERNEL_BACKENDS = ("cuda", "cuda-multistep", "cuda-sharded")


def resolve_device(device=None) -> torch.device:
    """``None`` → the CUDA card; raise when there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the card by "
            "default — pass device='cpu' to run the plain PyTorch path "
            "on the CPU")
    return dev


def resolve_backend(backend, device: torch.device) -> str:
    """Resolve ``backend`` against ``device`` (see module docstring)."""
    if backend is None:
        return "cuda" if device.type == "cuda" else "torch"
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown backend {backend!r}; choose from {BACKENDS}")
    if backend in KERNEL_BACKENDS and device.type != "cuda":
        raise ValueError(
            f"backend={backend!r} runs a hand-written kernel and needs a "
            f"CUDA device; got device={str(device)!r} (use backend='torch' "
            "for the plain path)")
    return backend


def to_device(x, device: torch.device):
    """Move a tensor, numpy array or (nested) tuple/list/dict of them to
    ``device``; other leaves pass through unchanged."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, (tuple, list)):
        return type(x)(to_device(v, device) for v in x)
    if isinstance(x, dict):
        return {k: to_device(v, device) for k, v in x.items()}
    if hasattr(x, "__array__"):
        return torch.as_tensor(x, device=device)
    return x
