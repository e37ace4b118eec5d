"""Production meshes (twin of :mod:`repro.launch.mesh`).

Topology (H100 SXM5 clusters):
    single pod : (16, 16)     axes ("data", "model")   = 256 GPUs
    multi-pod  : (2, 16, 16)  axes ("pod", "data", "model") = 512 GPUs

A pod here is 256 H100s: 32 nodes of 8, the 8 GPUs of a node joined all to
all by NVLink, the nodes by InfiniBand.  The mesh is laid out row-major
over the GPUs with "model" innermost, so tensor-parallel collectives take
the fastest links: a "model" axis of 8 or fewer stays inside a node, one
of 16 spans two nodes; "data" and "pod" cross nodes and carry the
gradient reduction (:func:`repro_torch.launch.roofline.link_bw`).

The production meshes are abstract (:class:`~repro_torch.sharding.
AbstractMesh`: axis sizes, no devices): they price a deployment; no code
of the port places a model's shards on them.
"""
from __future__ import annotations

from ..sharding.specs import (AbstractMesh, Mesh, make_abstract_mesh,
                              make_mesh, mesh_size)


def make_production_mesh(*, multi_pod: bool = False,
                         pod_shape: tuple = None) -> AbstractMesh:
    """``pod_shape`` overrides the (data, model) factorisation of the 256
    GPUs in a pod — the TP:DP trade is a first-class tuning knob."""
    dm = tuple(pod_shape or (16, 16))
    if dm[0] * dm[1] != 256:
        raise ValueError(f"a pod is 256 GPUs; {dm} holds {dm[0] * dm[1]}")
    shape = (2, *dm) if multi_pod else dm
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_abstract_mesh(shape, axes)


def make_host_mesh(data: int = 1, model: int = 1, *, device=None) -> Mesh:
    """A (data, model) mesh over ``device`` (None: the CUDA card), which
    it repeats, as :func:`~repro_torch.sharding.make_mesh` may."""
    from ..device import resolve_device
    dev = resolve_device(device)
    return make_mesh((data, model), ("data", "model"),
                     devices=[dev] * (data * model))


def make_replica_mesh(mesh):
    """The mesh of one data-parallel replica: the "model" axis alone (of
    a device mesh, the devices at the first index of every other axis)."""
    tp = mesh_size(mesh, "model")
    if isinstance(mesh, AbstractMesh):
        return make_abstract_mesh((tp,), ("model",))
    pos = mesh.axis_names.index("model")
    at = tuple(slice(None) if i == pos else 0
               for i in range(mesh.devices.ndim))
    return Mesh(mesh.devices[at], ("model",))
