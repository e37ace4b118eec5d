"""The device mesh and the grid partition of the 1:n deployment.

PyTorch twin of the grid half of :mod:`repro.sharding.specs`.  The port is
single-controller, as the reference is: one process drives every shard.
A :class:`Mesh` is a grid of ``torch.device``\\ s with axis names (the
counterpart of ``jax.sharding.Mesh``), a :class:`GridPartition` says which
mesh axes split which array axes, and :func:`scatter_grid` /
:func:`gather_grid` are ``shard_map``'s ``in_specs`` / ``out_specs`` for a
grid: each shard's block is a tensor on its own device.  A mesh may repeat
a device (``["cuda:0"] * 4`` runs four shards on one card, ``["cpu"] * 8``
eight in a test process).

Shards are numbered in **mesh order**: row-major over the partition's mesh
axes, in the order ``axis_names`` lists them.  A mesh axis the partition
does not name would hold replicas under ``shard_map``; the port computes
one copy, on that axis's first device.

A lane farm over a mesh (:class:`repro_torch.core.streaming.FarmEngine`
with ``mesh=``) spreads its slots over one mesh axis: :func:`axis_devices`
lists that axis's devices, :func:`local_slot` maps a slot to its lane shard
and :func:`slice_partition` gives one lane shard's spatial partition.  The
LM parts of the reference module (``param_spec``, ``zero1_spec`` and the
rest: annotations for a model sharded over a mesh) have no counterpart:
the port trains and serves a model on one card, and a host batch splits
over a mesh's ``"data"`` axis by :func:`repro_torch.data.shard_batch`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch


def normalise_device(device) -> torch.device:
    """``device`` as a ``torch.device`` with its card index filled in."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """A grid of devices with named axes: ``devices`` is a numpy object
    array of ``torch.device`` shaped like the axes.  ``shape[name]`` is an
    axis's size, as on a JAX mesh.  Hashable, so a partition can key a
    cache."""

    def __init__(self, devices, axis_names: Sequence[str]):
        devices = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if devices.ndim != len(axis_names):
            raise ValueError(
                f"a mesh of {devices.ndim} axes needs {devices.ndim} axis "
                f"names; got {axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"mesh axis names repeat: {axis_names}")
        self.devices = devices
        self.axis_names = axis_names

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def _key(self):
        return (self.axis_names, self.devices.shape,
                tuple(str(d) for d in self.devices.flat))

    def __eq__(self, other):
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        return (f"Mesh({self.shape}, devices="
                f"{[str(d) for d in self.devices.flat]})")


def axis_devices(mesh: Mesh, axis: str) -> list:
    """The devices along mesh axis ``axis``, in order, the other axes at
    their first index (the devices of the lane shards of a farm)."""
    if axis not in mesh.shape:
        raise ValueError(f"mesh has no axis {axis!r}")
    at = [0] * mesh.devices.ndim
    pos = mesh.axis_names.index(axis)
    out = []
    for c in range(mesh.shape[axis]):
        at[pos] = c
        out.append(mesh.devices[tuple(at)])
    return out


def local_slot(idx: int, lanes_local: int, shard: int) -> tuple:
    """Map a GLOBAL lane-slot index onto lane shard ``shard`` (twin of the
    reference's ``local_slot``, which reads the shard from ``axis_index``
    inside ``shard_map``; here it is a host int).  Each lane shard owns
    ``lanes_local`` consecutive slots, so slot ``idx`` lives at local index
    ``idx - shard * lanes_local`` on exactly one shard.  Returns ``(owns,
    local_idx)`` with ``local_idx`` clipped into range."""
    li = int(idx) - shard * lanes_local
    return 0 <= li < lanes_local, min(max(li, 0), lanes_local - 1)


def make_mesh(axis_shapes: Sequence[int], axis_names: Sequence[str],
              devices=None) -> Mesh:
    """A mesh of ``axis_shapes`` named ``axis_names`` (counterpart of
    ``repro.sharding.specs.make_mesh``).

    ``devices=None`` takes the visible CUDA cards in order and raises when
    there are fewer than the mesh holds.  An explicit list (filled
    row-major into the axes) may repeat a device.
    """
    shape = tuple(int(s) for s in axis_shapes)
    n = math.prod(shape)
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n:
            raise RuntimeError(
                f"a {shape} mesh needs {n} devices and {have} CUDA cards "
                f"are visible; pass devices= (a list may repeat a device, "
                f"e.g. ['cuda:0'] * {n} or ['cpu'] * {n})")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = [normalise_device(d) for d in devices]
    if len(devices) != n:
        raise ValueError(
            f"a {shape} mesh holds {n} devices; got {len(devices)}")
    grid = np.empty(n, dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(shape), axis_names)


@dataclasses.dataclass(frozen=True)
class GridPartition:
    """How a global stencil grid maps onto the device mesh (1:n mode).

    ``axis_names`` are mesh axes; ``array_axes`` the array axes they split
    ("evenly for 1D array and by rows for 2D matrix", paper §3.4).  Frozen
    and hashable, as in the reference.
    """
    mesh: Mesh
    axis_names: tuple
    array_axes: tuple

    def __post_init__(self):
        object.__setattr__(self, "axis_names", tuple(self.axis_names))
        object.__setattr__(self, "array_axes", tuple(self.array_axes))
        if len(self.axis_names) != len(self.array_axes):
            raise ValueError("one array axis per mesh axis name")
        for name in self.axis_names:
            if name not in self.mesh.shape:
                raise ValueError(f"mesh has no axis {name!r}")
        if len(set(self.array_axes)) != len(self.array_axes):
            raise ValueError(f"array axes repeat: {self.array_axes}")

    def axis_size(self, name: str) -> int:
        return self.mesh.shape[name]

    @property
    def shards(self) -> tuple:
        """Decomposition arity per decomposed array axis."""
        return tuple(self.axis_size(n) for n in self.axis_names)

    @property
    def n_shards(self) -> int:
        return math.prod(self.shards)

    def stride(self, name: str) -> int:
        """Step in the shard index between neighbours along mesh axis
        ``name`` (shards are numbered row-major over ``axis_names``)."""
        i = self.axis_names.index(name)
        return math.prod(self.shards[i + 1:])

    def coords(self, index: int) -> tuple:
        """Shard ``index``'s coordinate along each of ``axis_names``."""
        return tuple(int(c) for c in np.unravel_index(index, self.shards))

    @property
    def devices(self) -> list:
        """Each shard's device, in mesh order."""
        pos = [self.mesh.axis_names.index(n) for n in self.axis_names]
        out = []
        for i in range(self.n_shards):
            at = [0] * self.mesh.devices.ndim
            for p, c in zip(pos, self.coords(i)):
                at[p] = c
            out.append(self.mesh.devices[tuple(at)])
        return out

    @property
    def lead(self) -> torch.device:
        """The first shard's device: the combined reduce and the gathered
        grid live there."""
        return self.devices[0]


def slice_partition(part: GridPartition, axis: str,
                    index: int) -> GridPartition:
    """``part`` on the sub-mesh at coordinate ``index`` of mesh axis
    ``axis`` (an axis the partition does not split): the spatial partition
    of one lane shard of a composed lanes x spatial farm."""
    if axis in part.axis_names:
        raise ValueError(f"mesh axis {axis!r} splits the grid; slice the "
                         "partition along another axis")
    mesh = part.mesh
    pos = mesh.axis_names.index(axis)
    sub = Mesh(np.take(mesh.devices, index, axis=pos),
               mesh.axis_names[:pos] + mesh.axis_names[pos + 1:])
    return GridPartition(sub, part.axis_names, part.array_axes)


def _block_index(part: GridPartition, index: int, shape,
                 batch: int = 0) -> tuple:
    """Shard ``index``'s block of a grid of ``shape``; ``batch`` leading
    axes (lanes) are not split and the array axes count after them."""
    idx = [slice(None)] * len(shape)
    for c, name, ax in zip(part.coords(index), part.axis_names,
                           part.array_axes):
        size = shape[batch + ax] // part.axis_size(name)
        idx[batch + ax] = slice(c * size, (c + 1) * size)
    return tuple(idx)


def check_even(shape, part: GridPartition) -> None:
    """Raise (the reference's message) unless every decomposed array axis
    divides evenly over its mesh axis."""
    for name, ax in zip(part.axis_names, part.array_axes):
        nsh = part.axis_size(name)
        if ax >= len(shape):
            raise ValueError(f"array axis {ax} does not exist in a "
                             f"{len(shape)}-d array")
        if shape[ax] % nsh:
            raise ValueError(
                f"array axis {ax} (size {shape[ax]}) must divide evenly "
                f"over mesh axis {name!r} (size {nsh})")


def scatter_grid(a: torch.Tensor, part: GridPartition,
                 batch: int = 0) -> list:
    """Split ``a`` into one block per shard (mesh order), each placed on
    its shard's device — ``shard_map``'s ``in_specs`` for a grid.
    ``batch`` leading axes (a lane stack's) go whole to every shard."""
    a = torch.as_tensor(a)
    check_even(a.shape[batch:], part)
    return [a[_block_index(part, i, a.shape, batch)].to(dev)
            for i, dev in enumerate(part.devices)]


def gather_grid(blocks: Sequence[torch.Tensor], part: GridPartition,
                device=None, batch: int = 0) -> torch.Tensor:
    """The global grid from its per-shard blocks (mesh order), on
    ``device`` (default: the partition's lead device) — ``shard_map``'s
    ``out_specs`` for a grid.  ``batch`` as for :func:`scatter_grid`."""
    device = part.lead if device is None else torch.device(device)
    shape = list(blocks[0].shape)
    for name, ax in zip(part.axis_names, part.array_axes):
        shape[batch + ax] *= part.axis_size(name)
    out = torch.empty(shape, dtype=blocks[0].dtype, device=device)
    for i, blk in enumerate(blocks):
        out[_block_index(part, i, shape, batch)].copy_(blk)
    return out
