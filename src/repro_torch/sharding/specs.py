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
and :func:`slice_partition` gives one lane shard's spatial partition.

The LM half is the reference's parallelism policy, rule for rule: which
mesh axes split each parameter, optimizer, batch and cache leaf of a model
(:func:`param_spec`, :func:`zero1_spec`, :func:`params_shardings`,
:func:`opt_shardings`, :func:`batch_spec`, :func:`cache_shardings`).  A
spec is a tuple with one entry a dimension: ``None``, an axis name, or a
tuple of names (the twin of ``PartitionSpec``).  The rules read only the
mesh's axis names and sizes, so they take an :class:`AbstractMesh`
(:func:`make_abstract_mesh`: sizes, no devices) as well as a
:class:`Mesh`.  The launch layer (:mod:`repro_torch.launch`) prices a
deployment from them; no code of the port places a model's shards.  The
reference stacks each unit layer's leaves on a leading rep axis; the
port's leaves are per layer, so a spec here is the reference's with that
axis dropped.
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


# ---------------------------------------------------------------------------
# LM parallelism policy (the reference's param/optimizer/batch/cache specs)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh of named axis sizes and no devices, for the spec rules and
    dry runs (twin of ``jax.sharding.AbstractMesh``)."""
    sizes: tuple
    axis_names: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))


def make_abstract_mesh(axis_shapes: Sequence[int],
                       axis_names: Sequence[str]) -> AbstractMesh:
    shape, names = tuple(int(s) for s in axis_shapes), tuple(axis_names)
    if len(shape) != len(names) or len(set(names)) != len(names):
        raise ValueError(f"axis sizes {shape} and names {names} do not "
                         "pair up")
    return AbstractMesh(shape, names)


def _div(n: int, k: int) -> bool:
    return k > 0 and n % k == 0


def _entry(axes):
    """A spec entry for mesh ``axes``: None, one name, or a tuple of
    names (``PartitionSpec`` normalises a 1-tuple to its name too)."""
    axes = tuple(axes)
    return None if not axes else axes[0] if len(axes) == 1 else axes


def dp_axes(mesh) -> tuple:
    """The data-parallel axes: ('pod','data') multi-pod, ('data',) single."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def mesh_size(mesh, axis: str) -> int:
    return mesh.shape[axis] if axis in mesh.axis_names else 1


def param_spec(cfg, path: str, shape, mesh) -> tuple:
    """The spec of one parameter leaf, identified by its name (the port's
    dotted name, or the reference's tree path).  A path holding ``unit``
    is a reference leaf stacked on a leading rep axis, which the rules
    skip; the port's leaves are never stacked.

    Vocab-sharded embeddings; Megatron GQA: the head dims shard on
    "model" when divisible, K/V replicate when KH < tp, and when even H <
    tp every projection shards head_dim; context-parallel configs
    replicate attention weights; experts on "model"; column-parallel up /
    gate, row-parallel down; SSM in/out projections; norms, biases, conv,
    ``A_log``, ``dt_bias`` and ``pos_embed`` replicated."""
    tp = mesh_size(mesh, "model")
    off = 1 if ("unit" in path and "cache" not in path) else 0
    dims = list(shape)
    spec = [None] * len(dims)

    def set_if(idx, cond=True):
        if cond and _div(dims[idx], tp):
            spec[idx] = "model"
            return True
        return False

    if "embed" in path and "pos" not in path and "patch" not in path:
        set_if(int(np.argmax(dims)))     # (V, D) / (D, V): the vocab dim
    elif any(k in path for k in ("wq", "wk", "wv", "wo")):
        h_dim = off + (0 if "wo" in path else 1)   # H / KH
        d_dim = off + (1 if "wo" in path else 2)   # head_dim
        is_kv = ("wk" in path) or ("wv" in path)
        if cfg.attn_sequence_parallel:
            pass              # the sequence shards on "model" instead
        elif _div(dims[h_dim], tp):
            spec[h_dim] = "model"
        elif not is_kv:
            set_if(d_dim)     # K/V heads replicate; the rest shard hd
    elif any(k in path for k in ("w_up", "w_gate", "w_down")):
        set_if(off + 0)                  # expert-parallel: experts axis
    elif "router" in path:
        pass
    elif "up" in path or "gate" in path:
        set_if(off + 1)                  # (D, F): column parallel
    elif "down" in path:
        set_if(off + 0)                  # (F, D): row parallel
    elif "in_proj" in path:
        set_if(off + 1) or set_if(off + 0)
    elif "out_proj" in path:
        set_if(off + 0) or set_if(off + 1)
    elif "vision_proj" in path:
        set_if(off + 1)
    return tuple(spec)


def zero1_spec(spec, shape, mesh) -> tuple:
    """ZeRO-1: ``spec`` with the largest still-unsharded dim that the
    "data" axis divides sharded on "data" (ties: the later dim)."""
    dz = mesh_size(mesh, "data")
    if dz == 1:
        return tuple(spec)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    cands = [(shape[i], i) for i, s in enumerate(entries)
             if s is None and _div(shape[i], dz) and shape[i] >= dz]
    if cands:
        entries[max(cands)[1]] = "data"
    return tuple(entries)


def _named_shapes(params) -> dict:
    """Shapes by name: a module's ``named_parameters()`` or a dict of
    tensors (or shapes)."""
    if isinstance(params, torch.nn.Module):
        params = dict(params.named_parameters())
    return {k: tuple(getattr(v, "shape", v)) for k, v in params.items()}


def params_shardings(cfg, params, mesh) -> dict:
    """Each parameter's spec, by name."""
    return {k: param_spec(cfg, k, s, mesh)
            for k, s in _named_shapes(params).items()}


def opt_shardings(cfg, opt_state, mesh) -> dict:
    """An :class:`~repro_torch.optim.AdamState`'s specs: ``step``
    replicated; ``master``, ``m`` and ``v`` the parameter's spec with
    ZeRO-1 over "data"."""
    out = {"step": ()}
    for field in ("master", "m", "v"):
        out[field] = {
            k: zero1_spec(param_spec(cfg, k, s, mesh), s, mesh)
            for k, s in _named_shapes(getattr(opt_state, field)).items()}
    return out


def batch_spec(mesh, batch_size: int, ndim: int = 2) -> tuple:
    """Shard the batch dim over every data-parallel axis that divides it."""
    use, rem = [], batch_size
    for a in dp_axes(mesh):
        n = mesh_size(mesh, a)
        if rem % n == 0 and rem >= n:
            use.append(a)
            rem //= n
    return (_entry(use),) + (None,) * (ndim - 1)


def cache_shardings(cfg, caches, mesh, batch_size: int,
                    seq_shard: bool = True, n_prefix: int = None) -> list:
    """Specs of decode caches (the per-layer list of :func:`~repro_torch.
    models.transformer.init_cache`, or of ``prefill_cross_caches`` with
    ``seq_shard=False``; a ``None`` layer stays ``None``).

    KV caches (B, S, KH, hd): batch over the dp axes that divide it, the
    sequence over "model" (flash-decode style); with B == 1 the dp axes
    join the sequence instead.  int8 scales (B, S, KH) shard the same
    way; ring ``pos`` arrays and SSM caches the batch only.

    The reference applies its rule to stacked (reps, B, S, ...) unit
    caches; on its unstacked prefix caches (deepseek-moe-16b's first
    layer) the same dim numbers land one dim early (the batch axes on the
    sequence).  The port keeps that leaf for leaf: the first ``n_prefix``
    layers (default: the stack's prefix) take the rule unstacked."""
    from ..models.transformer import stack_pattern
    if n_prefix is None:
        n_prefix = len(stack_pattern(cfg)[0])
    bs, rem = [], batch_size
    for a in dp_axes(mesh):
        if _div(batch_size, mesh_size(mesh, a)) \
                and rem % mesh_size(mesh, a) == 0:
            bs.append(a)
            rem //= mesh_size(mesh, a)
    seq_axes = ["model"] if seq_shard else []
    if batch_size == 1:
        seq_axes = list(dp_axes(mesh)) + seq_axes if seq_shard else []
        bs = []

    def rule(key, shape):                # the reference's, on stacked dims
        spec = [None] * len(shape)
        if len(shape) >= 2:
            spec[1] = _entry(bs)
        if key == "conv" or key.endswith("h"):
            return spec
        seq_ok = (seq_axes and len(shape) >= 3 and all(
            _div(shape[2], mesh_size(mesh, a)) for a in seq_axes))
        if seq_ok and (len(shape) == 5
                       or (len(shape) == 4 and "scale" in key)):
            spec[2] = _entry(seq_axes)
        return spec

    def layer(i, cache):
        if cache is None:
            return None
        if i < n_prefix:
            return {k: tuple(rule(k, tuple(v.shape)))
                    for k, v in cache.items()}
        return {k: tuple(rule(k, (1,) + tuple(v.shape))[1:])
                for k, v in cache.items()}
    return [layer(i, c) for i, c in enumerate(caches)]


def replicated(mesh) -> tuple:
    return ()


def spec_shards(spec, mesh) -> int:
    """How many pieces a leaf of ``spec`` is split into on ``mesh``."""
    n = 1
    for entry in spec:
        for ax in ((entry,) if isinstance(entry, str) else (entry or ())):
            n *= mesh.shape[ax]
    return n
