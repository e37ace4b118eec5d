"""Cost analysis of a step traced op by op (twin of
:mod:`repro.launch.hlo_analysis`).

The reference parses the compiled HLO.  The port has none: it runs its own
step, usually on ``torch.device("meta")`` tensors (shapes and dtypes, no
storage, no arithmetic), under :class:`CostCounter`, a
``TorchDispatchMode`` that sees every aten op the eager step dispatches —
the forward, autograd's backward and remat's recompute alike.  It counts

* FLOPs, by ``torch.utils.flop_counter``'s formula registry (products,
  convolutions, attention; other ops count none, as the reference counts
  dots and convolutions only);
* bytes: each op's tensor operands plus its outputs, every op on its own
  — the **unfused upper bound** of the traffic (views and other aliasing
  ops that write nothing move no bytes; an operand counts at most its
  storage's size, so a broadcast view counts the storage it reads);
* the peak of live bytes: each new output storage's size from its
  creation to its free (a ``weakref.finalize`` on the storage), beyond
  what was live when the trace began;
* the ops.

A host loop (the microbatches, the layer stack) runs every iteration for
real, so no trip-count correction is needed: ``trip_counts`` stays empty.
An op with no kernel for the traced tensors' device raises with the op's
name; nothing is counted as zero.

The reference reads its collectives from GSPMD's partitioned HLO; the port
runs no GSPMD, so :func:`analytic_collectives` prices them from the
sharding specs (``collective_model: "analytic"``).
"""
from __future__ import annotations

import dataclasses
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..sharding import specs as SH
from . import roofline as RF


@dataclasses.dataclass
class HloCosts:
    """The reference's record, with the port's counters beside it."""
    flops: float = 0.0
    bytes_accessed: float = 0.0
    collective_bytes: float = 0.0
    per_collective: dict = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    collective_count: dict = dataclasses.field(
        default_factory=lambda: defaultdict(int))
    trip_counts: dict = dataclasses.field(default_factory=dict)
    op_count: int = 0
    peak_live_bytes: int = 0
    collective_s: float = 0.0
    collective_model: str = "analytic"


def _tensors(args) -> list:
    """The tensors among an op's arguments (or outputs): top-level, or in
    a list or tuple (aten signatures nest no deeper)."""
    out = []
    for a in args:
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(t for t in a if isinstance(t, torch.Tensor))
    return out


_MUTATES = {}


def _mutates(func) -> bool:
    """Whether ``func`` writes one of its arguments (in place, ``out=``)."""
    if func not in _MUTATES:
        _MUTATES[func] = any(
            a.alias_info is not None and a.alias_info.is_write
            for a in func._schema.arguments)
    return _MUTATES[func]


class CostCounter(TorchDispatchMode):
    """Counts FLOPs, unfused bytes, ops and the peak of live bytes of
    everything dispatched inside the ``with`` block (see module doc)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes_accessed = 0
        self.op_count = 0
        self.live_bytes = 0
        self.peak_live_bytes = 0
        self._live = {}

    def _free(self, key):
        self.live_bytes -= self._live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        try:
            out = func(*args, **kwargs)
        except NotImplementedError as e:
            raise NotImplementedError(
                f"{func} has no kernel for the traced tensors: {e}") from e
        self.op_count += 1
        packet = func.overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs,
                                                out_val=out)
        ins = _tensors(args) + _tensors(kwargs.values())
        outs = _tensors(out if isinstance(out, (list, tuple)) else (out,))
        in_storages = [t.untyped_storage() for t in ins]
        known = {st._cdata for st in in_storages}
        new = []
        for t in outs:
            st = t.untyped_storage()
            if st._cdata not in known:
                new.append(st)
        if new or _mutates(func):
            self.bytes_accessed += sum(
                min(t.numel() * t.element_size(), st.nbytes())
                for t, st in zip(ins, in_storages))
            self.bytes_accessed += sum(t.numel() * t.element_size()
                                       for t in outs)
        for st in new:
            key, nbytes = st._cdata, st.nbytes()
            if key in self._live or not nbytes:
                continue
            self._live[key] = nbytes
            self.live_bytes += nbytes
            self.peak_live_bytes = max(self.peak_live_bytes,
                                       self.live_bytes)
            weakref.finalize(st, self._free, key)
        return out


def analyze(fn, *args, **kwargs) -> HloCosts:
    """Run ``fn(*args, **kwargs)`` under a :class:`CostCounter`; the
    :class:`HloCosts` of the run (collectives not included)."""
    counter = CostCounter()
    with counter:
        fn(*args, **kwargs)
    return HloCosts(flops=float(counter.flops),
                            bytes_accessed=float(counter.bytes_accessed),
                            op_count=counter.op_count,
                            peak_live_bytes=int(counter.peak_live_bytes))


# ---------------------------------------------------------------------------
# analytic collectives
# ---------------------------------------------------------------------------

def _ring(n: int) -> float:
    return 2.0 * (n - 1) / n


def _block_outputs(cfg, model) -> list:
    """(stack, leaves) of every block whose output a row-parallel product
    makes — each layer's attention, SSM, cross-attention, MLP and MoE
    block — with the names of the leaves that product reads: the MoE
    block's experts' ``w_down`` (the combine sums the expert shards) and
    its shared expert's ``down``."""
    out = []
    stacks = [("decoder", "layers", model.layers)]
    if hasattr(model, "encoder"):
        stacks.append(("encoder", "encoder.layers", model.encoder.layers))
    for stack, prefix, layers in stacks:
        for i, layer in enumerate(layers):
            name = f"{prefix}.{i}"
            if hasattr(layer, "attn"):
                out.append((stack, [f"{name}.attn.wo"]))
            if hasattr(layer, "ssm"):
                out.append((stack, [f"{name}.ssm.out_proj"]))
            if hasattr(layer, "cross"):
                out.append((stack, [f"{name}.cross.wo"]))
            if hasattr(layer, "mlp"):
                out.append((stack, [f"{name}.mlp.down"]))
            if hasattr(layer, "moe"):
                leaves = [f"{name}.moe.w_down"]
                if hasattr(layer.moe, "shared"):
                    leaves.append(f"{name}.moe.shared.down")
                out.append((stack, leaves))
    return out


def analytic_collectives(cfg, model, mesh, *, kind: str, tokens: int,
                         enc_tokens: int = 0, grad_itemsize: int = 2,
                         costs: HloCosts = None) -> HloCosts:
    """The collectives of one step of a replica on ``mesh``, priced from
    the specs at the ring factors (per device, wire bytes):

    * train cells: each parameter's gradient reduced over the data-parallel
      axes, ``2(n-1)/n`` of its per-device bytes (in ``grad_itemsize``);
      where ZeRO-1 shards its optimizer state the reduction is a
      reduce-scatter plus an all-gather of the same total;
    * every cell: the tensor-parallel all-reduce of the (``tokens`` ×
      d_model) activation, in the model dtype, after each block whose
      row-parallel product the specs shard on "model" (the encoder's
      blocks at ``enc_tokens``), and after the vocab-sharded embedding
      lookup; train cells count the forward, the backward and, with
      remat, the recomputed forward, prefill and decode cells the forward.

    Context-parallel attention's sequence exchanges are not counted.
    Fills and returns ``costs``; ``collective_s`` is each term over its
    axes' link rate (:func:`roofline.link_bw`)."""
    costs = costs or HloCosts()
    named = dict(model.named_parameters())

    def add(op, nbytes, axes, count=1):
        costs.per_collective[op] += nbytes
        costs.collective_count[op] += count
        costs.collective_bytes += nbytes
        costs.collective_s += nbytes / RF.link_bw(mesh, axes)

    dp = SH.dp_axes(mesh)
    n_dp = 1
    for a in dp:
        n_dp *= SH.mesh_size(mesh, a)
    if kind == "train" and n_dp > 1:
        for k, p in named.items():
            spec = SH.param_spec(cfg, k, p.shape, mesh)
            per_dev = p.numel() * grad_itemsize / SH.spec_shards(spec, mesh)
            wire = _ring(n_dp) * per_dev
            if "data" in SH.zero1_spec(spec, p.shape, mesh):
                add("reduce-scatter", wire / 2, dp)
                add("all-gather", wire / 2, dp)
            else:
                add("all-reduce", wire, dp)
    tp = SH.mesh_size(mesh, "model")
    if tp > 1:
        passes = (3 if cfg.remat else 2) if kind == "train" else 1
        itemsize = named["embed"].element_size()
        per_token = cfg.d_model * itemsize * _ring(tp) * passes

        def sharded(name):
            return "model" in SH.param_spec(cfg, name, named[name].shape,
                                            mesh)
        n_dec = int(sharded("embed"))
        n_enc = 0
        for stack, leaves in _block_outputs(cfg, model):
            if any(sharded(k) for k in leaves):
                if stack == "encoder":
                    n_enc += 1
                else:
                    n_dec += 1
        if n_dec:
            add("all-reduce", n_dec * tokens * per_token, ("model",),
                n_dec * passes)
        if n_enc:
            add("all-reduce", n_enc * enc_tokens * per_token, ("model",),
                n_enc * passes)
    return costs
