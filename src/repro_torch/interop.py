"""Carry state across from the JAX package to the port.

This system has no weights: its state is the grid, the env fields and the
loop state.  The helpers here take that state as numpy arrays (what the
reference's arrays convert to) and rebuild it in the port's layout:

* :func:`frame_from_numpy` — a reference halo frame, re-tiled into the
  port's :class:`~repro_torch.core.frames.FrameSpec` (the two packages pick
  different tiles, so the domain is copied and the ghost ring re-asserted);
* :func:`lane_frames_from_numpy` — the same for a reference lane stack
  (``farm_run``'s carry), into the port's lane layout;
* :func:`loop_result_from_numpy` — a reference ``LoopResult``;
* :func:`elemental_from_reference` — a reference elemental-function factory
  name and its parameters → the port's :class:`~repro_torch.kernels.ref.
  Elemental` (or :class:`~repro_torch.kernels.ref.Measure`);
* :func:`params_from_reference` — the reference LM's ``init_params`` tree
  (leaves as numpy; attention, cross-attention, MLP, MoE and SSM layers
  alike, the encoder's stack, ``pos_embed`` and ``vision_proj``: every leaf
  by its dotted name) → the port's :class:`~repro_torch.models.transformer.
  Transformer`; :func:`caches_from_reference` — its decode caches (KV and
  SSM ``{"conv", "h"}``) → the port's per-layer cache list;
  :func:`cross_caches_from_reference` — ``prefill_cross_caches``' tree →
  the port's per-layer cross caches.

Nothing here imports the JAX package: names and arrays are the interface.
"""
from __future__ import annotations

import numpy as np
import torch

from .configs.base import ArchConfig
from .core.frames import FrameSpec, make_frame, make_lane_frames
from .core.pattern import LoopResult
from .device import resolve_device
from .kernels import ref as R

_FACTORIES = {
    "jacobi_taps": R.jacobi_taps,
    "helmholtz_jacobi_taps": R.helmholtz_jacobi_taps,
    "sobel_taps": R.sobel_taps,
    "gol_taps": R.gol_taps,
    "median3_taps": R.median3_taps,
    "amf_detect_taps": R.amf_detect_taps,
    "restore_taps": R.restore_taps,
    "heat_taps": R.heat_taps,
    "conv_taps": R.conv_taps,
}


def frame_from_numpy(frame_np, *, m: int, n: int, pad: int, boundary,
                     spec: FrameSpec, device=None) -> torch.Tensor:
    """Re-tile a reference frame (domain at ``[pad:pad+m, pad:pad+n]``)
    into a frame of the port's ``spec`` on ``device``."""
    if (spec.m, spec.n) != (m, n):
        raise ValueError(
            f"spec domain {(spec.m, spec.n)} != frame domain {(m, n)}")
    frame_np = np.asarray(frame_np)
    dom = frame_np[pad:pad + m, pad:pad + n]
    if dom.shape != (m, n):
        raise ValueError(
            f"frame of shape {frame_np.shape} holds no {m}x{n} domain at "
            f"pad {pad}")
    a = torch.tensor(dom, device=resolve_device(device))
    return make_frame(a, spec, boundary)


def loop_result_from_numpy(a, reduced, iters, health=None, state=None, *,
                           device=None) -> LoopResult:
    """A reference ``LoopResult``'s arrays as the port's ``LoopResult``."""
    dev = resolve_device(device)
    return LoopResult(
        a=torch.tensor(np.asarray(a), device=dev),
        reduced=torch.tensor(np.asarray(reduced), device=dev),
        iters=torch.tensor(np.asarray(iters), dtype=torch.int32,
                           device=dev),
        state=state,
        health=None if health is None else torch.tensor(
            np.asarray(health), dtype=torch.int32, device=dev))


def elemental_from_reference(name: str, **params):
    """The port's elemental function for the reference factory ``name``
    (e.g. ``"helmholtz_jacobi_taps"``, ``alpha=.., dx=..``);
    ``"abs_delta"`` gives the measure.  ``amf_detect_taps`` returns the
    ``(mask, repl)`` pair, as the reference does."""
    if name == "abs_delta":
        if params:
            raise TypeError("abs_delta takes no parameters")
        return R.abs_delta
    if name not in _FACTORIES:
        raise ValueError(
            f"no port counterpart for {name!r}; known: "
            f"{sorted(_FACTORIES) + ['abs_delta']}")
    return _FACTORIES[name](**params)


def lane_frames_from_numpy(frames_np, *, m: int, n: int, pad: int, boundary,
                           spec: FrameSpec, device=None) -> torch.Tensor:
    """Re-tile a reference lane stack of frames ((lanes, H, W), each domain
    at ``[pad:pad+m, pad:pad+n]``) into the port's lane layout
    (:class:`~repro_torch.core.frames.LaneFrameSpec` of ``spec``) on
    ``device``."""
    if (spec.m, spec.n) != (m, n):
        raise ValueError(
            f"spec domain {(spec.m, spec.n)} != frame domain {(m, n)}")
    frames_np = np.asarray(frames_np)
    dom = frames_np[:, pad:pad + m, pad:pad + n]
    if frames_np.ndim != 3 or dom.shape[1:] != (m, n):
        raise ValueError(
            f"lane stack of shape {frames_np.shape} holds no {m}x{n} "
            f"domains at pad {pad}")
    a = torch.tensor(dom, device=resolve_device(device))
    return make_lane_frames(a, spec, boundary)


def tensor_from_numpy(arr, device) -> torch.Tensor:
    """A numpy array (bfloat16 ones included, as JAX hands them out) as a
    tensor on ``device``."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        bits = torch.from_numpy(arr.view(np.uint16).astype(np.int16))
        return bits.view(torch.bfloat16).to(device)
    return torch.tensor(arr, device=device)


def reference_layers(cfg: ArchConfig, tree: dict, pattern=None) -> list:
    """The per-layer subtrees of a reference ``{"prefix": [...], "unit":
    [...]}`` tree, in the order the stack runs them: ``prefix[i]`` is layer
    i, and ``unit[j]`` sliced at rep r is layer ``len(prefix) + r·len(unit)
    + j``.  ``pattern`` defaults to the decoder stack's (``decoder_pattern()``
    for an encoder-decoder, else ``block_pattern()``); an encoder's
    ``{"unit": [...]}`` takes ``encoder_pattern(cfg)``."""
    from .models.transformer import stack_pattern
    prefix, unit, reps = pattern or stack_pattern(cfg)
    tree = {"prefix": [], **tree}
    if len(tree["prefix"]) != len(prefix) or len(tree["unit"]) != len(unit):
        raise ValueError(
            f"tree holds {len(tree['prefix'])} prefix and {len(tree['unit'])}"
            f" unit entries; {cfg.name}'s pattern has {len(prefix)} and "
            f"{len(unit)}")

    def rep(sub, r):
        if isinstance(sub, dict):
            return {k: rep(v, r) for k, v in sub.items()}
        return np.asarray(sub)[r]
    return list(tree["prefix"]) + [rep(tree["unit"][j], r)
                                   for r in range(reps)
                                   for j in range(len(unit))]


def _leaf(tree: dict, dotted: str):
    for key in dotted.split("."):
        tree = tree[key]
    return tree


def _count_leaves(tree) -> int:
    if isinstance(tree, dict):
        return sum(_count_leaves(v) for v in tree.values())
    return 1


# submodules loaded layer by layer, not by name
_STACKS = ("layers", "encoder")


def _load(module: torch.nn.Module, tree: dict, where: str):
    """Copy every parameter of ``module`` from the same-named leaf of
    ``tree``, but those under the ``_STACKS`` submodules; shapes must
    agree."""
    names = dict(module.named_parameters(recurse=True))
    for name, param in names.items():
        if "." in name and name.split(".")[0] in _STACKS:
            continue
        src = tensor_from_numpy(_leaf(tree, name), param.device)
        if tuple(src.shape) != tuple(param.shape):
            raise ValueError(f"{where}{name}: reference shape "
                             f"{tuple(src.shape)} != {tuple(param.shape)}")
        param.data.copy_(src)


def _load_layers(layers: torch.nn.ModuleList, trees: list, where: str):
    """Load each port layer from its reference subtree, checking that the
    two hold the same number of leaves."""
    if len(trees) != len(layers):
        raise ValueError(f"{where}: the reference holds {len(trees)} layers,"
                         f" the port {len(layers)}")
    for i, (layer, tree) in enumerate(zip(layers, trees)):
        if _count_leaves(tree) != len(list(layer.parameters())):
            raise ValueError(f"{where}{i}: the reference holds "
                             f"{_count_leaves(tree)} leaves, the port "
                             f"{len(list(layer.parameters()))}")
        _load(layer, tree, f"{where}{i}.")


def params_from_reference(cfg: ArchConfig, params_np: dict, *,
                          device=None):
    """The reference's ``init_params(cfg, key, max_position)`` tree, leaves
    converted to numpy, as the port's model on ``device`` (None: the CUDA
    card); the position table keeps the tree's row count."""
    from .models.transformer import Transformer, encoder_pattern
    dev = resolve_device(device)
    rows = np.shape(params_np["pos_embed"])[0] if "pos_embed" in params_np \
        else 0
    model = Transformer(cfg, device=dev, max_position=rows)  # filled below
    top = {k: v for k, v in params_np.items()
           if k not in ("prefix", "unit", "encoder")}
    n_top = sum(1 for n, _ in model.named_parameters()
                if n.split(".")[0] not in _STACKS)
    if n_top != _count_leaves(top):
        raise ValueError(f"reference top-level leaves {sorted(top)} do not "
                         f"match the port's parameters")
    _load(model, top, "")
    _load_layers(model.layers, reference_layers(cfg, params_np), "layers.")
    if cfg.is_encoder_decoder != ("encoder" in params_np):
        raise ValueError(f"{cfg.name}: the reference tree "
                         f"{'lacks' if cfg.is_encoder_decoder else 'has'} "
                         "an encoder")
    if cfg.is_encoder_decoder:
        enc = params_np["encoder"]
        if sorted(enc) != ["final_norm", "unit"]:
            raise ValueError(f"reference encoder leaves {sorted(enc)}; want "
                             "final_norm and unit")
        _load(model.encoder, {"final_norm": enc["final_norm"]}, "encoder.")
        _load_layers(model.encoder.layers,
                     reference_layers(cfg, {"unit": enc["unit"]},
                                      encoder_pattern(cfg)),
                     "encoder.layers.")
    return model


def caches_from_reference(cfg: ArchConfig, caches_np: dict, *,
                          device=None) -> list:
    """The reference's decode caches (``init_cache`` / ``step_with_cache``
    output, leaves as numpy) as the port's per-layer list of cache dicts."""
    dev = resolve_device(device)
    return [{k: tensor_from_numpy(v, dev) for k, v in c.items()}
            for c in reference_layers(cfg, caches_np)]


def cross_caches_from_reference(cfg: ArchConfig, cross_np: dict, *,
                                device=None) -> list:
    """The reference's ``prefill_cross_caches`` tree (leaves as numpy) as
    the port's per-layer list of read-only ``{"k", "v"}``."""
    dev = resolve_device(device)
    return [{k: tensor_from_numpy(v, dev) for k, v in c.items()}
            for c in reference_layers(cfg, cross_np)]
