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
  the port's per-layer cross caches;
* :func:`reference_tree` — the inverse: the port's tensors by parameter
  name (a model's parameters, its gradients, an optimizer's masters or
  moments) as the reference's ``init_params`` tree, unit layers restacked
  on the rep axis; :func:`named_from_reference` — such a tree's leaves by
  the port's parameter names (what gradient parity and checkpoints in the
  reference's leaf order need).

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
        if isinstance(sub, torch.Tensor):
            return sub[r]
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


def params_from_reference(cfg: ArchConfig, params_np: dict, *,
                          device=None):
    """The reference's ``init_params(cfg, key, max_position)`` tree, leaves
    converted to numpy, as the port's model on ``device`` (None: the CUDA
    card); the position table keeps the tree's row count.  Every leaf is
    copied under its port name (:func:`named_from_reference`); the two
    must hold the same leaves, with the same shapes."""
    from .models.transformer import Transformer, encoder_pattern
    dev = resolve_device(device)
    rows = np.shape(params_np["pos_embed"])[0] if "pos_embed" in params_np \
        else 0
    model = Transformer(cfg, device=dev, max_position=rows)  # filled below
    named = dict(model.named_parameters())
    top = {k: v for k, v in params_np.items()
           if k not in ("prefix", "unit", "encoder")}
    n_top = sum(1 for n in named if n.split(".")[0] not in
                ("layers", "encoder"))
    if n_top != _count_leaves(top):
        raise ValueError(f"reference top-level leaves {sorted(top)} do not "
                         f"match the port's parameters")
    if cfg.is_encoder_decoder != ("encoder" in params_np):
        raise ValueError(f"{cfg.name}: the reference tree "
                         f"{'lacks' if cfg.is_encoder_decoder else 'has'} "
                         "an encoder")
    n_ref = n_top + sum(_count_leaves(t) for t in reference_layers(
        cfg, params_np))
    if cfg.is_encoder_decoder:
        enc = params_np["encoder"]
        if sorted(enc) != ["final_norm", "unit"]:
            raise ValueError(f"reference encoder leaves {sorted(enc)}; want "
                             "final_norm and unit")
        n_ref += 1 + sum(_count_leaves(t) for t in reference_layers(
            cfg, {"unit": enc["unit"]}, encoder_pattern(cfg)))
    if n_ref != len(named):
        raise ValueError(f"the reference holds {n_ref} leaves, the port "
                         f"{len(named)}")
    for name, arr in named_from_reference(cfg, params_np, named).items():
        src = tensor_from_numpy(arr, dev)
        param = named[name]
        if tuple(src.shape) != tuple(param.shape):
            raise ValueError(f"{name}: reference shape {tuple(src.shape)} "
                             f"!= {tuple(param.shape)}")
        param.data.copy_(src)
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


def _stack(xs):
    return torch.stack(xs) if isinstance(xs[0], torch.Tensor) \
        else np.stack([np.asarray(x) for x in xs])


def _nest(flat: dict) -> dict:
    """``{"a.b": x}`` → ``{"a": {"b": x}}``."""
    out = {}
    for dotted, x in flat.items():
        *path, last = dotted.split(".")
        node = out
        for key in path:
            node = node.setdefault(key, {})
        node[last] = x
    return out


def _restack(layers: dict, pattern, stack) -> dict:
    """Per-layer leaves (``{i: {"attn.wq": x, ...}}``, run order) as the
    reference's ``{"prefix": [...], "unit": [...]}``, unit leaves stacked
    over the reps (inverse of :func:`reference_layers`)."""
    prefix, unit, reps = pattern
    n_pre, n_unit = len(prefix), len(unit)
    if sorted(layers) != list(range(n_pre + n_unit * reps)):
        raise ValueError(f"{len(layers)} layers do not fill a pattern of "
                         f"{n_pre} + {n_unit} x {reps}")
    units = []
    for j in range(n_unit):
        rows = [layers[n_pre + r * n_unit + j] for r in range(reps)]
        units.append(_nest({k: stack([row[k] for row in rows])
                            for k in rows[0]}))
    return {"prefix": [_nest(layers[i]) for i in range(n_pre)],
            "unit": units}


def reference_tree(cfg: ArchConfig, named: dict, *, stack=None) -> dict:
    """The port's tensors by parameter name (``model.named_parameters()``,
    or gradients and optimizer state under the same names) as the
    reference's ``init_params`` tree: top-level leaves by name, the
    decoder stack as ``prefix`` and ``unit`` (unit layers stacked on a
    leading rep axis), an encoder as ``{"unit", "final_norm"}``.
    ``stack`` joins the reps (default ``torch.stack``, ``np.stack`` for
    numpy leaves)."""
    from .models.transformer import encoder_pattern, stack_pattern
    stack = stack or _stack
    top, layers, enc_top, enc_layers = {}, {}, {}, {}
    for name, x in named.items():
        head, _, rest = name.partition(".")
        if head == "layers":
            i, _, leaf = rest.partition(".")
            layers.setdefault(int(i), {})[leaf] = x
        elif head == "encoder" and rest.startswith("layers."):
            i, _, leaf = rest[len("layers."):].partition(".")
            enc_layers.setdefault(int(i), {})[leaf] = x
        elif head == "encoder":
            enc_top[rest] = x
        else:
            top[name] = x
    tree = _nest(top)
    tree.update(_restack(layers, stack_pattern(cfg), stack))
    if enc_layers or enc_top:
        enc = _restack(enc_layers, encoder_pattern(cfg), stack)
        del enc["prefix"]
        tree["encoder"] = {**enc, **_nest(enc_top)}
    return tree


def named_from_reference(cfg: ArchConfig, tree: dict, names) -> dict:
    """The leaves of a reference ``init_params``-shaped tree (numpy
    leaves) under the port's parameter ``names``: each unit leaf sliced at
    its rep."""
    from .models.transformer import encoder_pattern
    layers = reference_layers(cfg, tree)
    enc = (reference_layers(cfg, {"unit": tree["encoder"]["unit"]},
                            encoder_pattern(cfg))
           if "encoder" in tree else [])
    out = {}
    for name in names:
        head, _, rest = name.partition(".")
        if head == "layers":
            i, _, leaf = rest.partition(".")
            out[name] = _leaf(layers[int(i)], leaf)
        elif head == "encoder" and rest.startswith("layers."):
            i, _, leaf = rest[len("layers."):].partition(".")
            out[name] = _leaf(enc[int(i)], leaf)
        else:
            out[name] = _leaf(tree, name)
    return out
