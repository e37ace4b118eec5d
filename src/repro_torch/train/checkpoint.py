"""Checkpointing: step-atomic, topology-free, in the reference's format.

PyTorch twin of :mod:`repro.train.checkpoint`: one ``arrays.npz`` of
logical arrays plus a ``manifest.json`` (step, leaf count, dtype tags,
extra), bfloat16 leaves stored as uint16 views, and the leaves in the
order the reference flattens its tree.  A checkpoint written by either
package restores in the other.

* A :class:`~repro_torch.models.transformer.Transformer` is written as the
  reference's ``init_params`` tree (:func:`repro_torch.interop.
  reference_tree`: dict keys sorted, unit layers stacked on the rep axis),
  an :class:`~repro_torch.optim.AdamState` as the reference's ``AdamState``
  (``step``, then ``master``, ``m`` and ``v``, each as that tree of the
  model found in the same checkpointed tree); other dicts, lists and
  tuples as ``jax.tree_util`` flattens them.
* **step-atomic**: written to ``<dir>/.tmp-<step>`` and published by the
  rename-aside protocol of :mod:`repro_torch.resilience.recovery`, so a
  crash mid-write never corrupts the latest checkpoint and a re-save of a
  step never leaves a moment with no copy on disk; ``latest_step`` and
  ``restore`` tolerate stray ``.tmp-*`` / ``.old-*`` dirs.
* **retention**: keeps the newest ``keep`` checkpoints.

``restore`` writes a model's parameters and an optimizer state's tensors
in place (their storage is kept); other leaves come back as new tensors.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional

import numpy as np
import torch

from ..interop import named_from_reference, reference_tree
from ..models.transformer import Transformer
from ..optim.adam import AdamState
from ..resilience import recovery as _rec


def _model_cfg(tree):
    """The config of the first model in ``tree`` (None if it holds none):
    an optimizer state is laid out as that model's tree."""
    if isinstance(tree, Transformer):
        return tree.cfg
    if isinstance(tree, dict):
        tree = [tree[k] for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        for sub in tree:
            cfg = _model_cfg(sub)
            if cfg is not None:
                return cfg
    return None


def _first(xs):
    return xs[0]


def _host_stack(xs):
    """One unit leaf's reps stacked where they lie, then copied to the
    host in one piece."""
    return torch.stack([x.detach() for x in xs]).cpu()


def _flatten(tree, cfg, stack=_host_stack) -> list:
    """Leaves in the reference's order (see module doc); ``stack`` joins
    a unit leaf's reps (``_first`` where only the count matters)."""
    if isinstance(tree, Transformer):
        named = dict(tree.named_parameters())
        return _flatten(reference_tree(tree.cfg, named, stack=stack), cfg,
                        stack)
    if isinstance(tree, AdamState):
        out = [tree.step]
        for d in (tree.master, tree.m, tree.v):
            out += _flatten(reference_tree(cfg, d, stack=stack)
                            if cfg else d, cfg, stack)
        return out
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _flatten(tree[k], cfg, stack)]
    if isinstance(tree, (list, tuple)):
        return [x for sub in tree for x in _flatten(sub, cfg, stack)]
    if tree is None:
        return []
    return [tree]


def _to_numpy(leaf):
    """(array, dtype tag): bfloat16 as a uint16 view."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), str(t.numpy().dtype)
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        return arr.view(np.uint16), "bfloat16"
    return arr, str(arr.dtype)


def _from_numpy(arr, tag: str) -> torch.Tensor:
    if tag == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()) \
            .view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def save(ckpt_dir: str, step: int, tree: Any, *, keep: int = 3,
         extra: Optional[dict] = None) -> str:
    tmp = _rec.fresh_tmp_dir(ckpt_dir, str(step))
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    leaves = _flatten(tree, _model_cfg(tree))
    arrays, dtypes = {}, {}
    for i, leaf in enumerate(leaves):
        arrays[str(i)], dtypes[str(i)] = _to_numpy(leaf)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = {"step": step, "n_leaves": len(leaves),
                "dtypes": dtypes, "extra": extra or {}}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    # rename-aside publish: a same-step re-save sets the previous copy
    # aside until the new one is in place
    _rec.publish_dir(tmp, final)
    _retain(ckpt_dir, keep)
    return final


def _retain(ckpt_dir: str, keep: int):
    for s in _rec.list_steps(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:010d}"))


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = _rec.list_steps(ckpt_dir)  # sweeps stray .tmp-*/.old-* dirs
    return steps[-1] if steps else None


def _unflatten(struct, leaves):
    """``struct``'s dicts, lists and tuples with the next leaves in
    flatten order (``leaves`` an iterator)."""
    if isinstance(struct, dict):
        return {k: _unflatten(struct[k], leaves) for k in sorted(struct)}
    if isinstance(struct, (list, tuple)):
        return type(struct)(_unflatten(s, leaves) for s in struct)
    return next(leaves)


def _fill(named: dict, cfg, leaves):
    """Copy the next leaves, a reference tree laid out as ``named``'s,
    into ``named``'s tensors in place (without a model's config: the
    names in sorted order)."""
    if cfg is None:
        got = {k: next(leaves) for k in sorted(named)}
    else:
        tree = _unflatten(reference_tree(cfg, named, stack=_first), leaves)
        got = named_from_reference(cfg, tree, list(named))
    for name, arr in got.items():
        dst = named[name]
        src = torch.as_tensor(arr)
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"checkpoint leaf {name}: shape "
                             f"{tuple(src.shape)} != {tuple(dst.shape)}")
        with torch.no_grad():
            dst.copy_(src)


def _rebuild(template, cfg, leaves, device):
    if isinstance(template, Transformer):
        _fill(dict(template.named_parameters()), template.cfg, leaves)
        return template
    if isinstance(template, AdamState):
        template.step.copy_(next(leaves))
        for d in (template.master, template.m, template.v):
            _fill(d, cfg, leaves)
        return template
    if isinstance(template, dict):
        return {k: _rebuild(template[k], cfg, leaves, device)
                for k in sorted(template)}
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(t, cfg, leaves, device)
                              for t in template)
    if template is None:
        return None
    leaf = next(leaves)
    dev = device if device is not None else (
        template.device if isinstance(template, torch.Tensor) else "cpu")
    return leaf.to(dev)


def restore(ckpt_dir: str, template: Any, *, step: Optional[int] = None,
            device=None):
    """Restore into the structure of ``template``: a model's parameters
    and an optimizer state's tensors are written in place; other leaves
    come back as tensors on ``device`` (None: the template leaf's device,
    or the CPU for a numpy leaf).  Returns (tree, step, extra)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:010d}")
    if not os.path.isdir(path):  # maybe orphaned mid-publish: promote .old
        _rec.sweep_strays(ckpt_dir)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    cfg = _model_cfg(template)
    n = len(_flatten(template, cfg, _first))
    if manifest["n_leaves"] != n:
        raise ValueError(f"checkpoint holds {manifest['n_leaves']} leaves, "
                         f"the template {n}: structure mismatch")
    with np.load(os.path.join(path, "arrays.npz")) as data:
        leaves = iter([_from_numpy(data[str(i)], manifest["dtypes"][str(i)])
                       for i in range(n)])
    tree = _rebuild(template, cfg, leaves, device)
    return tree, manifest["step"], manifest.get("extra", {})
