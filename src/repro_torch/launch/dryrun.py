"""Dry-run entry point: every (architecture × input shape × mesh) cell
priced on the meta device against the H100 roofline (twin of
:mod:`repro.launch.dryrun`).

For every cell:
    build the cell (meta tensors: nothing allocated)
    → arguments' bytes per device, exact from the specs
    → one data-parallel replica's step traced op by op
      (:mod:`repro_torch.launch.cost_analysis`): FLOPs, unfused bytes,
      the peak of live bytes; the collectives analytic from the specs
    → roofline terms (:mod:`repro_torch.launch.roofline`)

A replica is the step on the batch one data-parallel group holds (the
global batch over the dp axes that shard it) on a mesh of the "model"
axis alone; its counts are divided over the devices it spans (``split``:
tp, or every chip when the batch is not sharded), an ideal partition.

Artifacts: one JSON per cell under ``--out`` (default ``runs/dryrun_torch``:
``runs/dryrun`` holds the reference's records; incremental: finished cells
are read back on a re-run, so the sweep is restartable).

Usage:
    python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k --mesh pod
    python -m repro_torch.launch.dryrun --all [--mesh both] [--out runs/dryrun_torch] --device cpu

``--mesh host`` prices a cell on ``make_host_mesh(1, 1)``, one device, to
hold it against the card.  The CLI runs on the card unless ``--device
cpu`` is given (the trace itself runs on the meta device either way).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback

import torch


def _leaves(tree, path=""):
    """``{path: leaf}`` of a tree of modules, optimizer states, dicts,
    lists and tensors (or specs: tuples are leaves)."""
    from ..optim import AdamState
    if isinstance(tree, torch.nn.Module):
        tree = dict(tree.named_parameters())
    elif isinstance(tree, AdamState):
        tree = {f.name: getattr(tree, f.name)
                for f in dataclasses.fields(tree)}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{path}/{k}"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_leaves(v, f"{path}/{i}"))
        return out
    if isinstance(tree, tuple) and path == "":      # the args tuple
        out = {}
        for i, v in enumerate(tree):
            out.update(_leaves(v, f"/{i}"))
        return out
    return {} if tree is None else {path: tree}


def _sharded_arg_bytes(args, specs, mesh) -> float:
    """Per-device bytes of the arguments: each leaf's bytes over the
    shards its spec splits it into (the reference's rule)."""
    from ..sharding.specs import spec_shards
    leaves, leaf_specs = _leaves(args), _leaves(specs)
    if set(leaves) != set(leaf_specs):
        raise ValueError(f"args and specs differ: "
                         f"{sorted(set(leaves) ^ set(leaf_specs))[:4]}")
    return sum(t.numel() * t.element_size()
               / spec_shards(leaf_specs[k], mesh)
               for k, t in leaves.items())


def _replica(shape, mesh):
    """(replica ShapeCell, mesh of the "model" axis alone): the batch that
    one data-parallel group holds."""
    from ..sharding import specs as SH
    from .mesh import make_replica_mesh
    dp = SH.spec_shards(SH.batch_spec(mesh, shape.batch), mesh)
    return (dataclasses.replace(shape, batch=shape.batch // dp),
            make_replica_mesh(mesh))


def _tokens(cfg, shape) -> tuple:
    """(decoder tokens, encoder tokens) a step of ``shape`` runs."""
    per_seq = 1 if shape.kind == "decode" else shape.seq
    enc = shape.batch * cfg.encoder_seq if (
        cfg.is_encoder_decoder and shape.kind != "decode") else 0
    return shape.batch * per_seq, enc


def run_cell(arch: str, shape, mesh_kind: str, out_dir: str,
             force: bool = False, verbose: bool = True, pod_shape=None,
             cache_quant: bool = False, device=None) -> dict:
    """Price one cell; returns (and writes) its record.  ``shape`` is a
    name of :data:`~repro_torch.launch.cells.SHAPES` or a
    :class:`~repro_torch.launch.cells.ShapeCell`; ``mesh_kind`` is "pod",
    "multipod" or "host" (``make_host_mesh(1, 1)`` on ``device``, None:
    the card)."""
    from ..configs import get_config
    from ..models import transformer as T
    from . import cells as C
    from . import cost_analysis as CA
    from .mesh import make_host_mesh, make_production_mesh
    from .roofline import Roofline

    cell = C.SHAPES[shape] if isinstance(shape, str) else shape
    os.makedirs(out_dir, exist_ok=True)
    tag = f"{arch}__{cell.name}__{mesh_kind}"
    if pod_shape:
        tag += f"_{pod_shape[0]}x{pod_shape[1]}"
    if cache_quant:
        tag += "_int8kv"
    tag = tag.replace("/", "_")
    path = os.path.join(out_dir, tag + ".json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)

    cfg = get_config(arch)
    if mesh_kind == "host":
        mesh = make_host_mesh(1, 1, device=device)
    else:
        mesh = make_production_mesh(multi_pod=(mesh_kind == "multipod"),
                                    pod_shape=pod_shape)
    chips = 1
    for n in mesh.shape.values():
        chips *= n
    rec = {"arch": arch, "shape": cell.name, "mesh": mesh_kind,
           "chips": chips, "ok": False}
    if not isinstance(shape, str):
        rec["cell"] = dataclasses.asdict(cell)
    t0 = time.time()
    try:
        reason = C.skip_reason(cfg, cell.name)
        if reason:
            rec.update(skipped=True, reason=reason, ok=True)
            _write(path, rec)
            if verbose:
                print(f"[dryrun] {tag}: SKIP ({reason.split(':')[0]})")
            return rec

        kw = {"cache_quant": True} if (
            cache_quant and cell.kind == "decode") else {}
        _, args, meta = C.build_cell(cfg, cell, mesh, **kw)
        arg_bytes = _sharded_arg_bytes(args, meta["specs"], mesh)
        model = args[0]
        model_fl = C.model_flops(cfg, cell, model)
        n_params = C.count_params(model)
        n_active = C.active_params(cfg, model)
        del args
        t_build = time.time() - t0

        # one data-parallel replica's step, traced
        rep_cell, rep_mesh = _replica(cell, mesh)
        fn, rargs, rmeta = C.build_cell(cfg, rep_cell, rep_mesh, **kw)
        meta.pop("specs")
        if rmeta.get("accum") != meta.get("accum"):
            raise ValueError(f"a replica takes {rmeta.get('accum')} "
                             f"microbatches, the cell {meta.get('accum')}")
        costs = CA.analyze(fn, *rargs)
        t_trace = time.time() - t0 - t_build
        split = chips * rep_cell.batch / cell.batch
        tokens, enc_tokens = _tokens(cfg, rep_cell)
        grad_itemsize = 4 if meta.get("accum", 1) > 1 \
            else T.model_dtype(cfg).itemsize
        CA.analytic_collectives(cfg, rargs[0], mesh, kind=cell.kind,
                                tokens=tokens, enc_tokens=enc_tokens,
                                grad_itemsize=grad_itemsize, costs=costs)
        del fn, rargs

        mem = {"analytic_args_bytes_per_device": int(arg_bytes),
               "temp_bytes_per_device": int(costs.peak_live_bytes / split),
               "replica_batch": rep_cell.batch, "split": split}
        mem["peak_bytes_per_device"] = (mem["analytic_args_bytes_per_device"]
                                        + mem["temp_bytes_per_device"])
        rf = Roofline(
            arch=arch, shape=cell.name, mesh=mesh_kind, chips=chips,
            flops_per_device=costs.flops / split,
            bytes_per_device=costs.bytes_accessed / split,
            collective_bytes_per_device=costs.collective_bytes,
            collective_s_per_device=costs.collective_s,
            model_flops_global=model_fl).finalize()
        rec.update(
            ok=True, skipped=False, meta=meta,
            build_s=round(t_build, 2), trace_s=round(t_trace, 2),
            memory=mem,
            analyzer={
                "flops_per_device": costs.flops / split,
                "bytes_per_device": costs.bytes_accessed / split,
                "bytes_model": "unfused: every op's operands and outputs",
                "collective_bytes_per_device": costs.collective_bytes,
                "collective_s_per_device": costs.collective_s,
                "per_collective": dict(costs.per_collective),
                "collective_count": dict(costs.collective_count),
                "collective_model": costs.collective_model,
                "trip_counts": dict(costs.trip_counts),
                "op_count": costs.op_count,
                "replica_flops": costs.flops,
                "replica_bytes": costs.bytes_accessed,
                "replica_peak_live_bytes": costs.peak_live_bytes,
            },
            model_flops=model_fl, params=n_params, active_params=n_active,
            roofline=rf.asdict())
        if verbose:
            print(f"[dryrun] {tag}: OK trace={t_trace:.1f}s {rf.row()} "
                  f"peak={mem['peak_bytes_per_device'] / 1e9:.2f}GB",
                  flush=True)
    except Exception as e:
        rec.update(error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
        if verbose:
            print(f"[dryrun] {tag}: FAIL {type(e).__name__}: "
                  f"{str(e)[:300]}", flush=True)
    finally:
        T.set_moe_parallel(None)        # a host mesh's hook ends here
    _write(path, rec)
    return rec


def _write(path, rec):
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, default=float)


def main(argv=None):
    from ..configs import ALL_ARCHS
    from ..device import resolve_device
    from .cells import SHAPES

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="pod",
                    choices=["pod", "multipod", "both", "host"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="runs/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--pod-shape", default=None,
                    help="override (data,model) factorisation, e.g. 32,8")
    ap.add_argument("--cache-int8", action="store_true",
                    help="int8-quantised KV caches for decode cells")
    ap.add_argument("--device", default=None,
                    help="the host mesh's device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    pod_shape = (tuple(int(x) for x in args.pod_shape.split(","))
                 if args.pod_shape else None)

    meshes = (["pod", "multipod"] if args.mesh == "both" else [args.mesh])
    archs = ALL_ARCHS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]

    t0 = time.time()
    results = []
    for mk in meshes:
        for arch in archs:
            for shape in shapes:
                results.append(run_cell(arch, shape, mk, args.out,
                                        force=args.force,
                                        pod_shape=pod_shape,
                                        cache_quant=args.cache_int8,
                                        device=device))
    ok = sum(1 for r in results if r.get("ok"))
    skipped = sum(1 for r in results if r.get("skipped"))
    print(f"[dryrun] {ok}/{len(results)} ok ({skipped} documented skips), "
          f"{len(results) - ok} failed, {time.time() - t0:.1f} s")
    return 0 if ok == len(results) else 1


if __name__ == "__main__":
    sys.exit(main())
