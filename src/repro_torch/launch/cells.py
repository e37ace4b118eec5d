"""Dry-run cells: (architecture × input shape) → a step on the meta device
(twin of :mod:`repro.launch.cells`).

Each builder returns ``(fn, args, meta)``:
    fn    — the port's own step: ``Trainer.train_step`` (``grad_accum_step``
            then ``AdamW.update``), the serve tier's ``prefill`` (after
            ``encode`` / ``prefill_cross_caches`` for an encoder-decoder),
            or ``decode_step``
    args  — its arguments as ``torch.device("meta")`` tensors at the
            cell's global shapes: shapes and dtypes, **no allocation**
    meta  — ``specs`` (each argument leaf's spec on the mesh, the
            reference's in/out shardings), ``accum`` for a train cell

Shapes (the reference's):
    train_4k     seq 4,096   global_batch 256   (train_step)
    prefill_32k  seq 32,768  global_batch 32    (serve prefill)
    decode_32k   cache 32,768 batch 128         (decode_step, 1 new token)
    long_500k    cache 524,288 batch 1          (decode_step; sub-quadratic
                                                 archs only — see skips)
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..models import transformer as T
from ..optim import AdamW
from ..serve.engine import prefill
from ..sharding import specs as SH
from ..train.trainer import TrainConfig, Trainer

META = torch.device("meta")


@dataclasses.dataclass
class ShapeCell:
    name: str
    kind: str          # train | prefill | decode
    seq: int
    batch: int


SHAPES = {
    "train_4k": ShapeCell("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524288, 1),
}


class CellSkipped(Exception):
    pass


def skip_reason(cfg: ArchConfig, shape: str) -> Optional[str]:
    if shape == "long_500k" and not cfg.sub_quadratic:
        return ("pure full-attention arch: 500k decode requires "
                "sub-quadratic attention (DESIGN.md §Arch-applicability)")
    return None


def pick_accum(cfg: ArchConfig, shape: ShapeCell, mesh) -> int:
    """Grad-accum depth: keep the per-device microbatch ≈ 1–2 sequences
    for wide models (remat keeps one layer's activations live)."""
    dp = int(np.prod([SH.mesh_size(mesh, a) for a in SH.dp_axes(mesh)]))
    per_dev = max(1, shape.batch // dp)
    target = 1 if cfg.d_model >= 3584 else 2
    accum = max(1, per_dev // target)
    while shape.batch % accum or (shape.batch // accum) % dp:
        accum //= 2
        if accum <= 1:
            return 1
    return accum


def _text_len(cfg: ArchConfig, seq: int) -> int:
    return seq - (cfg.vision_patches or 0)


def install_sharding_hook(cfg: ArchConfig, mesh):
    """Launcher-side parallelism policy.  On a device mesh (:class:`~repro_
    torch.sharding.Mesh`) with a "model" axis that divides the experts,
    the explicit expert-parallel MoE dispatch
    (:func:`~repro_torch.models.moe_parallel.expert_parallel_moe`), as the
    reference installs it.  The reference's context-parallel hook places
    GSPMD sharding constraints, which a single controller has no
    counterpart of, so the activation hook stays off.  On an abstract mesh
    nothing is installed (both hooks off)."""
    T.set_sharding_hook(None)
    tp = SH.mesh_size(mesh, "model")
    if (isinstance(mesh, SH.Mesh) and cfg.n_experts and tp > 1
            and cfg.n_experts % tp == 0):
        from ..models.moe_parallel import expert_parallel_moe
        T.set_moe_parallel(functools.partial(
            expert_parallel_moe, mesh=mesh, dp_axes=SH.dp_axes(mesh)))
    else:
        T.set_moe_parallel(None)


def _model(cfg: ArchConfig, shape: ShapeCell):
    return T.init_params(cfg, max_position=shape.seq, device=META)


def _inputs(cfg: ArchConfig, shape: ShapeCell, mesh, tokens: int):
    """The batch tensors and their specs: ``tokens`` (B, tokens) int32,
    and where the model takes them ``frames`` / ``patch_embeds`` in the
    model dtype."""
    B, dt = shape.batch, T.model_dtype(cfg)
    args = {"tokens": torch.empty((B, tokens), dtype=torch.int32,
                                  device=META)}
    specs = {"tokens": SH.batch_spec(mesh, B)}
    if cfg.is_encoder_decoder and shape.kind != "decode":
        args["frames"] = torch.empty((B, cfg.encoder_seq, cfg.d_model),
                                     dtype=dt, device=META)
        specs["frames"] = SH.batch_spec(mesh, B, 3)
    if cfg.vision_patches and shape.kind != "decode":
        args["patch_embeds"] = torch.empty(
            (B, cfg.vision_patches, cfg.vision_embed_dim), dtype=dt,
            device=META)
        specs["patch_embeds"] = SH.batch_spec(mesh, B, 3)
    return args, specs


# ---------------------------------------------------------------------------
# cell builders
# ---------------------------------------------------------------------------

def build_train_cell(cfg: ArchConfig, shape: ShapeCell, mesh):
    install_sharding_hook(cfg, mesh)
    opt = AdamW(lr=3e-4, weight_decay=0.1)
    accum = pick_accum(cfg, shape, mesh)
    model = _model(cfg, shape)
    state = opt.init(model)
    batch, b_specs = _inputs(cfg, shape, mesh, _text_len(cfg, shape.seq))
    batch["labels"] = torch.empty_like(batch["tokens"])
    b_specs["labels"] = b_specs["tokens"]
    trainer = Trainer(cfg, TrainConfig(accum=accum), opt, device=META)
    specs = (SH.params_shardings(cfg, model, mesh),
             SH.opt_shardings(cfg, state, mesh), b_specs)
    return trainer.train_step, (model, state, batch), {
        "accum": accum, "specs": specs}


def build_prefill_cell(cfg: ArchConfig, shape: ShapeCell, mesh):
    install_sharding_hook(cfg, mesh)
    model = _model(cfg, shape)
    args, a_specs = _inputs(cfg, shape, mesh, _text_len(cfg, shape.seq))

    @torch.no_grad()
    def prefill_step(params, a):
        enc_out = cross = None
        if cfg.is_encoder_decoder:
            enc_out = T.encode(cfg, params, a["frames"], device=META)
            cross = T.prefill_cross_caches(cfg, params, enc_out)
        return prefill(cfg, params, a["tokens"], max_seq=shape.seq,
                       patch_embeds=a.get("patch_embeds"), enc_out=enc_out,
                       cross_caches=cross, device=META)

    specs = (SH.params_shardings(cfg, model, mesh), a_specs)
    return prefill_step, (model, args), {"specs": specs}


def build_decode_cell(cfg: ArchConfig, shape: ShapeCell, mesh,
                      cache_quant: bool = False):
    install_sharding_hook(cfg, mesh)
    model = _model(cfg, shape)
    caches = T.init_cache(cfg, shape.batch, shape.seq, quant=cache_quant,
                          device=META)
    args, a_specs = _inputs(cfg, shape, mesh, 1)
    args["pos"] = torch.empty((), dtype=torch.int32, device=META)
    a_specs["pos"] = SH.replicated(mesh)
    extra, x_specs = {}, {}
    if cfg.is_encoder_decoder:
        extra["enc_out"] = torch.empty(
            (shape.batch, cfg.encoder_seq, cfg.d_model),
            dtype=T.model_dtype(cfg), device=META)
        x_specs["enc_out"] = SH.batch_spec(mesh, shape.batch, 3)
        extra["cross"] = T.prefill_cross_caches(cfg, model, extra["enc_out"])
        x_specs["cross"] = SH.cache_shardings(cfg, extra["cross"], mesh,
                                              shape.batch, seq_shard=False)

    @torch.no_grad()
    def decode_step(params, caches, a, ex):
        return T.decode_step(cfg, params, caches, a["tokens"], a["pos"],
                             enc_out=ex.get("enc_out"),
                             cross_caches=ex.get("cross"))

    specs = (SH.params_shardings(cfg, model, mesh),
             SH.cache_shardings(cfg, caches, mesh, shape.batch), a_specs,
             x_specs)
    return decode_step, (model, caches, args, extra), {"specs": specs}


def build_cell(cfg: ArchConfig, shape, mesh, **kw):
    """Returns (fn, meta-device args, meta) or raises :class:`CellSkipped`.
    ``shape`` is a name of :data:`SHAPES` or a :class:`ShapeCell`."""
    cell = SHAPES[shape] if isinstance(shape, str) else shape
    reason = skip_reason(cfg, cell.name)
    if reason:
        raise CellSkipped(reason)
    if cell.kind == "train":
        return build_train_cell(cfg, cell, mesh)
    if cell.kind == "prefill":
        return build_prefill_cell(cfg, cell, mesh)
    return build_decode_cell(cfg, cell, mesh, **kw)


# ---------------------------------------------------------------------------
# analytic model FLOPs (for the roofline's usefulness ratio)
# ---------------------------------------------------------------------------

def _named(params) -> dict:
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def count_params(params) -> int:
    return int(sum(np.prod(p.shape) for p in _named(params).values()))


def active_params(cfg: ArchConfig, params) -> int:
    """Active parameters per token (MoE: top_k of n_experts routed)."""
    total = count_params(params)
    if not cfg.n_experts:
        return total
    routed = sum(int(np.prod(p.shape)) for k, p in _named(params).items()
                 if any(w in k for w in ("w_up", "w_gate", "w_down")))
    return total - routed + int(routed * cfg.top_k / cfg.n_experts)


def model_flops(cfg: ArchConfig, shape, params) -> float:
    """6·N_active·D for train; 2·N_active per generated token for decode;
    2·N_active·D for prefill (forward only)."""
    sh = SHAPES[shape] if isinstance(shape, str) else shape
    n_act = active_params(cfg, params)
    tokens = sh.batch * (sh.seq if sh.kind != "decode" else 1)
    mult = 6 if sh.kind == "train" else 2
    return float(mult) * n_act * tokens
