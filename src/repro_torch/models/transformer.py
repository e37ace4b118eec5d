"""Generic layer-stack model: interprets an ArchConfig's block pattern.

PyTorch twin of :mod:`repro.models.transformer` for the dense, MoE, SSM
and hybrid families.  The reference scans its repeat unit over stacked
parameters; here the stack is a flat list of layers in the order the scan
runs them — the prefix, then rep by rep each unit layer (layer
``len(prefix) + r·len(unit) + j`` is unit layer j of rep r) — and a Python
loop applies them.  ``remat`` and the sharding hook are no-ops for a
forward on one device; the expert-parallel hook is
:func:`set_moe_parallel`.

Entry points (``device=None`` is the CUDA card; the CPU only when asked):
    init_params(cfg, seed=0, device=None)            — random weights
    forward(cfg, params, batch, device=None)         — (logits, aux)
    init_cache(cfg, batch, max_seq, device=None)     — per-layer KV / SSM caches
    step_with_cache / decode_step                    — serving steps

The audio and vision families raise :class:`NotImplementedError` naming
their ROADMAP item.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..configs.base import ArchConfig, LayerSpec
from ..device import resolve_device, to_device
from . import ssm as ssm_mod
from .attention import Attention, attention, init_kv_cache
from .layers import MLP, MoE, mlp, moe, normal, rms_norm, zeros

# families of the reference that later slices bring, with their ROADMAP item
LATER_FAMILIES = {
    "audio": "ROADMAP.md A8 (cross-attention and encoder)",
    "vlm": "ROADMAP.md A8 (vision stub)",
}
FAMILIES = ("dense", "moe", "ssm", "hybrid")

# Optional explicit expert-parallel MoE dispatch, installed with its mesh:
#     set_moe_parallel(functools.partial(expert_parallel_moe, mesh=mesh,
#                                        dp_axes=("data",)))
# None -> the single-device dispatch of layers.moe.
_MOE_PARALLEL = None


def set_moe_parallel(fn):
    global _MOE_PARALLEL
    _MOE_PARALLEL = fn


def check_family(cfg: ArchConfig):
    if cfg.family in LATER_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family belongs to a later slice "
            f"of the port ({LATER_FAMILIES[cfg.family]}); the port runs the "
            f"{', '.join(FAMILIES)} families")
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}")


def model_dtype(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def layer_specs(cfg: ArchConfig) -> list:
    """The LayerSpec of every layer, in the order the stack runs them."""
    prefix, unit, reps = cfg.block_pattern()
    return list(prefix) + [s for _ in range(reps) for s in unit]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def ssm_dims(cfg: ArchConfig) -> dict:
    return ssm_mod.ssm_dims(cfg.d_model, cfg.ssm_expand, cfg.ssm_head_dim,
                            cfg.ssm_state, cfg.ssm_conv, cfg.ssm_ngroups)


class Layer(nn.Module):
    """``init_layer``'s parameters: ``ln1`` and ``attn`` (or ``ssm``),
    then for a dense FFN ``ln2`` and ``mlp``, for a MoE FFN ``ln2`` and
    ``moe``, for ``ffn="none"`` nothing; with post-norms ``post_ln1`` and
    (with an FFN) ``post_ln2``.  Norm scales are float32 zeros."""

    def __init__(self, cfg: ArchConfig, spec: LayerSpec, *, device,
                 generator=None):
        super().__init__()
        if spec.cross:
            raise NotImplementedError(
                f"layer {spec} belongs to a later slice of the port "
                "(ROADMAP.md A8: cross-attention and encoder)")
        dt, D = model_dtype(cfg), cfg.d_model
        g = dict(device=device, dtype=dt, generator=generator)
        self.ln1 = zeros((D,), device=device)
        if spec.kind == "attn":
            self.attn = Attention(D, cfg.num_heads, cfg.num_kv_heads,
                                  cfg.resolved_head_dim, qk_norm=cfg.qk_norm,
                                  **g)
        else:
            self.ssm = ssm_mod.SSM(D, ssm_dims(cfg), **g)
        if cfg.post_norms:
            self.post_ln1 = zeros((D,), device=device)
        if spec.ffn == "none":
            return
        self.ln2 = zeros((D,), device=device)
        if spec.ffn == "dense":
            self.mlp = MLP(D, cfg.d_ff, cfg.mlp_gated, **g)
        else:
            self.moe = MoE(D, cfg.n_experts, cfg.expert_d_ff,
                           cfg.n_shared_experts, cfg.shared_d_ff,
                           cfg.mlp_gated, **g)
        if cfg.post_norms:
            self.post_ln2 = zeros((D,), device=device)


class Transformer(nn.Module):
    """``init_params``'s tree: ``embed`` (V, D), ``final_norm``, optionally
    ``unembed`` (D, V), and ``layers`` in run order (see module doc)."""

    def __init__(self, cfg: ArchConfig, *, device, generator=None):
        super().__init__()
        check_family(cfg)
        if cfg.abs_pos_embed or cfg.vision_patches:
            raise NotImplementedError(
                "absolute position embeddings and the vision stub belong to "
                "a later slice of the port (ROADMAP.md A8)")
        dt, D, V = model_dtype(cfg), cfg.d_model, cfg.padded_vocab
        g = dict(generator=generator, device=device, dtype=dt)
        self.cfg = cfg
        self.specs = layer_specs(cfg)
        self.embed = normal((V, D), D ** -0.5, **g)
        self.final_norm = zeros((D,), device=device)
        if not cfg.tie_embeddings:
            self.unembed = normal((D, V), D ** -0.5, **g)
        self.layers = nn.ModuleList(
            Layer(cfg, s, device=device, generator=generator)
            for s in self.specs)


def init_params(cfg: ArchConfig, seed: int = 0, *, device=None,
                generator=None) -> Transformer:
    """Random weights with the reference's shapes and scales, drawn on the
    device from ``generator`` (or a generator seeded with ``seed``).  The
    draws are torch's, not ``jax.random``'s: to compare with the reference,
    convert its weights (:func:`repro_torch.interop.params_from_reference`)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(seed)
    return Transformer(cfg, device=dev, generator=generator)


# ---------------------------------------------------------------------------
# layer application
# ---------------------------------------------------------------------------

def apply_layer(cfg: ArchConfig, spec: LayerSpec, p: Layer, x, *,
                positions, causal=True, cache=None, cache_pos=None):
    """One block: attention or SSM, then the FFN (dense, MoE or none),
    pre-norm residual (post-norms when the config has them).  Under a
    cache the MoE dispatches dropless, as the reference's serving path.
    Returns (x, cache, aux); aux is empty without a MoE."""
    aux = {}
    h = rms_norm(x, p.ln1, cfg.norm_eps)
    if spec.kind == "attn":
        out, new_cache = attention(
            p.attn, h, positions=positions, num_heads=cfg.num_heads,
            num_kv_heads=cfg.num_kv_heads, head_dim=cfg.resolved_head_dim,
            rope_theta=cfg.rope_theta if cfg.use_rope else 0.0,
            causal=causal, window=spec.window,
            attn_softcap=cfg.attn_softcap, qk_norm=cfg.qk_norm,
            norm_eps=cfg.norm_eps, kv_cache=cache, cache_pos=cache_pos)
    else:
        out, new_cache = ssm_mod.mamba2_block(
            p.ssm, h, dims=ssm_dims(cfg), norm_eps=cfg.norm_eps,
            ssm_cache=cache)
    if cfg.post_norms:
        out = rms_norm(out, p.post_ln1, cfg.norm_eps)
    x = x + out
    if spec.ffn == "none":
        return x, new_cache, aux
    h = rms_norm(x, p.ln2, cfg.norm_eps)
    if spec.ffn == "dense":
        out = mlp(p.mlp, h, cfg.act)
    elif _MOE_PARALLEL is not None and not cfg.moe_dropless:
        out, aux = _MOE_PARALLEL(p.moe, h, top_k=cfg.top_k, act=cfg.act,
                                 capacity_factor=cfg.moe_capacity_factor)
    else:
        out, aux = moe(p.moe, h, top_k=cfg.top_k, act=cfg.act,
                       capacity_factor=cfg.moe_capacity_factor,
                       dropless=cfg.moe_dropless or cache is not None)
    if cfg.post_norms:
        out = rms_norm(out, p.post_ln2, cfg.norm_eps)
    return x + out, new_cache, aux


def zero_aux(device) -> dict:
    """The MoE aux terms at zero (their sum over a stack without MoE)."""
    z = torch.zeros((), dtype=torch.float32, device=device)
    return {"lb_loss": z, "router_z": z.clone(), "drop_frac": z.clone()}


def _acc_aux(acc: dict, aux: dict) -> dict:
    return {k: acc[k] + aux[k] for k in acc} if aux else acc


def run_stack(cfg: ArchConfig, params: Transformer, x, *, positions,
              causal=True, caches=None, cache_pos=None):
    """Apply every layer in run order.  ``caches`` is a per-layer list (or
    None).  Returns (x, caches, aux): aux summed as the reference sums it,
    the prefix's layers in turn, then each rep's unit layers from zero,
    then the reps' sums."""
    prefix, unit, _ = cfg.block_pattern()
    n_pre = len(prefix)
    new_caches = []
    aux_sum = zero_aux(x.device)
    reps = []
    for i, (spec, p) in enumerate(zip(params.specs, params.layers)):
        c = caches[i] if caches is not None else None
        x, nc, aux = apply_layer(cfg, spec, p, x, positions=positions,
                                 causal=causal, cache=c, cache_pos=cache_pos)
        new_caches.append(nc)
        if i < n_pre:
            aux_sum = _acc_aux(aux_sum, aux)
            continue
        if (i - n_pre) % len(unit) == 0:
            reps.append(zero_aux(x.device))
        reps[-1] = _acc_aux(reps[-1], aux)
    if reps:
        aux_sum = {k: aux_sum[k] + torch.stack([r[k] for r in reps]).sum()
                   for k in aux_sum}
    return x, new_caches, aux_sum


# ---------------------------------------------------------------------------
# model entry points
# ---------------------------------------------------------------------------

def embed_inputs(cfg: ArchConfig, params: Transformer, tokens,
                 pos_offset: int = 0):
    """Token embedding (× √D rounded to the model dtype when the config
    scales it) and the (B, S) absolute positions."""
    x = params.embed[tokens]
    if cfg.embed_scale:
        # √D rounded to the model dtype on the host (no device copy)
        x = x * float(torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype))
    B, S = x.shape[:2]
    positions = pos_offset + torch.arange(S, device=x.device)[None] \
        .expand(B, S)
    return x, positions


def lm_head(cfg: ArchConfig, params: Transformer, x):
    """Final norm, the logits product in the model dtype, then float32 and
    the final softcap (applied in place: the logits are the largest
    tensor of a scoring forward)."""
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = torch.einsum("bsd,vd->bsv", x, params.embed)
    else:
        logits = torch.einsum("bsd,dv->bsv", x, params.unembed)
    logits = logits.float()
    if cfg.final_softcap:
        logits.div_(cfg.final_softcap).tanh_().mul_(cfg.final_softcap)
    return logits


def check_device(params: Transformer, device) -> torch.device:
    """The parameters' device, which must be ``device`` (None: the card)."""
    dev = resolve_device(device)
    have = params.embed.device
    if have.type != dev.type or (dev.index is not None and have != dev):
        raise ValueError(f"the parameters lie on {have}, not on {dev}")
    return have


def forward(cfg: ArchConfig, params: Transformer, batch: dict, *,
            device=None):
    """Training / evaluation forward: returns (logits, aux).  ``batch``
    holds ``tokens`` (B, S) (a tensor or numpy array, moved to the
    parameters' device)."""
    dev = check_device(params, device)
    tokens = to_device(batch["tokens"], dev)
    x, positions = embed_inputs(cfg, params, tokens)
    x, _, aux = run_stack(cfg, params, x, positions=positions, causal=True)
    return lm_head(cfg, params, x), aux


# -- serving ----------------------------------------------------------------

def init_layer_cache(cfg: ArchConfig, spec: LayerSpec, batch: int,
                     max_seq: int, dtype=torch.bfloat16, *, device):
    if spec.kind == "attn":
        return init_kv_cache(batch, max_seq, cfg.num_kv_heads,
                             cfg.resolved_head_dim, dtype,
                             window=spec.window, device=device)
    return ssm_mod.init_ssm_cache(batch, ssm_dims(cfg), dtype, device=device)


def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, *, device=None) -> list:
    """Decode caches for the whole stack, one dict per layer in run order:
    KV caches for attention layers (ring buffers where the window <
    max_seq), ``{"conv", "h"}`` for SSM layers."""
    check_family(cfg)
    dev = resolve_device(device)
    return [init_layer_cache(cfg, s, batch, max_seq, dtype, device=dev)
            for s in layer_specs(cfg)]


def step_with_cache(cfg: ArchConfig, params: Transformer, caches, tokens,
                    pos: int):
    """Forward S tokens (S=1 decode, S>1 prefill) writing the caches at
    ``pos`` (one position for the whole batch).  Returns (logits, caches);
    the caches are written in place."""
    if isinstance(pos, torch.Tensor):
        if pos.ndim != 0:
            raise NotImplementedError(
                "per-sequence positions (continuous batching) belong to a "
                "later slice of the port (ROADMAP.md A9)")
        pos = int(pos)
    x, positions = embed_inputs(cfg, params, tokens, pos_offset=pos)
    x, new_caches, _ = run_stack(cfg, params, x, positions=positions,
                                 causal=True, caches=caches, cache_pos=pos)
    return lm_head(cfg, params, x), new_caches


def decode_step(cfg: ArchConfig, params: Transformer, caches, tokens,
                pos: int):
    """One serving step: ``tokens`` (B, 1) at absolute position ``pos``."""
    return step_with_cache(cfg, params, caches, tokens, pos)
