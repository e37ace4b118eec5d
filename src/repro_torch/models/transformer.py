"""Generic layer-stack model: interprets an ArchConfig's block pattern.

PyTorch twin of :mod:`repro.models.transformer` for every family of the
reference: dense, MoE, SSM, hybrid, the encoder-decoder (audio: whisper)
and the vision stub (vlm: phi-3-vision).  The reference scans its repeat
unit over stacked parameters; here the stack is a flat list of layers in
the order the scan runs them — the prefix, then rep by rep each unit layer
(layer ``len(prefix) + r·len(unit) + j`` is unit layer j of rep r) — and
a Python loop applies them.  An encoder-decoder's decoder stack follows
``decoder_pattern()`` and its encoder is a stack of its own
(:class:`Encoder`).  With ``cfg.remat``, a forward that builds a graph
checkpoints every layer (:func:`torch.utils.checkpoint.checkpoint`): the
backward keeps each layer's input and recomputes the rest, where the
reference's ``block_outs`` policy keeps the blocks' outputs of each
scanned unit — the same values either way.  The activation-sharding hook
is :func:`set_sharding_hook` (the reference's two tags, for
``attn_sequence_parallel`` configs); the expert-parallel hook is
:func:`set_moe_parallel`.

Parameters are frozen (``requires_grad=False``), so serving and
evaluation build no graph; a training step unfreezes them for its own
duration (:func:`repro_torch.train.objective.trainable`).

Entry points (``device=None`` is the CUDA card; the CPU only when asked):
    init_params(cfg, seed=0, max_position=0, device=None) — random weights
    forward(cfg, params, batch, device=None)         — (logits, aux)
    encode(cfg, params, frames, device=None)         — the encoder's output
    init_cache(cfg, batch, max_seq, quant=False, device=None) — per-layer caches
    prefill_cross_caches(cfg, params, enc_out)       — read-only cross K/V
    step_with_cache / decode_step                    — serving steps

Frames, the encoder's output and the cross caches must be in the model
dtype (the reference fails on a mismatch too, inside its scan); patch
embeddings are cast to it, as the reference casts them.
"""
from __future__ import annotations

import functools
import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig, LayerSpec
from ..device import resolve_device, to_device
from . import ssm as ssm_mod
from .attention import Attention, attention, init_kv_cache
from .layers import (MLP, MoE, mlp, moe, normal, rms_norm,
                     sinusoidal_positions, softcap, zeros)

FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")
# rows of the absolute position table when init_params gets max_position=0
DEFAULT_MAX_POSITION = 4096

# Optional explicit expert-parallel MoE dispatch, installed with its mesh:
#     set_moe_parallel(functools.partial(expert_parallel_moe, mesh=mesh,
#                                        dp_axes=("data",)))
# None -> the single-device dispatch of layers.moe.
_MOE_PARALLEL = None

# Optional activation-sharding hook (identity when None, so the model stays
# mesh-agnostic).  Signature: hook(tag, x) -> x, tags "attn_in" and
# "attn_out", applied around self-attention when the config sets
# ``attn_sequence_parallel`` (context-parallel attention).
_SHARDING_HOOK = None


def set_moe_parallel(fn):
    global _MOE_PARALLEL
    _MOE_PARALLEL = fn


def set_sharding_hook(fn):
    global _SHARDING_HOOK
    _SHARDING_HOOK = fn


def _hook(tag: str, x):
    return _SHARDING_HOOK(tag, x) if _SHARDING_HOOK is not None else x


def check_family(cfg: ArchConfig):
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}; the port runs the "
                         f"{', '.join(FAMILIES)} families")


def model_dtype(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def stack_pattern(cfg: ArchConfig):
    """(prefix, unit, reps) of the decoder stack: ``decoder_pattern()`` for
    an encoder-decoder, ``block_pattern()`` otherwise, as the reference
    picks them."""
    return (cfg.decoder_pattern() if cfg.is_encoder_decoder
            else cfg.block_pattern())


def encoder_pattern(cfg: ArchConfig):
    """(prefix, unit, reps) of the encoder: dense self-attention layers."""
    return (), (LayerSpec(kind="attn", ffn="dense"),), cfg.encoder_layers


def layer_specs(cfg: ArchConfig, pattern=None) -> list:
    """The LayerSpec of every layer of ``pattern`` (default: the decoder
    stack's), in the order the stack runs them."""
    prefix, unit, reps = pattern or stack_pattern(cfg)
    return list(prefix) + [s for _ in range(reps) for s in unit]


def check_dtype(cfg: ArchConfig, name: str, t: torch.Tensor):
    """Refuse a tensor that is not in the model dtype (frames, the
    encoder's output, cross caches)."""
    if t.dtype != model_dtype(cfg):
        raise ValueError(
            f"{cfg.name}: {name} must be in the model dtype "
            f"{model_dtype(cfg)}, got {t.dtype} (the reference fails on "
            f"this too: its scan cannot carry the promoted residual)")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def ssm_dims(cfg: ArchConfig) -> dict:
    return ssm_mod.ssm_dims(cfg.d_model, cfg.ssm_expand, cfg.ssm_head_dim,
                            cfg.ssm_state, cfg.ssm_conv, cfg.ssm_ngroups)


class Layer(nn.Module):
    """``init_layer``'s parameters: ``ln1`` and ``attn`` (or ``ssm``);
    for a cross layer ``ln_x`` and ``cross`` (an attention without
    qk-norm); then for a dense FFN ``ln2`` and ``mlp``, for a MoE FFN
    ``ln2`` and ``moe``, for ``ffn="none"`` nothing; with post-norms
    ``post_ln1`` and (with an FFN) ``post_ln2``.  Norm scales are float32
    zeros."""

    def __init__(self, cfg: ArchConfig, spec: LayerSpec, *, device,
                 generator=None):
        super().__init__()
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
        if spec.cross:
            self.ln_x = zeros((D,), device=device)
            self.cross = Attention(D, cfg.num_heads, cfg.num_kv_heads,
                                   cfg.resolved_head_dim, **g)
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


class Encoder(nn.Module):
    """The reference's ``params["encoder"]``: ``layers`` (its ``unit``,
    one dense self-attention layer a rep) and ``final_norm``."""

    def __init__(self, cfg: ArchConfig, *, device, generator=None):
        super().__init__()
        self.specs = layer_specs(cfg, encoder_pattern(cfg))
        self.layers = nn.ModuleList(
            Layer(cfg, s, device=device, generator=generator)
            for s in self.specs)
        self.final_norm = zeros((cfg.d_model,), device=device)


class Transformer(nn.Module):
    """``init_params``'s tree: ``embed`` (V, D), ``final_norm``, optionally
    ``unembed`` (D, V), ``pos_embed`` (max_position, D) with absolute
    positions, ``vision_proj`` (vision_embed_dim, D) with the vision stub,
    ``encoder`` (:class:`Encoder`) for an encoder-decoder, and ``layers``
    in run order (see module doc)."""

    def __init__(self, cfg: ArchConfig, *, device, generator=None,
                 max_position: int = 0):
        super().__init__()
        check_family(cfg)
        dt, D, V = model_dtype(cfg), cfg.d_model, cfg.padded_vocab
        g = dict(generator=generator, device=device, dtype=dt)
        self.cfg = cfg
        self.specs = layer_specs(cfg)
        self.embed = normal((V, D), D ** -0.5, **g)
        self.final_norm = zeros((D,), device=device)
        if not cfg.tie_embeddings:
            self.unembed = normal((D, V), D ** -0.5, **g)
        if cfg.abs_pos_embed:
            self.pos_embed = normal(
                (max_position or DEFAULT_MAX_POSITION, D), 0.01, **g)
        if cfg.vision_patches:
            E = cfg.vision_embed_dim
            self.vision_proj = normal((E, D), E ** -0.5, **g)
        self.layers = nn.ModuleList(
            Layer(cfg, s, device=device, generator=generator)
            for s in self.specs)
        if cfg.is_encoder_decoder:
            self.encoder = Encoder(cfg, device=device, generator=generator)


def init_params(cfg: ArchConfig, seed: int = 0, *, max_position: int = 0,
                device=None, generator=None) -> Transformer:
    """Random weights with the reference's shapes and scales, drawn on the
    device from ``generator`` (or a generator seeded with ``seed``);
    ``max_position`` rows of ``pos_embed`` (0: 4096), as the reference's.
    The draws are torch's, not ``jax.random``'s: to compare with the
    reference, convert its weights
    (:func:`repro_torch.interop.params_from_reference`).  On
    ``device="meta"`` nothing is drawn or allocated: the parameters have
    their shapes and dtypes only (a dry run's model)."""
    dev = resolve_device(device)
    if generator is None and dev.type != "meta":
        generator = torch.Generator(device=dev).manual_seed(seed)
    return Transformer(cfg, device=dev, generator=generator,
                       max_position=max_position)


# ---------------------------------------------------------------------------
# layer application
# ---------------------------------------------------------------------------

def apply_layer(cfg: ArchConfig, spec: LayerSpec, p: Layer, x, *,
                positions, causal=True, cache=None, cache_pos=None,
                enc_out=None, cross_cache=None, kv_len=None):
    """One block: attention or SSM, then for a cross layer attention over
    ``enc_out`` (or its read-only ``cross_cache``), then the FFN (dense,
    MoE or none), pre-norm residual (post-norms when the config has them).
    Under a cache the MoE dispatches dropless, as the reference's serving
    path.  ``kv_len`` is a ragged prefill's prompt-length mask
    (self-attention only).  Returns (x, cache, aux); aux is empty without
    a MoE."""
    aux = {}
    h = rms_norm(x, p.ln1, cfg.norm_eps)
    if spec.kind == "attn":
        if cfg.attn_sequence_parallel:
            h = _hook("attn_in", h)
        out, new_cache = attention(
            p.attn, h, positions=positions, num_heads=cfg.num_heads,
            num_kv_heads=cfg.num_kv_heads, head_dim=cfg.resolved_head_dim,
            rope_theta=cfg.rope_theta if cfg.use_rope else 0.0,
            causal=causal, window=spec.window,
            attn_softcap=cfg.attn_softcap, qk_norm=cfg.qk_norm,
            norm_eps=cfg.norm_eps, kv_cache=cache, cache_pos=cache_pos,
            kv_len=kv_len)
        if cfg.attn_sequence_parallel:
            out = _hook("attn_out", out)
    else:
        out, new_cache = ssm_mod.mamba2_block(
            p.ssm, h, dims=ssm_dims(cfg), norm_eps=cfg.norm_eps,
            ssm_cache=cache)
    if cfg.post_norms:
        out = rms_norm(out, p.post_ln1, cfg.norm_eps)
    x = x + out
    if spec.cross:
        if enc_out is None:
            raise ValueError(f"{cfg.name}: a cross-attention layer needs "
                             "enc_out")
        h = rms_norm(x, p.ln_x, cfg.norm_eps)
        out, _ = attention(
            p.cross, h, positions=positions, num_heads=cfg.num_heads,
            num_kv_heads=cfg.num_kv_heads, head_dim=cfg.resolved_head_dim,
            causal=False, x_kv=enc_out, kv_cache=cross_cache)
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


def _remat(cfg: ArchConfig, p: Layer, x) -> bool:
    """Checkpoint this layer: ``cfg.remat`` and a forward that builds a
    graph through it."""
    return cfg.remat and torch.is_grad_enabled() and (
        x.requires_grad or any(t.requires_grad for t in p.parameters()))


def zero_aux(device) -> dict:
    """The MoE aux terms at zero (their sum over a stack without MoE)."""
    z = torch.zeros((), dtype=torch.float32, device=device)
    return {"lb_loss": z, "router_z": z.clone(), "drop_frac": z.clone()}


def _acc_aux(acc: dict, aux: dict) -> dict:
    return {k: acc[k] + aux[k] for k in acc} if aux else acc


def run_stack(cfg: ArchConfig, stack, x, *, positions, causal=True,
              caches=None, cache_pos=None, enc_out=None, cross_caches=None,
              pattern=None, kv_len=None):
    """Apply every layer of ``stack`` (a module with ``specs`` and
    ``layers``: the model, or its :class:`Encoder` with ``pattern=
    encoder_pattern(cfg)``) in run order.  ``caches`` and ``cross_caches``
    are per-layer lists (or None); ``enc_out`` and ``kv_len`` go to every
    layer and the cross caches to the unit's layers only, as the reference
    passes them.
    Returns (x, caches, aux): aux summed as the reference sums it, the
    prefix's layers in turn, then each rep's unit layers from zero, then
    the reps' sums."""
    prefix, unit, _ = pattern or stack_pattern(cfg)
    n_pre = len(prefix)
    new_caches = []
    aux_sum = zero_aux(x.device)
    reps = []
    for i, (spec, p) in enumerate(zip(stack.specs, stack.layers)):
        c = caches[i] if caches is not None else None
        xc = cross_caches[i] if cross_caches is not None and i >= n_pre \
            else None
        kw = dict(positions=positions, causal=causal, cache=c,
                  cache_pos=cache_pos, enc_out=enc_out, cross_cache=xc,
                  kv_len=kv_len)
        if _remat(cfg, p, x):
            x, nc, aux = checkpoint(apply_layer, cfg, spec, p, x,
                                    use_reentrant=False, **kw)
        else:
            x, nc, aux = apply_layer(cfg, spec, p, x, **kw)
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

@functools.lru_cache(maxsize=8)
def _sinusoid_on(seq: int, dim: int, dtype: torch.dtype,
                 device: torch.device):
    """:func:`sinusoidal_positions` rounded to ``dtype`` on ``device``,
    copied there once."""
    return torch.as_tensor(sinusoidal_positions(seq, dim),
                           device=device).to(dtype)


def encode(cfg: ArchConfig, params: Transformer, frames, *, device=None):
    """Whisper encoder over stub frame embeddings (B, F, D) in the model
    dtype: the sinusoidal table rounded to that dtype is added, then the
    non-causal stack of ``encoder_layers`` and the encoder's final norm."""
    dev = check_device(params, device)
    frames = to_device(frames, dev)
    check_dtype(cfg, "frames", frames)
    B, F, D = frames.shape
    x = frames + _sinusoid_on(F, D, frames.dtype, frames.device)[None]
    positions = torch.arange(F, device=frames.device)[None].expand(B, F)
    x, _, _ = run_stack(cfg, params.encoder, x, positions=positions,
                        causal=False, pattern=encoder_pattern(cfg))
    return rms_norm(x, params.encoder.final_norm, cfg.norm_eps)


def embed_inputs(cfg: ArchConfig, params: Transformer, tokens,
                 pos_offset=0, *, patch_embeds=None):
    """Token embedding (× √D rounded to the model dtype when the config
    scales it), the projected patch embeddings before the text (cast to the
    model dtype first), the absolute position rows from ``pos_offset``
    (the start clamped so the rows fit the table, as
    ``dynamic_slice_in_dim`` clamps it), and the (B, S) positions.
    ``pos_offset`` is an int, a 0-d tensor, or a (B, 1) tensor of
    per-sequence offsets (no position table then); a tensor stays on the
    device."""
    x = params.embed[tokens]
    if cfg.embed_scale:
        # √D rounded to the model dtype on the host (no device copy)
        x = x * float(torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype))
    if patch_embeds is not None:
        pe = patch_embeds.to(x.dtype) @ params.vision_proj
        x = torch.cat([pe, x], dim=1)
    B, S = x.shape[:2]
    positions = pos_offset + torch.arange(S, device=x.device)[None] \
        .expand(B, S)
    if cfg.abs_pos_embed:
        rows = params.pos_embed.shape[0]
        if S > rows:
            raise ValueError(f"{S} positions do not fit the {rows}-row "
                             "position table")
        if isinstance(pos_offset, torch.Tensor):
            start = pos_offset.reshape(()).clamp(0, rows - S)
            x = x + params.pos_embed[start + torch.arange(
                S, device=x.device)][None]
        else:
            start = min(max(pos_offset, 0), rows - S)
            x = x + params.pos_embed[start:start + S][None]
    return x, positions


def lm_head(cfg: ArchConfig, params: Transformer, x):
    """Final norm, the logits product in the model dtype, then float32 and
    the final softcap (applied in place where no graph is built: the
    logits are the largest tensor of a scoring forward; autograd cannot
    take ``tanh_`` followed by ``mul_`` of its output)."""
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = torch.einsum("bsd,vd->bsv", x, params.embed)
    else:
        logits = torch.einsum("bsd,dv->bsv", x, params.unembed)
    logits = logits.float()
    if cfg.final_softcap and logits.requires_grad:
        logits = softcap(logits, cfg.final_softcap)
    elif cfg.final_softcap:
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
    holds ``tokens`` (B, S), for an encoder-decoder ``frames`` (B, F, D)
    in the model dtype, and for the vision stub optionally
    ``patch_embeds`` (B, P, E) (tensors or numpy arrays, moved to the
    parameters' device)."""
    dev = check_device(params, device)
    tokens = to_device(batch["tokens"], dev)
    enc_out = None
    if cfg.is_encoder_decoder:
        enc_out = encode(cfg, params, batch["frames"], device=dev)
    patch_embeds = batch.get("patch_embeds")
    if patch_embeds is not None:
        patch_embeds = to_device(patch_embeds, dev)
    x, positions = embed_inputs(cfg, params, tokens,
                                patch_embeds=patch_embeds)
    x, _, aux = run_stack(cfg, params, x, positions=positions, causal=True,
                          enc_out=enc_out)
    return lm_head(cfg, params, x), aux


# -- serving ----------------------------------------------------------------

def init_layer_cache(cfg: ArchConfig, spec: LayerSpec, batch: int,
                     max_seq: int, dtype=torch.bfloat16, quant: bool = False,
                     *, device):
    if spec.kind == "attn":
        return init_kv_cache(batch, max_seq, cfg.num_kv_heads,
                             cfg.resolved_head_dim, dtype,
                             window=spec.window, quant=quant, device=device)
    return ssm_mod.init_ssm_cache(batch, ssm_dims(cfg), dtype, device=device)


def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, quant: bool = False, *,
               device=None) -> list:
    """Decode caches for the whole decoder stack, one dict per layer in run
    order: KV caches for attention layers (ring buffers where the window <
    max_seq; int8 with ``quant``), ``{"conv", "h"}`` for SSM layers.
    Cross caches come from :func:`prefill_cross_caches`."""
    check_family(cfg)
    dev = resolve_device(device)
    return [init_layer_cache(cfg, s, batch, max_seq, dtype, quant,
                             device=dev)
            for s in layer_specs(cfg)]


def prefill_cross_caches(cfg: ArchConfig, params: Transformer, enc_out):
    """Read-only cross-attention K/V from the encoder's output (B, F, D),
    one ``{"k", "v"}`` (B, F, KH, hd) a layer in run order (None for a
    layer without cross-attention)."""
    check_dtype(cfg, "enc_out", enc_out)
    return [{"k": torch.einsum("bsd,dhk->bshk", enc_out, p.cross.wk),
             "v": torch.einsum("bsd,dhk->bshk", enc_out, p.cross.wv)}
            if s.cross else None
            for s, p in zip(params.specs, params.layers)]


def step_with_cache(cfg: ArchConfig, params: Transformer, caches, tokens,
                    pos, patch_embeds=None, enc_out=None,
                    cross_caches=None, prompt_len=None):
    """Forward S tokens (S=1 decode, S>1 prefill) writing the caches at
    ``pos``, with the vision stub's ``patch_embeds`` before the text and an
    encoder-decoder's ``enc_out`` and ``cross_caches`` (in the model
    dtype).  Returns (logits, caches); the caches are written in place.

    ``pos`` is an int or a 0-d tensor (every sequence at the same depth),
    or a (B, 1) int tensor of per-sequence depths (continuous batching:
    positions, RoPE, the masks and the cache writes follow each sequence;
    not with absolute position embeddings).  A tensor ``pos`` stays on the
    device.  ``prompt_len`` ((B,) int tensor, a prefill of right-padded
    ragged prompts): pad keys are masked out of the attention windows and
    never enter ring caches; read the next token from ``logits[b,
    prompt_len[b] - 1]``.  Attention-only stacks (an SSM state update has
    no pad mask; the serve engine guards this)."""
    tensor_pos = isinstance(pos, torch.Tensor)
    if tensor_pos and pos.ndim != 0 and cfg.abs_pos_embed:
        raise ValueError(
            "per-sequence positions are not supported with absolute "
            "position embeddings (the pos_embed table is indexed by a "
            "uniform batch offset); use a scalar pos")
    if enc_out is not None:
        check_dtype(cfg, "enc_out", enc_out)
    for c in cross_caches or ():
        if c is not None:
            check_dtype(cfg, "a cross cache", c["k"])
            check_dtype(cfg, "a cross cache", c["v"])
    x, positions = embed_inputs(cfg, params, tokens, pos,
                                patch_embeds=patch_embeds)
    cache_pos = pos.reshape(-1, 1) if tensor_pos else pos
    x, new_caches, _ = run_stack(cfg, params, x, positions=positions,
                                 causal=True, caches=caches,
                                 cache_pos=cache_pos, enc_out=enc_out,
                                 cross_caches=cross_caches,
                                 kv_len=prompt_len)
    return lm_head(cfg, params, x), new_caches


def decode_step(cfg: ArchConfig, params: Transformer, caches, tokens,
                pos, enc_out=None, cross_caches=None):
    """One serving step: ``tokens`` (B, 1) at absolute position ``pos``
    (an int, a 0-d tensor or a (B, 1) tensor)."""
    return step_with_cache(cfg, params, caches, tokens, pos,
                           enc_out=enc_out, cross_caches=cross_caches)
