"""Serving engine — autoregressive decode as Loop-of-stencil-reduce-s.

PyTorch twin of :mod:`repro.serve.engine` (round mode, greedy).  The decode
loop is the pattern's -s variant, as in the reference:
    stencil step : one ``decode_step`` (attention over the KV-cache
                   neighbourhood — the sliding-window layers are literal
                   sequence stencils)
    reduce /⊕    : ``all`` monoid over per-sequence done flags
    state s      : position counter
    condition c  : every sequence hit EOS ∨ token budget

It runs on the port's :class:`~repro_torch.core.pattern.
LoopOfStencilReduce` in step mode on ``backend="torch"`` (the twin of the
reference's default ``"jnp"``): a host loop whose body is the decode step
on the card, with one host read per step (the done flag).  The KV caches
stay on the device and are written in place.

Sampled decode (``temperature > 0``), the continuous engine and the
batcher come with a later slice (ROADMAP.md A9).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..configs.base import ArchConfig
from ..core.pattern import LoopOfStencilReduce
from ..device import to_device
from ..models import transformer as T


@dataclasses.dataclass
class GenerateConfig:
    max_new_tokens: int = 64
    eos_id: int = 1
    temperature: float = 0.0       # 0 → greedy
    seed: int = 0


@torch.no_grad()
def prefill(cfg: ArchConfig, params, tokens, *, max_seq: int,
            cache_dtype=torch.bfloat16, patch_embeds=None, enc_out=None,
            cross_caches=None, device=None):
    """Run the prompt (after the vision stub's patches, when given) through
    the model, returning (last_logits, caches)."""
    dev = T.check_device(params, device)
    tokens = to_device(tokens, dev)
    if patch_embeds is not None:
        patch_embeds = to_device(patch_embeds, dev)
    caches = T.init_cache(cfg, tokens.shape[0], max_seq, cache_dtype,
                          device=dev)
    logits, caches = T.step_with_cache(
        cfg, params, caches, tokens, 0, patch_embeds=patch_embeds,
        enc_out=enc_out, cross_caches=cross_caches)
    return logits[:, -1], caches


@torch.no_grad()
def generate(cfg: ArchConfig, params, prompt, gcfg: GenerateConfig, *,
             max_seq: Optional[int] = None, cache_dtype=torch.bfloat16,
             enc_out=None, cross_caches=None, patch_embeds=None,
             budgets=None, device=None):
    """Batched greedy generation.  Returns (tokens (B, max_new), lengths,
    iters), as the reference's ``generate``.

    An encoder-decoder takes ``enc_out`` and ``cross_caches``
    (:func:`~repro_torch.models.transformer.prefill_cross_caches`), both
    in the model dtype, into every step; the vision stub takes
    ``patch_embeds`` into the prefill, and its decode positions start
    after ``cfg.vision_patches`` of them.  ``budgets`` is an optional (B,)
    int vector of per-sequence ``max_new_tokens`` (each in [1,
    gcfg.max_new_tokens]): the done-mask retires a sequence at its own
    budget; ``lengths`` is clipped to it (post-done positions are
    eos-padded)."""
    if gcfg.temperature > 0:
        raise NotImplementedError(
            "sampled decode (temperature > 0) belongs to a later slice of "
            "the port (ROADMAP.md A9): jax.random keys cannot be "
            "reproduced in torch")
    dev = T.check_device(params, device)
    prompt = to_device(prompt, dev)
    B, S0 = prompt.shape
    P = cfg.vision_patches or 0
    max_new = gcfg.max_new_tokens
    max_seq = max_seq or (S0 + P + max_new)

    last_logits, caches = prefill(cfg, params, prompt, max_seq=max_seq,
                                  cache_dtype=cache_dtype,
                                  patch_embeds=patch_embeds, enc_out=enc_out,
                                  cross_caches=cross_caches, device=dev)
    bud = (torch.full((B,), max_new, dtype=torch.int32, device=dev)
           if budgets is None else
           torch.as_tensor(budgets, dtype=torch.int32, device=dev))
    first = torch.argmax(last_logits, dim=-1)                 # (B,)
    out0 = torch.zeros((B, max_new), dtype=torch.int32, device=dev)
    out0[:, 0] = first
    done0 = (first == gcfg.eos_id) | (bud <= 1)

    def step_fn(carry):
        caches, out, done, t = carry
        tok = out[:, t - 1:t]
        logits, caches = T.decode_step(cfg, params, caches, tok,
                                       S0 + P + t - 1, enc_out=enc_out,
                                       cross_caches=cross_caches)
        nxt = torch.argmax(logits[:, 0], dim=-1)
        nxt = torch.where(done, torch.full_like(nxt, gcfg.eos_id), nxt)
        if max_new > 1:
            # cap == 1: the repeat/until still runs its one mandatory body
            # step, whose write (t=1) would land past the only column
            out[:, t] = nxt.to(out.dtype)
        done = done | (nxt == gcfg.eos_id) | (t + 1 >= bud)
        return (caches, out, done, t + 1)

    loop = LoopOfStencilReduce(
        f=step_fn, mode="step", combine="all", identity=True,
        measure=lambda c: c[2],                   # per-sequence done flags
        cond=lambda r, s: r | (s >= max_new),
        state_init=lambda: torch.ones((), dtype=torch.int32, device=dev),
        state_update=lambda s, a, it: s + 1,
        max_iters=max_new, backend="torch", device=dev)

    res = loop.run((caches, out0, done0, 1))
    _, out, done, _ = res.a
    is_eos = out == gcfg.eos_id
    lengths = torch.where(
        is_eos.any(dim=1), is_eos.int().argmax(dim=1) + 1,
        torch.full((B,), max_new, dtype=torch.int64, device=dev))
    lengths = torch.minimum(lengths, bud.long()).to(torch.int32)
    return out, lengths, res.iters
