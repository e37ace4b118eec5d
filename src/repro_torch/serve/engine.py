"""Serving engine — autoregressive decode as Loop-of-stencil-reduce-s.

PyTorch twin of :mod:`repro.serve.engine`.  The decode loop is the
pattern's -s variant, as in the reference:
    stencil step : one ``decode_step`` (attention over the KV-cache
                   neighbourhood — the sliding-window layers are literal
                   sequence stencils)
    reduce /⊕    : ``all`` monoid over per-sequence done flags
    state s      : position counter (and the sampling counters)
    condition c  : every sequence hit EOS ∨ token budget

Round mode (:func:`generate`) runs on the port's :class:`~repro_torch.core.
pattern.LoopOfStencilReduce` in step mode on ``backend="torch"`` (the twin
of the reference's default ``"jnp"``): a host loop whose body is the decode
step on the card, with one host read per step (the done flag).  The KV
caches stay on the device and are written in place.  :func:`generate_jit`
is the compiled twin (the reference's one on-device ``while_loop``): the
prefill runs eagerly, then one decode step captured as a CUDA graph
(:mod:`~repro_torch.serve.graphs`) is replayed, the host reading the loop
condition once every ``CHECK_EVERY`` replays.

:class:`ContinuousEngine` is continuous batching: persistent KV-cache slots,
ragged admission and per-sequence refill, bounded decode segments on the
port's :func:`~repro_torch.core.pattern.segmented_while` whose body replays
the captured step, deadlines, snapshot/resume and the chained dispatcher.

Sampled decode (``temperature > 0``).  ``jax.random`` keys cannot be
reproduced in torch, so the port draws its own randomness: the Gumbel-max
trick over uniform bits from a counter-based integer hash (a 32-bit
finalizer in int64 arithmetic, :func:`uniform_bits`).  Each draw is a pure
function of (``gcfg.seed``, a stream index, a step): the row in
:func:`generate`, the admission index in the continuous engine.  A hash
was chosen over a ``torch.Generator`` per row because it runs as a few
elementwise passes over the whole batch on the device, with no generator
state to carry: the engine keeps (admission index, draws so far) per slot
as a (slots, 2) int64 tensor in its carry, in place of the reference's
keys, so a snapshot carries the key state and a resumed run samples the
tokens an uninterrupted one would.  Greedy decode (``temperature == 0``)
is the reference's, token for token.
"""
from __future__ import annotations

import dataclasses
import time
import weakref
from collections import deque
from typing import Callable, Optional

import numpy as np
import torch

from .. import obs
from ..configs.base import ArchConfig
from ..core.pattern import LoopOfStencilReduce, segmented_while
from ..device import to_device
from ..models import transformer as T
from ..models.attention import decode_route_calls
from ..models.layers import MOE_SPANS
from .graphs import StepGraph, graph_counts

# the continuous engine's spans (repro_torch.obs), the MoE layer's among
# them; the device ones record CUDA events
SERVE_SPANS = ("serve.admit", "serve.segment", "serve.drain", "serve.emit",
               "loop.step", "loop.exit_read") + MOE_SPANS
SERVE_DEVICE_SPANS = ("serve.admit", "serve.segment", "loop.step") \
    + MOE_SPANS


@dataclasses.dataclass
class GenerateConfig:
    max_new_tokens: int = 64
    eos_id: int = 1
    temperature: float = 0.0       # 0 → greedy
    seed: int = 0


_M32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """``(x * c) mod 2**32`` for x in [0, 2**32) without int64 overflow
    (the constant split into 16-bit halves)."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _mix32(x):
    """A 32-bit integer finalizer (xor-shift / multiply rounds) on int64
    tensors holding values in [0, 2**32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def uniform_bits(seed: int, stream, step, n: int):
    """(B, n) float32 uniforms in (0, 1), a pure function of (``seed``,
    ``stream[b]``, ``step[b]``, column): each of the three keys is hashed
    in turn, then each column's counter, keeping 24 bits."""
    h = _mix32(torch.full_like(stream, seed & _M32))
    h = _mix32(h ^ (stream & _M32))
    h = _mix32(h ^ (step & _M32))
    col = _mul32(torch.arange(n, device=stream.device, dtype=torch.int64),
                 0x9E3779B9)
    x = _mix32(_mix32((h[:, None] + col) & _M32))
    return ((x >> 8).float() + 0.5) * 2.0 ** -24


def sample_tokens(logits, temperature: float, seed: int, stream, step):
    """One token a row: the argmax when ``temperature == 0``, else a draw
    from softmax(logits / temperature) by the Gumbel-max trick over
    :func:`uniform_bits` (``stream``, ``step``: (B,) int64 tensors)."""
    if temperature <= 0:
        return torch.argmax(logits, dim=-1)
    u = uniform_bits(seed, stream.to(torch.int64), step.to(torch.int64),
                     logits.shape[-1])
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(logits.float() / temperature + gumbel, dim=-1)


@torch.no_grad()
def prefill(cfg: ArchConfig, params, tokens, *, max_seq: int,
            cache_dtype=torch.bfloat16, patch_embeds=None, enc_out=None,
            cross_caches=None, quant: bool = False, device=None):
    """Run the prompt (after the vision stub's patches, when given) through
    the model, returning (last_logits, caches).  ``quant``: the int8 KV
    cache (:func:`~repro_torch.models.transformer.init_cache`)."""
    dev = T.check_device(params, device)
    tokens = to_device(tokens, dev)
    caches = T.init_cache(cfg, tokens.shape[0], max_seq, cache_dtype, quant,
                          device=dev)
    return _prefill_into(cfg, params, caches, tokens, patch_embeds, enc_out,
                         cross_caches), caches


def _prefill_into(cfg, params, caches, tokens, patch_embeds, enc_out,
                  cross_caches):
    """The prompt's forward from position 0 into ``caches`` (written in
    place); returns the last row's logits."""
    if patch_embeds is not None:
        patch_embeds = to_device(patch_embeds, tokens.device)
    logits, _ = T.step_with_cache(
        cfg, params, caches, tokens, 0, patch_embeds=patch_embeds,
        enc_out=enc_out, cross_caches=cross_caches)
    return logits[:, -1]


def _budget_vector(budgets, B: int, max_new: int, dev) -> torch.Tensor:
    return (torch.full((B,), max_new, dtype=torch.int32, device=dev)
            if budgets is None else
            torch.as_tensor(budgets, dtype=torch.int32, device=dev))


def _lengths(out, bud, gcfg: GenerateConfig):
    """Each row's length: up to and including its first EOS (the whole row
    without one), clipped to its budget (post-done positions are eos
    pads)."""
    is_eos = out == gcfg.eos_id
    lengths = torch.where(
        is_eos.any(dim=1), is_eos.int().argmax(dim=1) + 1,
        torch.full((out.shape[0],), gcfg.max_new_tokens, dtype=torch.int64,
                   device=out.device))
    return torch.minimum(lengths, bud.long()).to(torch.int32)


@torch.no_grad()
def generate(cfg: ArchConfig, params, prompt, gcfg: GenerateConfig, *,
             max_seq: Optional[int] = None, cache_dtype=torch.bfloat16,
             enc_out=None, cross_caches=None, patch_embeds=None,
             budgets=None, quant: bool = False, device=None):
    """Batched generation, greedy or sampled (see the module docstring).
    Returns (tokens (B, max_new), lengths, iters), as the reference's
    ``generate``.

    An encoder-decoder takes ``enc_out`` and ``cross_caches``
    (:func:`~repro_torch.models.transformer.prefill_cross_caches`), both
    in the model dtype, into every step; the vision stub takes
    ``patch_embeds`` into the prefill, and its decode positions start
    after ``cfg.vision_patches`` of them.  ``budgets`` is an optional (B,)
    int vector of per-sequence ``max_new_tokens`` (each in [1,
    gcfg.max_new_tokens]): the done-mask retires a sequence at its own
    budget; ``lengths`` is clipped to it (post-done positions are
    eos-padded).  ``quant``: the int8 KV cache.

    The step counter ``t`` is a 0-d device tensor carried in the loop: the
    last token's column, the position ``S0 + P + t - 1`` and the sampling
    step are device tensors, as under the reference's jit, so the step
    itself reads nothing back; the loop reads the done flag once a step
    (:func:`generate_jit` replays a captured step instead)."""
    dev = T.check_device(params, device)
    prompt = to_device(prompt, dev)
    B, S0 = prompt.shape
    P = cfg.vision_patches or 0
    max_new = gcfg.max_new_tokens
    max_seq = max_seq or (S0 + P + max_new)

    last_logits, caches = prefill(cfg, params, prompt, max_seq=max_seq,
                                  cache_dtype=cache_dtype,
                                  patch_embeds=patch_embeds, enc_out=enc_out,
                                  cross_caches=cross_caches, quant=quant,
                                  device=dev)
    bud = _budget_vector(budgets, B, max_new, dev)
    rows = torch.arange(B, device=dev)

    def sample(logits, t):
        return sample_tokens(logits, gcfg.temperature, gcfg.seed, rows,
                             t.expand(B))

    first = sample(last_logits, torch.zeros((), dtype=torch.int32,
                                            device=dev))           # (B,)
    out0 = torch.zeros((B, max_new), dtype=torch.int32, device=dev)
    out0[:, 0] = first
    done0 = (first == gcfg.eos_id) | (bud <= 1)

    def step_fn(carry):
        caches, out, done, t = carry
        tok = out.gather(1, (t.long() - 1).expand(B, 1))
        logits, caches = T.decode_step(cfg, params, caches, tok,
                                       S0 + P + t - 1, enc_out=enc_out,
                                       cross_caches=cross_caches)
        nxt = sample(logits[:, 0], t)
        nxt = torch.where(done, torch.full_like(nxt, gcfg.eos_id), nxt)
        if max_new > 1:
            # cap == 1: the repeat/until still runs its one mandatory body
            # step, whose write (t=1) would land past the only column
            out.scatter_(1, t.long().expand(B, 1), nxt.to(out.dtype)[:, None])
        done = done | (nxt == gcfg.eos_id) | (t + 1 >= bud)
        return (caches, out, done, t + 1)

    loop = LoopOfStencilReduce(
        f=step_fn, mode="step", combine="all", identity=True,
        measure=lambda c: c[2],                   # per-sequence done flags
        cond=lambda r, s: r | (s >= max_new),
        state_init=lambda: torch.ones((), dtype=torch.int32, device=dev),
        state_update=lambda s, a, it: s + 1,
        max_iters=max_new, backend="torch", device=dev)

    res = loop.run((caches, out0, done0,
                    torch.ones((), dtype=torch.int32, device=dev)))
    _, out, _, _ = res.a
    return out, _lengths(out, bud, gcfg), res.iters


# ---------------------------------------------------------------------------
# Compiled generation — a captured decode step, replayed.
# ---------------------------------------------------------------------------

CHECK_EVERY = 8     # replays between two host reads of the loop condition


def _reset_caches(caches):
    """Every leaf back to :func:`~repro_torch.models.transformer.
    init_cache`'s value, in place: zeros, and -1 (empty) in a ring's
    ``pos``."""
    for c in caches:
        for key, leaf in c.items():
            leaf.fill_(-1 if key == "pos" else 0)


class _Compiled:
    """:func:`generate_jit`'s static state for one key: the caches, the
    carry (out, done, t), the budgets, copies of the read-only encoder
    output and cross caches, and the captured step over them."""

    def __init__(self, cfg, params, gcfg, dev, *, B, S0, max_seq,
                 cache_dtype, quant, enc_out, cross_caches):
        P = cfg.vision_patches or 0
        max_new, eos = gcfg.max_new_tokens, gcfg.eos_id
        i32 = dict(dtype=torch.int32, device=dev)
        self.params = params        # keeps the key's identity valid
        self.max_new = max_new
        self.caches = T.init_cache(cfg, B, max_seq, cache_dtype, quant,
                                   device=dev)
        self.out = torch.zeros((B, max_new), **i32)
        self.done = torch.zeros((B,), dtype=torch.bool, device=dev)
        self.t = torch.ones((), **i32)
        self.bud = torch.full((B,), max_new, **i32)
        self.rows = torch.arange(B, device=dev)
        self.enc = None if enc_out is None else torch.empty_like(enc_out)
        self.cross = None if cross_caches is None else [
            None if c is None else {k: torch.empty_like(v)
                                    for k, v in c.items()}
            for c in cross_caches]
        last = max(max_new - 1, 1)
        # the step closes over the buffers, not over self: no cycle keeps
        # a dropped state's caches and parameters alive
        caches, out, done, t, bud, rows = (self.caches, self.out, self.done,
                                           self.t, self.bud, self.rows)
        enc, cross = self.enc, self.cross

        def step():
            """One decode step gated on ``running``: past the stop it
            writes neither out, done nor t, and its own counter stays at
            the last real step's (so its cache write stays in range)."""
            run = (t == 1) | (~done.all() & (t < max_new))
            ti = t.clamp(max=last)
            tok = out.gather(1, (ti.long() - 1).expand(B, 1))
            logits, _ = T.decode_step(cfg, params, caches, tok,
                                      S0 + P + ti - 1, enc_out=enc,
                                      cross_caches=cross)
            nxt = sample_tokens(logits[:, 0], gcfg.temperature, gcfg.seed,
                                rows, ti.expand(B)).to(torch.int32)
            nxt = torch.where(done, torch.full_like(nxt, eos), nxt)
            if max_new > 1:
                col = ti.long().expand(B, 1)
                out.scatter_(1, col, torch.where(
                    run, nxt, out.gather(1, col)[:, 0])[:, None])
            done.copy_(torch.where(
                run, done | (nxt == eos) | (t + 1 >= bud), done))
            t.add_(run.to(t.dtype))

        self.graph = StepGraph(step, dev)

    def running(self):
        return ~self.done.all() & (self.t < self.max_new)


class GenerateJit:
    """The callable :func:`generate_jit` returns.  ``compiled`` maps each
    key (the parameters' identity, B, S0, ``max_seq``, ``cache_dtype``,
    ``quant``, the temperature and the encoder output's shape) to its
    static state; ``stats`` counts calls, decode steps, graph replays,
    captures and host reads of the loop condition."""

    def __init__(self, cfg: ArchConfig, gcfg: GenerateConfig, kw: dict):
        self.cfg, self.gcfg, self.kw = cfg, gcfg, kw
        self.compiled: dict = {}
        self.stats = {"calls": 0, "steps": 0, "replays": 0, "captures": 0,
                      "checks": 0}

    @torch.no_grad()
    def __call__(self, params, prompt, **call_kw):
        kw = {**self.kw, **call_kw}
        cfg, gcfg = self.cfg, self.gcfg
        dev = T.check_device(params, kw.get("device"))
        prompt = to_device(prompt, dev)
        B, S0 = prompt.shape
        P = cfg.vision_patches or 0
        max_new = gcfg.max_new_tokens
        max_seq = kw.get("max_seq") or (S0 + P + max_new)
        cache_dtype = kw.get("cache_dtype", torch.bfloat16)
        quant = kw.get("quant", False)
        enc_out, cross = kw.get("enc_out"), kw.get("cross_caches")
        key = (id(params), B, S0, max_seq, cache_dtype, quant,
               gcfg.temperature,
               None if enc_out is None else tuple(enc_out.shape),
               cross is None)
        st = self.compiled.get(key)
        if st is None:
            st = self.compiled[key] = _Compiled(
                cfg, params, gcfg, dev, B=B, S0=S0, max_seq=max_seq,
                cache_dtype=cache_dtype, quant=quant, enc_out=enc_out,
                cross_caches=cross)
        # the eager prefill, into the static buffers
        if st.enc is not None:
            st.enc.copy_(enc_out)
        for c, s in zip(cross or (), st.cross or ()):
            for k in s or ():
                s[k].copy_(c[k])
        _reset_caches(st.caches)
        last_logits = _prefill_into(cfg, params, st.caches, prompt,
                                    kw.get("patch_embeds"), st.enc, st.cross)
        st.bud.copy_(_budget_vector(kw.get("budgets"), B, max_new, dev))
        first = sample_tokens(last_logits, gcfg.temperature, gcfg.seed,
                              st.rows, torch.zeros_like(st.rows))
        st.out.zero_()
        st.out[:, 0] = first
        st.done.copy_((first == gcfg.eos_id) | (st.bud <= 1))
        st.t.fill_(1)
        # the decode loop: CHECK_EVERY replays, then one host read
        g = st.graph
        calls, (replays, captures) = g.calls, graph_counts(g)
        while True:
            for _ in range(CHECK_EVERY):
                g()
            self.stats["checks"] += 1
            if not bool(st.running()):
                break
        replays_now, captures_now = graph_counts(g)
        self.stats["calls"] += 1
        self.stats["steps"] += g.calls - calls
        self.stats["replays"] += replays_now - replays
        self.stats["captures"] += captures_now - captures
        out = st.out.clone()
        return out, _lengths(out, st.bud, gcfg), st.t - 1


def generate_jit(cfg: ArchConfig, gcfg: GenerateConfig, **kw) -> GenerateJit:
    """Compiled :func:`generate` (twin of the reference's ``generate_jit``):
    returns a callable ``fn(params, prompt, **kw)`` giving (tokens,
    lengths, iters) exactly as :func:`generate` does; keywords bound here
    and keywords of the call both go to it.

    The prefill runs eagerly, one forward of the prompt.  The decode loop
    replays one captured step (:class:`~repro_torch.serve.graphs.
    StepGraph`) over static buffers, gated on the device condition
    ``running = (t == 1) | (~all(done) & (t < max_new))``, so steps past the
    stop change no returned value; the host reads the condition once every
    ``CHECK_EVERY`` replays.  ``iters`` is the device counter, not the
    number of replays.  The graph is keyed as jit's cache is (B, S0,
    ``max_seq``, ``cache_dtype``, ``quant``, temperature, for one ``cfg``
    and parameters) and captured at the first call of a key; its static
    buffers (the caches among them) live as long as the callable.  The
    parameters are captured by address (see :mod:`~repro_torch.serve.
    graphs`).  On ``device="cpu"`` the same gated step runs eagerly."""
    return GenerateJit(cfg, gcfg, kw)


# ---------------------------------------------------------------------------
# Continuous batching — per-sequence KV-slot refill.
# ---------------------------------------------------------------------------


def request_budget(req, cap: int) -> int:
    """Resolve a request's per-sequence token budget against the engine
    cap: the one validation rule shared by the round path
    (:meth:`repro_torch.serve.batcher.Batcher.run_all`) and the continuous
    engine."""
    bud = getattr(req, "max_new_tokens", None)
    bud = cap if bud is None else bud
    if not 1 <= bud <= cap:
        raise ValueError(
            f"request budget {bud} outside [1, max_new_tokens={cap}] "
            "(the slot width)")
    return bud


@dataclasses.dataclass
class _RestoredRequest:
    """A request rebuilt from a :meth:`ContinuousEngine.snapshot` tree,
    duck-typed like :class:`repro_torch.serve.batcher.Request`.
    ``deadline`` is re-anchored to the resumed process's clock from the
    snapshot's stored remaining time."""
    rid: int
    prompt: np.ndarray
    max_new_tokens: Optional[int] = None
    deadline: Optional[float] = None


def _arch_has_ssm(cfg: ArchConfig) -> bool:
    """Whether the stack carries SSM layers: their sequential state updates
    have no pad mask, so a ragged (padded) prefill is attention-only."""
    return any(s.kind == "ssm" for s in T.layer_specs(cfg))


class ContinuousEngine:
    """Continuous-batching decode: persistent KV-cache slots with
    per-sequence refill (twin of :class:`repro.serve.engine.
    ContinuousEngine`).

    ``slots`` KV-cache lanes persist on the device.  Decode advances in
    bounded *segments* (:func:`~repro_torch.core.pattern.segmented_while`:
    control returns to the dispatcher as soon as any sequence newly
    finishes, or after ``segment`` steps).  A finished sequence's tokens
    are emitted at once, and its KV slot is handed to the next queued
    request mid-batch: the newcomer's prompt is prefilled into a fresh
    single-sequence cache and written over the slot (one whole-slot write a
    layer, which also evicts the previous occupant's keys) while the other
    sequences keep decoding at their own depths (per-sequence cache
    positions, RoPE and masks: :func:`~repro_torch.models.transformer.
    step_with_cache`).

    Prompts may be ragged: the engine binds one slot pool at
    ``max_prompt_len`` (given, or the longest prompt of the first run) and
    admits each request through a right-padded prefill under its
    prompt-length mask; pad keys never enter an attention window or a ring
    cache, the first token is read at the prompt's own last real row, and
    decode continues from each slot's own depth.  ``stats
    ["idle_slot_steps"]`` counts slot-steps burned on retired or
    done-masked slots; ``["attn_decode_kernel"]`` and
    ``["attn_decode_einsum"]`` count the decode steps' cached attention
    calls by route: one step's calls, recorded on its first run, times the
    steps of each segment (a replay runs no Python, and repeats its
    capture).

    The segment's body is one decode step over the bound buffers, written
    in place: a captured CUDA graph replayed once a body step on the card
    (:class:`~repro_torch.serve.graphs.StepGraph`, the twin of the
    reference's jitted segment), the same step run eagerly on the CPU.  A
    binding (and :meth:`restore`) drops the graph; it is captured at the
    first segment.  ``stats["segment_traces"]``, ``["chain_traces"]`` and
    ``["prefill_traces"]`` count the slot-pool bindings each entry point
    served (the synchronous and the chained segment, the synchronous and
    the chained admission: one each per binding, at its first call), which
    is where the reference's jit traces.  One binding serves the whole
    stream.

    The KV pool and the carry (out, done, t, budget, keys, plens) are the
    bound buffers, written in place by the step, the admissions and
    restores between segments; the chained dispatcher copies the rows each
    in-flight segment leaves for its drain.  Constraints
    as the reference's: per-request ``max_new_tokens`` is capped by
    ``gcfg.max_new_tokens`` (the slot width); absolute position
    embeddings, encoders and vision prefixes are refused; ragged
    admission needs an attention-only stack.  ``device=None`` is the
    parameters' device, which must be the card unless ``device="cpu"``.
    """

    def __init__(self, cfg: ArchConfig, params, gcfg: GenerateConfig, *,
                 slots: int = 8, cache_dtype=torch.bfloat16,
                 segment: int = 8, max_prompt_len: Optional[int] = None,
                 device=None):
        if cfg.abs_pos_embed or cfg.is_encoder_decoder or \
                cfg.vision_patches:
            raise ValueError(
                "continuous batching needs per-sequence positions; "
                "absolute position embeddings, encoder-decoder and "
                "vision-prefix models are round-based only")
        if segment < 1:
            raise ValueError(f"segment must be >= 1; got {segment}")
        self.cfg, self.params, self.gcfg = cfg, params, gcfg
        self.slots, self.cache_dtype = slots, cache_dtype
        self.segment = segment
        self.max_prompt_len = max_prompt_len
        self._device_arg = device
        self._bound = False
        self._served = set()           # entry points that served the pool
        self.stats = {"requests": 0, "segments": 0, "prefills": 0,
                      "emitted": 0, "segment_traces": 0,
                      "chain_traces": 0,
                      "prefill_traces": 0, "slot_steps": 0,
                      "idle_slot_steps": 0, "evicted": 0, "shed": 0,
                      "snapshots": 0, "replayed_items": 0,
                      "recovered_occupants": 0, "recovery_seconds": 0.0,
                      "graph_replays": 0, "graph_captures": 0,
                      "attn_decode_kernel": 0, "attn_decode_einsum": 0,
                      **obs.stats_keys(SERVE_SPANS,
                                       device=SERVE_DEVICE_SPANS,
                                       other="serve.other")}
        self._resume_state = None       # staged by restore()
        self._rt_capture = None         # live snapshot closure

    # -- static geometry (the first run binds the shapes) -----------------
    def _bind(self, prompt_len: int):
        self.device = T.check_device(self.params, self._device_arg)
        B, cap, dev = self.slots, self.gcfg.max_new_tokens, self.device
        self._S0 = prompt_len                   # slot (max) prompt width
        self._max_seq = prompt_len + cap
        self._caches = T.init_cache(self.cfg, B, self._max_seq,
                                    self.cache_dtype, device=dev)
        i32 = dict(dtype=torch.int32, device=dev)
        self._out = torch.zeros((B, cap), **i32)
        self._done = torch.ones((B,), dtype=torch.bool, device=dev)
        self._t = torch.ones((B,), **i32)       # tokens generated
        self._budget = torch.ones((B,), **i32)
        self._keys = torch.zeros((B, 2), dtype=torch.int64, device=dev)
        self._plen = torch.full((B,), prompt_len, **i32)
        self._step_key = torch.tensor([0, 1], dtype=torch.int64, device=dev)
        # through a weak reference, so that no cycle keeps a dropped
        # engine's pool alive until the next collection
        eng = weakref.proxy(self)
        self._step = self._step_runner(lambda: eng._decode_step())
        self._step_routes = None        # one step's attention calls by route
        self._bound = True

    def _step_runner(self, step):
        """The segment's body step: ``step`` captured and replayed on the
        card, eager on the CPU."""
        return StepGraph(step, self.device)

    def _serve_entry(self, name: str, *counters: str):
        """Count an entry point's first call on this binding (see the
        class docstring)."""
        if name not in self._served:
            self._served.add(name)
            for c in counters:
                self.stats[c] += 1

    def _sample(self, logits, keys):
        """One token a row from (B, V) logits; ``keys`` (B, 2) is each
        row's (admission index, draws so far)."""
        return sample_tokens(logits, self.gcfg.temperature, self.gcfg.seed,
                             keys[:, 0], keys[:, 1])

    # -- slot admission: hand a free slot to the next request --------------
    def _fresh_prefill(self, prompt, plen):
        """The right-padded single-sequence prefill of one admission under
        its prompt-length mask: returns (logits (1, S0, V), fresh caches)."""
        fresh = T.init_cache(self.cfg, 1, self._max_seq, self.cache_dtype,
                             device=self.device)
        return T.step_with_cache(self.cfg, self.params, fresh, prompt[None],
                                 0, prompt_len=plen.reshape(1))

    def _write_slot(self, caches, idx: int, fresh):
        """One whole-slot write a layer: every leaf of the slot ``idx``
        (batch axis 0) takes the single-sequence cache ``fresh``."""
        for c, f in zip(caches, fresh):
            for key, leaf in c.items():
                leaf[idx].copy_(f[key][0])

    def _admit_slot(self, carry, idx: int, prompt, plen, bud, adm: int):
        """Admit one request into slot ``idx``: prefill its right-padded
        prompt (``plen`` real tokens, a 0-d device tensor), write the slot,
        read the first token at row ``plen - 1`` (clamped, as
        ``dynamic_index_in_dim`` clamps), and re-arm the slot's carry row.
        ``adm`` is the admission index that keys the row's draws."""
        caches, out, done, t, budget, keys, plens = carry
        logits, fresh = self._fresh_prefill(prompt, plen)
        last = logits[0].index_select(
            0, (plen.to(torch.int64) - 1).clamp(0, self._S0 - 1).reshape(1))
        key = torch.tensor([[adm, 0]], dtype=torch.int64, device=self.device)
        first = self._sample(last, key)[0].to(torch.int32)
        self._write_slot(caches, idx, fresh)
        del logits, fresh
        out[idx] = 0
        out[idx, 0] = first
        done[idx] = (first == self.gcfg.eos_id) | (bud <= 1)
        t[idx] = 1
        budget[idx] = bud
        keys[idx] = key[0] + self._step_key
        plens[idx] = plen
        return carry

    # -- slot snapshot / restore (preemption recovery) ---------------------
    def _snap_slot(self, caches, idx: int) -> list:
        """One slot's cache state: each layer's leaves at row ``idx``, as
        CPU tensors of shape (1, ...)."""
        return [{key: leaf[idx:idx + 1].cpu() for key, leaf in c.items()}
                for c in caches]

    def _restore_slot(self, carry, idx: int, e: dict):
        """Re-seat one snapshotted in-flight decode into slot ``idx``
        (perhaps not the slot it held before the crash): the saved cache
        rows write through the same whole-slot path an admission uses, and
        the carry row re-arms with the saved values, the sampling keys
        included, so decoding continues mid-generation."""
        caches, out, done, t, budget, keys, plens = carry
        dev = self.device
        self._write_slot(caches, idx, [
            {key: torch.as_tensor(v).to(dev) for key, v in c.items()}
            for c in e["caches"]])
        out[idx] = torch.as_tensor(np.asarray(e["out"]),
                                   dtype=out.dtype).to(dev)
        done[idx] = bool(e["done"])
        t[idx] = int(e["t"])
        budget[idx] = int(e["budget"])
        keys[idx] = torch.as_tensor(np.asarray(e["key"]),
                                    dtype=keys.dtype).to(dev)
        plens[idx] = int(e["plen"])
        return carry

    def snapshot(self) -> dict:
        """The in-flight serve state as one logical tree: every occupied
        slot's KV-cache rows, output row, position / budget / sampling-key
        carry, its request (deadline stored as remaining seconds), the
        not-yet-admitted queue, and the admission-key cursor
        (``stats["prefills"]``).  Topology-free over ``slots``.  Only
        meaningful at a segment boundary (``on_segment``, or ``recovery=``
        to :meth:`run`)."""
        if self._rt_capture is None:
            raise ValueError(
                "snapshot() captures in-flight serve state; nothing has "
                "run yet — call run() (pass recovery= to persist "
                "snapshots automatically)")
        return self._rt_capture()

    def restore(self, state: dict) -> "ContinuousEngine":
        """Stage a :meth:`snapshot` tree; the next :meth:`run` resumes from
        it.  ``slots`` may differ from the snapshotting engine's; the
        generation cap and bound prompt width may not."""
        if not isinstance(state, dict) or state.get("kind") != "serve":
            raise ValueError("not a ContinuousEngine snapshot tree")
        if int(state.get("version", -1)) != 1:
            raise ValueError("unsupported ContinuousEngine snapshot "
                             f"version {state.get('version')!r}")
        if int(state["cap"]) != self.gcfg.max_new_tokens:
            raise ValueError(
                f"snapshot generation cap {state['cap']} != engine cap "
                f"{self.gcfg.max_new_tokens} (the out-buffer width is "
                "part of the slot geometry)")
        if self._bound and int(state["S0"]) != self._S0:
            raise ValueError(
                f"snapshot prompt width {state['S0']} != bound slot "
                f"width {self._S0}")
        if any("caches" not in e for e in state.get("occupants") or ()):
            raise ValueError(
                "snapshot occupants carry no per-layer 'caches' (a tree "
                "written by another package's engine)")
        if self._bound:
            self._step.reset()
        self._resume_state = state
        return self

    # -- one bounded decode segment ----------------------------------------
    def _decode_step(self):
        """One decode step of every slot over the bound buffers, in place.
        Slot b reads its last token at out[b, t_b - 1] and writes the cache
        at plen_b + t_b - 1; a done slot keeps its out, t and keys rows."""
        caches, out, done, t = self._caches, self._out, self._done, self._t
        keys, cap, eos = self._keys, self.gcfg.max_new_tokens, self.gcfg.eos_id
        live = ~done
        tok = out.gather(1, (t.long() - 1)[:, None])
        pos = (self._plen + t - 1)[:, None]               # (B, 1)
        before = dict(decode_route_calls) if self._step_routes is None \
            else None
        logits, _ = T.decode_step(self.cfg, self.params, caches, tok, pos)
        if before is not None:
            self._step_routes = {route: n - before[route]
                                 for route, n in decode_route_calls.items()}
        nxt = self._sample(logits[:, 0], keys).to(torch.int32)
        if self.gcfg.temperature > 0:
            keys.copy_(torch.where(live[:, None], keys + self._step_key,
                                   keys))
        nxt = torch.where(live, nxt, torch.full_like(nxt, eos))
        tw = t.clamp(max=cap - 1).long()[:, None]
        out.scatter_(1, tw, torch.where(
            live, nxt, out.gather(1, tw)[:, 0])[:, None])
        t_new = torch.where(live, t + 1, t)
        done.copy_(done | (live & ((nxt == eos) | (t_new >= self._budget))))
        t.copy_(t_new)

    def _segment_core(self, carry):
        """Advance every live slot up to ``segment`` decode steps, returning
        as soon as any sequence newly finishes (EOS or its own budget): one
        call of the bound step a body step, over the bound buffers that
        ``carry`` names.  Returns (carry, steps)."""
        def body(c):
            self._step()
            return c

        return segmented_while(body, carry, finished=lambda c: c[2].clone(),
                               segment=self.segment)

    # -- the dispatcher ------------------------------------------------------
    @torch.no_grad()
    @obs.collected("serve.other")
    def run(self, requests, emit, *, clock=None, recovery=None,
            resume: bool = False,
            on_segment: Optional[Callable] = None,
            chained: bool = False) -> int:
        """Serve ``requests`` (ragged prompts and per-request
        ``.max_new_tokens`` welcome) through the slots, calling
        ``emit(rid, tokens, status)`` the moment each finishes, in
        completion order.  Returns the number of emissions.

        Deadlines (``.deadline`` on ``clock``'s timeline; default
        ``time.monotonic``): a request already past it at admission is
        shed (``status="timed_out"``, no tokens, ``stats["shed"]``); an
        occupant whose deadline passes mid-decode is evicted after the
        current segment with its partial tokens (``stats["evicted"]``) and
        its slot refilled or retired.

        Recovery (``recovery=``, a :class:`repro_torch.resilience.
        RecoveryConfig`): every emission is journaled before ``emit``
        runs, and the in-flight state (:meth:`snapshot`) publishes every
        ``snapshot_every`` segments.  ``resume=True`` replays the journal
        (each ``rid`` emitted once), re-seats snapshotted decodes on a pool
        of any slot count, re-queues the queue ahead of new requests and
        re-anchors deadlines.  ``on_segment`` is called with the cumulative
        segment count at every boundary (``FaultPlan.preempt_hook``).

        ``chained=True``: segment t+1 is dispatched before segment t's
        done / token rows are read back; admissions land on the latest
        carry and lag one in-flight segment (counted in
        ``idle_slot_steps``).  Emission order, exactly-once and the tokens
        match the synchronous path.  The port's segment reads its done
        flags on the host each step, so the lag overlaps little yet.
        """
        from ..resilience.recovery import Journal, load_snapshot, \
            save_snapshot

        clock = time.monotonic if clock is None else clock
        t_resume0 = time.perf_counter()
        if self._resume_state is None and recovery is not None and resume:
            st = load_snapshot(recovery.snap_dir)
            if st is not None:
                self.restore(st)    # validates kind / version / cap / S0
        state = None
        if self._resume_state is not None:
            state, self._resume_state = self._resume_state, None

        cap = self.gcfg.max_new_tokens
        journal = None
        emitted_pre: set = set()
        n_emit = 0

        def deliver(rid, tokens, status, journal_rec=True):
            """WAL-ordered emission: journal (fsync'd) first, then the
            ``emit`` callback."""
            nonlocal n_emit
            with obs.span("serve.emit"):
                if journal is not None and journal_rec:
                    journal.append({"rid": rid,
                                    "tokens": [int(x) for x in tokens],
                                    "status": status})
                emit(rid, tokens, status)
            n_emit += 1

        if recovery is not None and resume:
            for rec in Journal.replay(recovery.journal_path):
                rid = rec["rid"]
                if rid in emitted_pre:
                    continue
                emitted_pre.add(rid)
                deliver(rid, np.asarray(rec["tokens"], np.int32),
                        rec.get("status", "ok"), journal_rec=False)
                self.stats["replayed_items"] += 1
        if recovery is not None:
            journal = Journal(recovery.journal_path, fsync=recovery.fsync)

        queue = list(requests)
        restore_q: list = []
        if state is not None:
            # the segment counter keeps snapshot numbering monotonic; the
            # prefill counter is the admission-key cursor
            self.stats["segments"] = int(state.get("segments", 0))
            self.stats["prefills"] = int(state.get("prefills", 0))
            restore_q = [dict(e) for e in state.get("occupants") or ()]
            now0 = clock()
            requeued = []
            for q in state.get("queue") or ():
                rem = q.get("deadline_remaining")
                requeued.append(_RestoredRequest(
                    rid=int(q["rid"]),
                    prompt=np.asarray(q["prompt"], np.int32),
                    max_new_tokens=q.get("max_new_tokens"),
                    deadline=(now0 + float(rem)) if rem is not None
                    else None))
            queue = requeued + queue    # pre-crash admissions first
        if not queue and not restore_q:
            if journal is not None:
                journal.close()
            if state is not None or resume:
                self.stats["recovery_seconds"] += (
                    time.perf_counter() - t_resume0)
            return n_emit
        lens = [len(r.prompt) for r in queue]
        if state is not None:
            bound = int(state["S0"])
            if self.max_prompt_len and self.max_prompt_len != bound:
                raise ValueError(
                    f"engine max_prompt_len={self.max_prompt_len} != "
                    f"snapshot prompt width {bound} (the restored cache "
                    "slices carry the snapshotting pool's width)")
        else:
            bound = (self._S0 if self._bound
                     else (self.max_prompt_len or max(lens, default=1)))
        for r, L in zip(queue, lens):
            if not 1 <= L <= bound:
                raise ValueError(
                    f"prompt length {L} outside [1, max_prompt_len="
                    f"{bound}] (the slot pool's bound prompt width; "
                    "build the engine with a larger max_prompt_len)")
            request_budget(r, cap)
        if any(L != bound for L in lens) and _arch_has_ssm(self.cfg):
            raise ValueError(
                "ragged prompts need an attention-only stack (an SSM "
                "layer's state update is sequential — a pad token would "
                "corrupt it); group requests by exact prompt length "
                "upstream, as Batcher.run_continuous does for SSM archs")
        if not self._bound:
            self._bind(bound)
        dev = self.device
        queue = queue[::-1]                     # pop() = FIFO order
        carry = (self._caches, self._out, self._done, self._t, self._budget,
                 self._keys, self._plen)
        occupants = [None] * self.slots
        prev_t = self._t.cpu().numpy().astype(np.int64)
        admit_entry = "chain_prefill" if chained else "prefill"

        def deadline_of(req):
            return getattr(req, "deadline", None)

        def pull():
            """Next admissible request: requests already past their
            deadline are shed here, and requests whose emission was
            journaled before a crash are dropped."""
            while queue:
                req = queue.pop()
                if req.rid in emitted_pre:
                    continue
                dl = deadline_of(req)
                if dl is not None and clock() >= dl:
                    deliver(req.rid, np.zeros((0,), np.int32), "timed_out")
                    self.stats["shed"] += 1
                    self.stats["requests"] += 1
                    continue
                return req
            return None

        def admit(slot, req):
            nonlocal carry
            self._serve_entry(admit_entry, "prefill_traces")
            bud = request_budget(req, cap)
            ptoks = np.asarray(req.prompt, np.int32)
            prompt = np.zeros((self._S0,), np.int32)    # right-padded
            prompt[:len(ptoks)] = ptoks
            i32 = dict(dtype=torch.int32, device=dev)
            args = (torch.as_tensor(prompt, device=dev),
                    torch.tensor(len(ptoks), **i32), torch.tensor(bud, **i32))
            with obs.span("serve.admit", device=dev):
                carry = self._admit_slot(carry, slot, *args,
                                         self.stats["prefills"])
            occupants[slot] = req
            prev_t[slot] = 1    # the prefilled first token is not a step
            self.stats["prefills"] += 1
            self.stats["requests"] += 1

        def fill(slot):
            """Seat the next unit of work into a free slot: snapshotted
            in-flight decodes first, then the queue.  False when nothing is
            left to seat."""
            nonlocal carry
            while restore_q:
                e = restore_q.pop(0)
                if e["rid"] in emitted_pre:
                    continue
                rem = e.get("deadline_remaining")
                req = _RestoredRequest(
                    rid=int(e["rid"]),
                    prompt=np.asarray(e["prompt"], np.int32),
                    max_new_tokens=e.get("max_new_tokens"),
                    deadline=(clock() + float(rem)) if rem is not None
                    else None)
                carry = self._restore_slot(carry, slot, e)
                occupants[slot] = req
                prev_t[slot] = int(e["t"])
                self.stats["recovered_occupants"] += 1
                return True
            req = pull()
            if req is None:
                return False
            admit(slot, req)
            return True

        def retire(slot):
            carry[2][slot] = True

        # the capture outlives this call on the engine: it reaches the
        # engine through a weak reference, so that no cycle keeps a dropped
        # engine's KV pool and weights alive until the next collection
        eng = weakref.proxy(self)

        def capture(complete=None):
            """The :meth:`snapshot` tree of the live run state."""
            caches, out, done, t, budget, keys, plens = carry
            out_h, done_h = out.cpu().numpy(), done.cpu().numpy()
            t_h = t.cpu().numpy().astype(np.int64)
            bud_h, keys_h = budget.cpu().numpy(), keys.cpu().numpy()
            plen_h = plens.cpu().numpy()
            now = clock()
            occ = []
            for s in range(eng.slots):
                req = occupants[s]
                if req is None:
                    continue
                dl = deadline_of(req)
                occ.append({
                    "rid": req.rid,
                    "prompt": np.asarray(req.prompt, np.int32),
                    "max_new_tokens": getattr(req, "max_new_tokens", None),
                    "deadline_remaining": (float(dl - now)
                                           if dl is not None else None),
                    "done": bool(done_h[s]), "out": out_h[s].copy(),
                    "t": int(t_h[s]), "budget": int(bud_h[s]),
                    "key": keys_h[s].copy(), "plen": int(plen_h[s]),
                    "caches": eng._snap_slot(caches, s)})
            # in-flight decodes a smaller resumed pool has not re-seated
            # yet survive verbatim
            occ.extend(restore_q)
            qs = []
            for req in reversed(queue):         # stored in FIFO order
                dl = deadline_of(req)
                qs.append({
                    "rid": req.rid,
                    "prompt": np.asarray(req.prompt, np.int32),
                    "max_new_tokens": getattr(req, "max_new_tokens", None),
                    "deadline_remaining": (float(dl - now)
                                           if dl is not None else None)})
            if complete is None:
                complete = not occ and not qs
            return {"kind": "serve", "version": 1,
                    "S0": int(eng._S0), "cap": int(cap),
                    "segments": int(eng.stats["segments"]),
                    "prefills": int(eng.stats["prefills"]),
                    "occupants": occ, "queue": qs,
                    "complete": bool(complete)}

        self._rt_capture = capture

        def persist(complete=None):
            if recovery is None:
                return
            save_snapshot(recovery.snap_dir, self.stats["segments"],
                          capture(complete), keep=recovery.keep)
            self.stats["snapshots"] += 1

        def account(steps, t_h, valid=None):
            """Idle-slot accounting: each body step advances every live
            slot one token; retired and done-masked slots burn the step."""
            nonlocal prev_t
            grown = t_h - prev_t
            useful = int(grown.sum() if valid is None
                         else grown[valid].sum())
            self.stats["slot_steps"] += steps * self.slots
            self.stats["idle_slot_steps"] += steps * self.slots - useful
            for route, n in (self._step_routes or {}).items():
                self.stats[f"attn_decode_{route}"] += steps * n
            prev_t = t_h.copy() if valid is None else \
                np.where(valid, t_h, prev_t)

        def finish(slot, req, out_h, t_h, done_h, now, on_fill):
            """Emit a finished or expired occupant and refill its slot."""
            if done_h[slot]:
                deliver(req.rid, out_h[slot, :int(t_h[slot])].copy(), "ok")
                self.stats["emitted"] += 1
                occupants[slot] = None
                on_fill(slot, fill(slot))
                return
            dl = deadline_of(req)
            if dl is not None and now >= dl:
                # deadline eviction: the partial output emits now and the
                # slot is refilled through the ordinary admission, or
                # retired in place
                deliver(req.rid, out_h[slot, :int(t_h[slot])].copy(),
                        "timed_out")
                self.stats["evicted"] += 1
                occupants[slot] = None
                if not fill(slot):
                    retire(slot)
                else:
                    on_fill(slot, True)

        def run_sync():
            nonlocal carry
            while any(o is not None for o in occupants):
                self._serve_entry("segment", "segment_traces")
                with obs.span("serve.segment", device=dev):
                    carry, steps = self._segment_core(carry)
                self.stats["segments"] += 1
                if on_segment is not None:
                    # before emission: the harshest preemption window
                    on_segment(self.stats["segments"])
                _, out, done, t = carry[:4]
                with obs.span("serve.drain"):
                    done_h, out_h = done.cpu().numpy(), out.cpu().numpy()
                    t_h = t.cpu().numpy().astype(np.int64)
                obs.poll()
                account(steps, t_h)
                now = clock()
                for slot in range(self.slots):
                    req = occupants[slot]
                    if req is not None:
                        finish(slot, req, out_h, t_h, done_h, now,
                               lambda s, seated: None)
                if recovery is not None and \
                        self.stats["segments"] % recovery.snapshot_every \
                        == 0:
                    persist()

        def run_chained():
            """Segment t+1 is dispatched before segment t's rows are read.
            An occupant seated during the drain of segment t was not in
            segment t+1's flight, so each capture carries its dispatch
            ordinal and the drain skips slots seated at or after it."""
            nonlocal carry
            inflight: deque = deque()   # (ordinal, done, t, out, steps)
            seated_at = np.zeros((self.slots,), np.int64)
            ndisp = 0

            def dispatch():
                nonlocal carry, ndisp
                self._serve_entry("chain_segment", "segment_traces",
                                  "chain_traces")
                with obs.span("serve.segment", device=dev):
                    carry, steps = self._segment_core(carry)
                ndisp += 1
                self.stats["segments"] += 1
                if on_segment is not None:
                    on_segment(self.stats["segments"])
                # the drain reads this segment's rows after the next
                # segment has written the buffers: keep copies
                _, out, done, t = carry[:4]
                inflight.append((ndisp, done.clone(), t.clone(), out.clone(),
                                 steps))

            def seated(slot, ok):
                if ok:
                    seated_at[slot] = ndisp

            def drain_one():
                d, done_d, t_d, out_d, steps = inflight.popleft()
                with obs.span("serve.drain"):
                    done_h, out_h = done_d.cpu().numpy(), out_d.cpu().numpy()
                    t_h = t_d.cpu().numpy().astype(np.int64)
                obs.poll()
                valid = seated_at < d
                account(steps, t_h, valid)
                now = clock()
                for slot in range(self.slots):
                    req = occupants[slot]
                    if req is not None and valid[slot]:
                        finish(slot, req, out_h, t_h, done_h, now, seated)

            while True:
                work = any(o is not None for o in occupants)
                if not work and not inflight:
                    break
                if work:
                    dispatch()
                # lag-1 drain: with a fresh dispatch in flight, consume
                # only the previous segment; at the tail, flush
                if len(inflight) > (1 if work else 0):
                    drain_one()
                if work and recovery is not None and \
                        self.stats["segments"] % recovery.snapshot_every \
                        == 0:
                    # snapshot boundary: one explicit pipeline drain
                    while inflight:
                        drain_one()
                    persist()

        try:
            for slot in range(self.slots):
                if not fill(slot):
                    break
            persist(complete=False)   # recoverable before the first segment
            if state is not None or resume:
                self.stats["recovery_seconds"] += (
                    time.perf_counter() - t_resume0)
            run_chained() if chained else run_sync()
            persist(complete=True)
        finally:
            # the locals always name the live tensors, so a raising emit
            # callback leaves the engine usable
            (self._caches, self._out, self._done, self._t, self._budget,
             self._keys, self._plen) = carry
            (self.stats["graph_replays"],
             self.stats["graph_captures"]) = graph_counts(self._step)
            if journal is not None:
                journal.close()
        return n_emit
