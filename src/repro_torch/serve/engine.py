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
caches stay on the device and are written in place.

:class:`ContinuousEngine` is continuous batching: persistent KV-cache slots,
ragged admission and per-sequence refill, bounded decode segments on the
port's :func:`~repro_torch.core.pattern.segmented_while`, deadlines,
snapshot/resume and the chained dispatcher.

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

from ..configs.base import ArchConfig
from ..core.pattern import LoopOfStencilReduce, segmented_while
from ..device import to_device
from ..models import transformer as T


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
    eos-padded)."""
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
    rows = torch.arange(B, device=dev)

    def sample(logits, t):
        return sample_tokens(logits, gcfg.temperature, gcfg.seed, rows,
                             torch.full_like(rows, t))

    first = sample(last_logits, 0)                            # (B,)
    out0 = torch.zeros((B, max_new), dtype=torch.int32, device=dev)
    out0[:, 0] = first
    done0 = (first == gcfg.eos_id) | (bud <= 1)

    def step_fn(carry):
        caches, out, done, t = carry
        tok = out[:, t - 1:t]
        logits, caches = T.decode_step(cfg, params, caches, tok,
                                       S0 + P + t - 1, enc_out=enc_out,
                                       cross_caches=cross_caches)
        nxt = sample(logits[:, 0], t)
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


def _row(x: torch.Tensor, i: int, value) -> torch.Tensor:
    """``x`` with row ``i`` set to ``value``, as a new tensor: the carry is
    never written in place, so a chained drain's captures keep the values
    of the segment that produced them."""
    x = x.clone()
    x[i] = value
    return x


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
    done-masked slots.

    Nothing is compiled in eager torch: ``stats["segment_traces"]``,
    ``["chain_traces"]`` and ``["prefill_traces"]`` count the slot-pool
    bindings each entry point served (the synchronous and the chained
    segment, the synchronous and the chained admission: one each per
    binding, at its first call), which is where the reference's jit
    traces.  One binding serves the whole stream.

    The carry (out, done, t, budget, keys, plens) is small and replaced,
    never written in place; the KV pool is written in place.  Constraints
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
                      "recovered_occupants": 0, "recovery_seconds": 0.0}
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
        self._bound = True

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
        row = torch.zeros_like(out[0])
        row[0] = first
        out = _row(out, idx, row)
        done = _row(done, idx, (first == self.gcfg.eos_id) | (bud <= 1))
        t = _row(t, idx, 1)
        budget = _row(budget, idx, bud)
        keys = _row(keys, idx, key[0] + torch.tensor(
            [0, 1], device=self.device))
        plens = _row(plens, idx, plen)
        return caches, out, done, t, budget, keys, plens

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
        out = _row(out, idx, torch.as_tensor(
            np.asarray(e["out"]), dtype=out.dtype).to(dev))
        done = _row(done, idx, bool(e["done"]))
        t = _row(t, idx, int(e["t"]))
        budget = _row(budget, idx, int(e["budget"]))
        keys = _row(keys, idx, torch.as_tensor(
            np.asarray(e["key"]), dtype=keys.dtype).to(dev))
        plens = _row(plens, idx, int(e["plen"]))
        return caches, out, done, t, budget, keys, plens

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
        self._resume_state = state
        return self

    # -- one bounded decode segment ----------------------------------------
    def _segment_core(self, carry):
        """Advance every live slot up to ``segment`` decode steps, returning
        as soon as any sequence newly finishes (EOS or its own budget).
        Slot b reads its last token at out[b, t_b - 1] and writes the cache
        at plen_b + t_b - 1.  Returns (carry, steps)."""
        caches, out, done, t, budget, keys, plens = carry
        cap, eos = self.gcfg.max_new_tokens, self.gcfg.eos_id
        step_key = torch.tensor([0, 1], device=self.device)

        def body(c):
            caches, out, done, t, keys = c
            live = ~done
            tok = out.gather(1, (t.long() - 1)[:, None])
            pos = (plens + t - 1)[:, None]                # (B, 1)
            logits, caches = T.decode_step(self.cfg, self.params, caches,
                                           tok, pos)
            nxt = self._sample(logits[:, 0], keys).to(torch.int32)
            if self.gcfg.temperature > 0:
                keys = torch.where(live[:, None], keys + step_key, keys)
            nxt = torch.where(live, nxt, torch.full_like(nxt, eos))
            tw = t.clamp(max=cap - 1).long()[:, None]
            out = out.scatter(1, tw, torch.where(
                live, nxt, out.gather(1, tw)[:, 0])[:, None])
            t = torch.where(live, t + 1, t)
            done = done | (live & ((nxt == eos) | (t >= budget)))
            return caches, out, done, t, keys

        (caches, out, done, t, keys), steps = segmented_while(
            body, (caches, out, done, t, keys), finished=lambda c: c[2],
            segment=self.segment)
        return (caches, out, done, t, budget, keys, plens), steps

    # -- the dispatcher ------------------------------------------------------
    @torch.no_grad()
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
        flags on the host each step, so the lag overlaps little yet
        (ROADMAP.md).
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
            carry = self._admit_slot(
                carry, slot, torch.as_tensor(prompt, device=dev),
                torch.tensor(len(ptoks), **i32), torch.tensor(bud, **i32),
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
            nonlocal carry
            carry = carry[:2] + (_row(carry[2], slot, True),) + carry[3:]

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
                carry, steps = self._segment_core(carry)
                self.stats["segments"] += 1
                if on_segment is not None:
                    # before emission: the harshest preemption window
                    on_segment(self.stats["segments"])
                _, out, done, t = carry[:4]
                done_h, out_h = done.cpu().numpy(), out.cpu().numpy()
                t_h = t.cpu().numpy().astype(np.int64)
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
                carry, steps = self._segment_core(carry)
                ndisp += 1
                self.stats["segments"] += 1
                if on_segment is not None:
                    on_segment(self.stats["segments"])
                _, out, done, t = carry[:4]
                inflight.append((ndisp, done, t, out, steps))

            def seated(slot, ok):
                if ok:
                    seated_at[slot] = ndisp

            def drain_one():
                d, done_d, t_d, out_d, steps = inflight.popleft()
                done_h, out_h = done_d.cpu().numpy(), out_d.cpu().numpy()
                t_h = t_d.cpu().numpy().astype(np.int64)
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
            if journal is not None:
                journal.close()
        return n_emit
