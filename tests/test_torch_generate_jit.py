"""The port's compiled decode (``generate_jit``) against the JAX package's
on the CPU.

Reduced configs of every serving family: gemma2-9b (local window 8 <
max_seq: ring caches), deepseek-moe-16b, mamba2-130m, jamba (depth 8),
whisper-base (encoder output and read-only cross caches) and
phi-3-vision-4.2b (4 patches before the text), float32, widths 64.
Weights come from the reference's ``init_params`` through
``interop.params_from_reference``; prompts, frames and patches are drawn
with numpy from a seed.  The port's ``generate_jit`` on ``device="cpu"``
runs its gated decode step eagerly (the plain version of the captured
graph), with the host reading the loop condition every ``CHECK_EVERY``
steps; the reference's is ``jax.jit`` on the CPU.  Tolerances: tokens,
lengths and iters exact; the device-position ``generate`` bit-equal
(``torch.equal``) to a host-int loop of the same steps.
"""
import dataclasses
import functools
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced
from repro.models import transformer as JT
from repro.serve.engine import GenerateConfig as JGenerateConfig
from repro.serve.engine import generate_jit as jax_generate_jit
from repro_torch import interop
from repro_torch.configs import get_reduced as port_reduced
from repro_torch.models import transformer as TT
from repro_torch.serve import (CHECK_EVERY, ContinuousEngine, GenerateConfig,
                               Request, StepGraph, generate, generate_jit)
from repro_torch.serve.engine import sample_tokens

ROWS = 160         # whisper's position table
B = 3


@functools.lru_cache(maxsize=None)
def family(arch):
    """(cfg, pcfg, reference params, port model, reference extras, port
    extras): the extras are the keywords a generate call of the family
    takes (encoder output and cross caches, or patch embeddings)."""
    cfg, pcfg = get_reduced(arch), port_reduced(arch)
    kw = dict(max_position=ROWS) if cfg.abs_pos_embed else {}
    params = JT.init_params(cfg, jax.random.PRNGKey(0), **kw)
    model = interop.params_from_reference(
        pcfg, jax.tree.map(np.asarray, params), device="cpu")
    jx, px = {}, {}
    if cfg.is_encoder_decoder:
        frames = np.random.default_rng(1).normal(
            size=(B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
        enc = JT.encode(cfg, params, jnp.asarray(frames))
        cross = JT.prefill_cross_caches(cfg, params, enc)
        jx = dict(enc_out=enc, cross_caches=cross)
        px = dict(enc_out=torch.as_tensor(np.array(enc)),
                  cross_caches=interop.cross_caches_from_reference(
                      pcfg, jax.tree.map(np.asarray, cross), device="cpu"))
    if cfg.vision_patches:
        patches = np.random.default_rng(2).normal(
            size=(B, cfg.vision_patches, cfg.vision_embed_dim)
        ).astype(np.float32)
        jx = dict(patch_embeds=jnp.asarray(patches))
        px = dict(patch_embeds=torch.as_tensor(patches))
    return cfg, pcfg, params, model, jx, px


def prompt_of(cfg, S0=6, seed=0):
    return np.random.default_rng(seed).integers(2, cfg.vocab_size, (B, S0))


def both(arch, prompt, max_new, *, eos=1, budgets=None, **kw):
    """(reference, port) (tokens, lengths, iters) of ``generate_jit``."""
    cfg, pcfg, params, model, jx, px = family(arch)
    want = jax_generate_jit(cfg, JGenerateConfig(
        max_new_tokens=max_new, eos_id=eos), cache_dtype=jnp.float32, **kw)(
        params, jnp.asarray(prompt), budgets=None if budgets is None
        else jnp.asarray(budgets, jnp.int32), **jx)
    run = generate_jit(pcfg, GenerateConfig(max_new_tokens=max_new,
                                            eos_id=eos),
                       cache_dtype=torch.float32, device="cpu", **kw)
    got = run(model, prompt, budgets=budgets, **px)
    return want, got, run


def assert_equal(want, got):
    (wt, wl, wi), (gt, gl, gi) = want, got
    assert gt.dtype == torch.int32 and gl.dtype == torch.int32
    np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    assert int(gi) == int(wi)


FAMILIES = ["gemma2-9b", "deepseek-moe-16b", "mamba2-130m",
            "jamba-v0.1-52b", "whisper-base", "phi-3-vision-4.2b"]


@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("max_new,budgets", [
    (12, None), (10, [10, 3, 6]), (1, None)],
    ids=["max_new_12", "budgets", "max_new_1"])
def test_generate_jit_matches_the_reference(arch, max_new, budgets):
    """Every family, the whole budget, per-sequence budgets and a budget
    of one token (the reference's write-skipping special case)."""
    want, got, run = both(arch, prompt_of(family(arch)[0]), max_new,
                          budgets=budgets)
    assert_equal(want, got)
    assert run.stats["calls"] == 1
    assert run.stats["steps"] % CHECK_EVERY == 0
    assert run.stats["checks"] == run.stats["steps"] // CHECK_EVERY


def test_gemma2_reduced_serves_through_ring_caches():
    """The dense case is the ring-cache case: the local window is below
    max_seq, so half the layers hold a W-slot ring."""
    cfg = family("gemma2-9b")[1]
    caches = TT.init_cache(cfg, B, 6 + 12, torch.float32, device="cpu")
    windows = [s.window for s in TT.layer_specs(cfg)]
    assert ["pos" in c for c in caches] == [0 < w < 18 for w in windows]
    assert any("pos" in c for c in caches)


def planted_eos(arch, max_new):
    """An EOS id on which the whole batch stops inside a CHECK_EVERY
    interval: row 0's first occurrence of a token at a column that is no
    multiple of CHECK_EVERY; the other rows retire at budget 2."""
    cfg, pcfg, _, model, _, px = family(arch)
    out, _, _ = generate(pcfg, model, prompt_of(cfg, seed=3),
                         GenerateConfig(max_new_tokens=max_new, eos_id=-1),
                         cache_dtype=torch.float32, device="cpu", **px)
    row = out[0].tolist()
    for c in range(2, max_new - 1):
        if c % CHECK_EVERY and row[c] not in row[:c]:
            return row[c], c
    pytest.fail(f"no planted EOS column in {row}")


@pytest.mark.parametrize("arch", ["gemma2-9b", "mamba2-130m",
                                  "phi-3-vision-4.2b"])
def test_an_eos_stops_the_loop_inside_a_check_interval(arch):
    """The loop stops at iters = c, between two host reads: the replays
    past it are no-ops on every returned value."""
    max_new = 20
    eos, col = planted_eos(arch, max_new)
    want, got, run = both(arch, prompt_of(family(arch)[0], seed=3), max_new,
                          eos=eos, budgets=[max_new, 2, 2])
    assert_equal(want, got)
    assert int(got[2]) == col and col % CHECK_EVERY
    assert int(got[1][0]) == col + 1
    assert run.stats["steps"] > col          # the overshoot ran


@pytest.mark.parametrize("arch", ["gemma2-9b", "mamba2-130m",
                                  "whisper-base"])
def test_a_second_call_reuses_the_state_and_resets_it(arch):
    """One key, two calls with other prompts and budgets: the static
    caches (ring positions, SSM state) are reset by each prefill, so each
    call equals the reference's; another batch size is another key."""
    cfg = family(arch)[0]
    run = None
    for seed, budgets in ((4, None), (5, [2, 7, 4])):
        want, got, run_k = both(arch, prompt_of(cfg, seed=seed), 7,
                                budgets=budgets)
        assert_equal(want, got)
        if run is None:
            run = run_k
            continue
        _, pcfg, _, model, _, px = family(arch)
        again = run(model, prompt_of(cfg, seed=seed), budgets=budgets, **px)
        assert_equal(want, again)
        assert len(run.compiled) == 1 and run.stats["calls"] == 2
    _, pcfg, _, model, _, px = family(arch)
    if not cfg.is_encoder_decoder:
        run(model, prompt_of(cfg)[:2], **px)
        assert len(run.compiled) == 2


@pytest.mark.parametrize("arch", ["gemma2-9b", "deepseek-moe-16b",
                                  "whisper-base"])
@pytest.mark.parametrize("max_new", [9, 1])
def test_sampled_generate_jit_equals_sampled_generate(arch, max_new):
    """Sampled decode: ``generate_jit`` draws each step from the device
    step counter, so it equals the eager ``generate`` and repeats."""
    cfg, pcfg, _, model, _, px = family(arch)
    g = GenerateConfig(max_new_tokens=max_new, temperature=0.8, seed=11)
    prompt = prompt_of(cfg, seed=8)
    want = generate(pcfg, model, prompt, g, cache_dtype=torch.float32,
                    device="cpu", **px)
    run = generate_jit(pcfg, g, cache_dtype=torch.float32, device="cpu")
    for _ in range(2):
        got = run(model, prompt, **px)
        for w, x in zip(want, got):
            assert torch.equal(w, x)


def test_the_int8_cache_generates_as_the_eager_loop():
    """``quant=True``: the compiled loop on the int8 KV cache equals the
    eager one (the reference's ``generate`` has no int8 option)."""
    cfg, pcfg, _, model, _, _ = family("gemma2-9b")
    prompt = prompt_of(cfg, seed=9)
    g = GenerateConfig(max_new_tokens=11)
    want = generate(pcfg, model, prompt, g, cache_dtype=torch.float32,
                    quant=True, device="cpu")
    got = generate_jit(pcfg, g, cache_dtype=torch.float32, quant=True,
                       device="cpu")(model, prompt)
    for w, x in zip(want, got):
        assert torch.equal(w, x)


# ---------------------------------------------------------------------------
# device positions: bit-equal to the host-int loop they replace
# ---------------------------------------------------------------------------

@torch.no_grad()
def host_int_generate(cfg, model, prompt, gcfg, **kw):
    """The loop as it ran with a host-int step counter: the last token
    sliced at ``t - 1``, the position ``S0 + P + t - 1`` and the sampling
    step as host ints, one done read a step."""
    prompt = torch.as_tensor(prompt)
    Bp, S0 = prompt.shape
    P, max_new = cfg.vision_patches or 0, gcfg.max_new_tokens
    enc, cross = kw.get("enc_out"), kw.get("cross_caches")
    caches = TT.init_cache(cfg, Bp, S0 + P + max_new, torch.float32,
                           kw.get("quant", False), device="cpu")
    logits, _ = TT.step_with_cache(cfg, model, caches, prompt, 0,
                                   patch_embeds=kw.get("patch_embeds"),
                                   enc_out=enc, cross_caches=cross)
    rows = torch.arange(Bp)

    def sample(lg, t):
        return sample_tokens(lg, gcfg.temperature, gcfg.seed, rows,
                             torch.full_like(rows, t))
    first = sample(logits[:, -1], 0)
    out = torch.zeros((Bp, max_new), dtype=torch.int32)
    out[:, 0] = first
    done = first == gcfg.eos_id
    t, steps, per_step = 1, 0, []
    while True:
        lg, caches = TT.decode_step(cfg, model, caches, out[:, t - 1:t],
                                    S0 + P + t - 1, enc_out=enc,
                                    cross_caches=cross)
        per_step.append(lg)
        nxt = sample(lg[:, 0], t)
        nxt = torch.where(done, torch.full_like(nxt, gcfg.eos_id), nxt)
        if max_new > 1:
            out[:, t] = nxt.to(out.dtype)
        done = done | (nxt == gcfg.eos_id) | (t + 1 >= max_new)
        t, steps = t + 1, steps + 1
        if bool(done.all()) or t >= max_new or steps >= max_new:
            break
    return out, steps, per_step, caches


@pytest.mark.parametrize("arch,temperature,quant", [
    ("gemma2-9b", 0.0, False), ("gemma2-9b", 0.9, False),
    ("gemma2-9b", 0.0, True), ("whisper-base", 0.0, False),
    ("phi-3-vision-4.2b", 0.7, False), ("jamba-v0.1-52b", 0.0, False)])
def test_device_positions_are_bit_equal_to_host_ints(arch, temperature,
                                                     quant):
    """``generate`` with its 0-d device counter gives the tokens and iters
    of the host-int loop, and ``decode_step`` at a 0-d tensor position
    gives that loop's logits and caches bit for bit (whisper's absolute
    position rows, the vision offset, rings, the int8 cache)."""
    cfg, pcfg, _, model, _, px = family(arch)
    g = GenerateConfig(max_new_tokens=9, temperature=temperature, seed=5)
    prompt = prompt_of(cfg, seed=6)
    out, steps, per_step, caches = host_int_generate(pcfg, model, prompt,
                                                     g, quant=quant, **px)
    got, _, iters = generate(pcfg, model, prompt, g,
                             cache_dtype=torch.float32, quant=quant,
                             device="cpu", **px)
    assert torch.equal(got, out) and int(iters) == steps
    # the same steps at 0-d tensor positions
    S0, P = prompt.shape[1], pcfg.vision_patches or 0
    tc = TT.init_cache(pcfg, B, S0 + P + 9, torch.float32, quant,
                       device="cpu")
    with torch.no_grad():
        TT.step_with_cache(pcfg, model, tc, torch.as_tensor(prompt), 0,
                           patch_embeds=px.get("patch_embeds"),
                           enc_out=px.get("enc_out"),
                           cross_caches=px.get("cross_caches"))
        for t, want in enumerate(per_step, start=1):
            lg, _ = TT.decode_step(
                pcfg, model, tc, out[:, t - 1:t],
                torch.tensor(S0 + P + t - 1, dtype=torch.int32),
                enc_out=px.get("enc_out"),
                cross_caches=px.get("cross_caches"))
            assert torch.equal(lg, want), t
    for a, b in zip(tc, caches):
        for key in a:
            assert torch.equal(a[key], b[key]), key


# ---------------------------------------------------------------------------
# the captured step's plain version and the continuous engine's body
# ---------------------------------------------------------------------------

def test_a_step_graph_runs_its_step_eagerly_on_the_cpu():
    x = torch.zeros(3)
    g = StepGraph(lambda: x.add_(1), "cpu")
    for _ in range(5):
        g()
    assert x.tolist() == [5.0] * 3
    assert (g.calls, g.replays, g.captures, g.graph) == (5, 0, 0, None)


def test_the_continuous_segment_steps_the_bound_buffers_in_place():
    """The engine's body step writes the bound carry in place (the graph
    reads and writes those addresses): every step of every segment goes
    through the one step object, and the chained run's captures are
    copies (its emissions equal the synchronous run's)."""
    cfg, pcfg, _, model, _, _ = family("gemma2-9b")
    rng = np.random.default_rng(12)
    reqs = [Request(rid=i, prompt=np.asarray(rng.integers(
        2, cfg.vocab_size, L), np.int32), max_new_tokens=b)
        for i, (L, b) in enumerate(zip([3, 12, 5, 9], [2, 7, 3, 6]))]
    runs = {}
    for chained in (False, True):
        eng = ContinuousEngine(pcfg, model, GenerateConfig(max_new_tokens=7),
                               slots=2, segment=3, cache_dtype=torch.float32,
                               device="cpu")
        seq = []
        eng.run(list(reqs), lambda r, t, s: seq.append((r, t.tolist(), s)),
                chained=chained)
        ptrs = [eng._out.data_ptr(), eng._done.data_ptr(),
                eng._t.data_ptr(), eng._keys.data_ptr()]
        eng.run([dataclasses.replace(reqs[0], rid=9)], lambda *a: None,
                chained=chained)
        assert ptrs == [eng._out.data_ptr(), eng._done.data_ptr(),
                        eng._t.data_ptr(), eng._keys.data_ptr()]
        assert eng._step.calls * eng.slots == eng.stats["slot_steps"]
        runs[chained] = seq
    assert sorted(runs[True]) == sorted(runs[False])
    for rid, toks, _ in runs[False]:
        solo, L, _ = generate(pcfg, model, reqs[rid].prompt[None],
                              GenerateConfig(max_new_tokens=reqs[rid]
                                             .max_new_tokens),
                              cache_dtype=torch.float32, device="cpu")
        assert toks == solo[0, :int(L[0])].tolist()


def test_a_dropped_generate_jit_frees_its_state():
    """The captured step closes over the static buffers, not over its
    state: dropping the callable frees the caches (and so the parameters
    it reaches) without waiting for a garbage collection."""
    cfg, pcfg, _, model, _, _ = family("gemma2-9b")
    run = generate_jit(pcfg, GenerateConfig(max_new_tokens=4),
                       cache_dtype=torch.float32, device="cpu")
    run(model, prompt_of(cfg))
    pool = weakref.ref(next(iter(run.compiled.values())).caches[0]["k"])
    gc.disable()
    try:
        del run
        assert pool() is None
    finally:
        gc.enable()
