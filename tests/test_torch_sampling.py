"""Sampled decode in the port (``temperature > 0``).

``jax.random`` keys cannot be reproduced in torch, so sampling is held to
the port's own contract rather than to the reference's tokens: every draw
is a pure function of (``gcfg.seed``, a stream index, a step) — the row in
``generate``, the admission index in ``ContinuousEngine`` — so runs repeat
exactly, a request's tokens do not depend on the slot count or on which
slot it lands in, and a killed and resumed run samples what an
uninterrupted one does.  Reduced qwen3-1.7b and gemma2-9b, float32 caches.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_reduced
from repro.models import transformer as JT
from repro_torch import interop
from repro_torch.configs import get_reduced as port_reduced
from repro_torch.resilience import FaultPlan, PreemptionError, RecoveryConfig
from repro_torch.serve import (Batcher, ContinuousEngine, GenerateConfig,
                               Request, generate)
from repro_torch.serve.engine import sample_tokens, uniform_bits


def test_uniform_bits_are_a_pure_function_of_their_keys():
    stream = torch.tensor([0, 1, 2, 1])
    step = torch.tensor([0, 0, 5, 0])
    u = uniform_bits(7, stream, step, 1000)
    assert u.dtype == torch.float32 and u.shape == (4, 1000)
    assert float(u.min()) > 0.0 and float(u.max()) < 1.0
    torch.testing.assert_close(u[1], u[3], rtol=0, atol=0)   # same keys
    alone = uniform_bits(7, stream[2:3], step[2:3], 1000)
    torch.testing.assert_close(alone[0], u[2], rtol=0, atol=0)
    assert not torch.equal(u[0], u[1])                       # stream
    assert not torch.equal(uniform_bits(8, stream, step, 1000), u)  # seed
    big = uniform_bits(0, torch.arange(8), torch.zeros(8, dtype=int), 4096)
    assert abs(float(big.mean()) - 0.5) < 0.01
    assert abs(float(big.var()) - 1 / 12) < 0.005


def test_sample_tokens_follows_the_softmax():
    """Greedy at temperature 0; at temperature 1 the Gumbel-max draw's
    frequencies over 4000 streams follow softmax(logits) (three-sigma
    binomial bounds)."""
    logits = torch.tensor([[2.0, 1.0, 0.0, -1.0, 0.5]])
    assert int(sample_tokens(logits, 0.0, 0, torch.zeros(1, dtype=int),
                             torch.zeros(1, dtype=int))[0]) == 0
    n = 4000
    draws = sample_tokens(logits.expand(n, 5), 1.0, 3, torch.arange(n),
                          torch.zeros(n, dtype=int))
    freq = torch.bincount(draws, minlength=5).double() / n
    p = torch.softmax(logits[0].double(), dim=0)
    assert ((freq - p).abs() <= 3 * (p * (1 - p) / n).sqrt()).all(), \
        (freq, p)
    cold = sample_tokens(logits.expand(n, 5), 0.05, 3, torch.arange(n),
                         torch.zeros(n, dtype=int))
    assert (cold == 0).all()


@pytest.fixture(scope="module", params=["qwen3-1.7b", "gemma2-9b"])
def served(request):
    arch = request.param
    params = JT.init_params(get_reduced(arch), jax.random.PRNGKey(0))
    return port_reduced(arch), interop.params_from_reference(
        port_reduced(arch), jax.tree.map(np.asarray, params), device="cpu")


def requests(cfg, n=7, seed=0):
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=np.asarray(
        rng.integers(2, cfg.vocab_size, 3 + (i * 5) % 10), np.int32),
        max_new_tokens=4 + 2 * (i % 4)) for i in range(n)]


def serve(cfg, model, reqs, *, slots=3, seed=3, **run_kw):
    eng = ContinuousEngine(cfg, model, GenerateConfig(
        max_new_tokens=10, eos_id=-1, temperature=0.8, seed=seed),
        slots=slots, cache_dtype=torch.float32, segment=2, device="cpu")
    got = {}

    def sink(rid, toks, status):
        assert rid not in got, f"duplicate emission for {rid}"
        got[rid] = ([int(x) for x in np.asarray(toks)], status)
    eng.run(list(reqs), sink, **run_kw)
    return got, eng


def test_continuous_sampling_repeats_and_ignores_the_slot_count(served):
    cfg, model = served
    reqs = requests(cfg)
    a, _ = serve(cfg, model, reqs)
    b, _ = serve(cfg, model, reqs)
    assert a == b and sorted(a) == list(range(len(reqs)))
    # each draw is keyed by the admission index, not by the slot, so one
    # slot or five give the same tokens (admission order is FIFO either
    # way)
    assert serve(cfg, model, reqs, slots=1)[0] == a
    assert serve(cfg, model, reqs, slots=5)[0] == a
    assert serve(cfg, model, reqs, seed=4)[0] != a
    assert serve(cfg, model, reqs, chained=True)[0] == a


def test_sampled_resume_equals_uninterrupted(served, tmp_path):
    """Killed at segment 3, resumed on 2 slots with an empty queue: every
    request once, the sampled tokens of the uninterrupted run (the keys
    ride the snapshot, the admission cursor too)."""
    cfg, model = served
    reqs = requests(cfg)
    ref, _ = serve(cfg, model, reqs)
    rec = RecoveryConfig(dir=str(tmp_path), snapshot_every=1, fsync=False)
    with pytest.raises(PreemptionError):
        serve(cfg, model, reqs, recovery=rec,
              on_segment=FaultPlan(lanes=3, preempt_at_segment=3)
              .preempt_hook(mode="raise"))
    got, eng = serve(cfg, model, [], slots=2, recovery=rec, resume=True)
    assert got == ref
    assert eng.stats["recovered_occupants"] > 0


def test_generate_sampling_is_row_keyed(served):
    """In ``generate`` a row's draws are keyed by (seed, row, step): a row
    samples the same tokens beside other rows as alone in row 0 of a batch
    whose row 0 it is."""
    cfg, model = served
    rng = np.random.default_rng(5)
    prompt = rng.integers(2, cfg.vocab_size, (3, 6))
    g = GenerateConfig(max_new_tokens=6, eos_id=-1, temperature=0.9, seed=1)
    out, _, _ = generate(cfg, model, prompt, g, cache_dtype=torch.float32,
                         device="cpu")
    solo, _, _ = generate(cfg, model, prompt[:1], g,
                          cache_dtype=torch.float32, device="cpu")
    assert torch.equal(out[:1], solo)
    b = Batcher(cfg, model, g, max_batch=3, device="cpu")
    for i in range(3):
        b.submit(Request(rid=i, prompt=prompt[i]))
    res = {r.rid: r.tokens for r in b.run_all()}
    for i in range(3):
        assert res[i].tolist() == out[i].tolist()
