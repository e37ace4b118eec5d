"""The port's serving path against the JAX package on the CPU.

Reduced gemma2-9b (window 8 < max_seq, so its local layers use ring
caches) and reduced qwen3-1.7b (full caches).  Weights come from the
reference's ``init_params``; prompts are drawn with numpy.  Tolerances:
float32 logits and cache values within atol 1e-5 (summation order), ring
``pos`` arrays exact; greedy tokens, ``lengths`` and ``iters`` exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced
from repro.models import transformer as JT
from repro.serve import GenerateConfig as JGenerateConfig
from repro.serve import generate as jax_generate
from repro_torch import interop
from repro_torch.configs import get_reduced as port_reduced
from repro_torch.models import transformer as TT
from repro_torch.serve import GenerateConfig, generate

ARCHS = ["gemma2-9b", "qwen3-1.7b"]


@pytest.fixture(scope="module", params=ARCHS)
def served(request):
    arch = request.param
    cfg = get_reduced(arch)
    params = JT.init_params(cfg, jax.random.PRNGKey(0))
    model = interop.params_from_reference(
        port_reduced(arch), jax.tree.map(np.asarray, params), device="cpu")
    return arch, cfg, params, model


def assert_caches_equal(cfg, jax_caches, port_caches):
    want = interop.caches_from_reference(
        cfg, jax.tree.map(np.asarray, jax_caches), device="cpu")
    assert len(want) == len(port_caches)
    for w, g in zip(want, port_caches):
        assert sorted(w) == sorted(g)
        for key in w:
            assert w[key].dtype == g[key].dtype, key
            if key == "pos":
                assert torch.equal(w[key], g[key])
            else:
                torch.testing.assert_close(g[key], w[key], rtol=0, atol=1e-5)


@pytest.mark.parametrize("prompt_len", [5, 12])
def test_step_with_cache_and_decode_step(served, prompt_len, rng):
    """Prefill then three decode steps; prompt 12 > window 8 takes the
    ring's keep-last-W branch, prompt 5 the plain slot write."""
    arch, cfg, params, model = served
    B, max_seq = 3, 24
    prompt = rng.integers(2, cfg.vocab_size, (B, prompt_len))
    jc = JT.init_cache(cfg, B, max_seq, jnp.float32)
    pc = TT.init_cache(port_reduced(arch), B, max_seq, torch.float32,
                       device="cpu")
    if arch == "gemma2-9b":
        assert [sorted(c) for c in pc[:2]] == [["k", "pos", "v"], ["k", "v"]]
    assert_caches_equal(cfg, jc, pc)
    want, jc = JT.step_with_cache(cfg, params, jc, jnp.asarray(prompt), 0)
    got, pc = TT.step_with_cache(port_reduced(arch), model, pc,
                                 torch.as_tensor(prompt), 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert_caches_equal(cfg, jc, pc)
    for step in range(3):
        tok = rng.integers(2, cfg.vocab_size, (B, 1))
        pos = prompt_len + step
        want, jc = JT.decode_step(cfg, params, jc, jnp.asarray(tok), pos)
        got, pc = TT.decode_step(port_reduced(arch), model, pc,
                                 torch.as_tensor(tok), pos)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
        assert_caches_equal(cfg, jc, pc)


@pytest.mark.parametrize("max_new,budgets", [(10, None), (6, [6, 2, 4]),
                                             (1, None)])
def test_greedy_generate_matches_jax(served, max_new, budgets, rng):
    arch, cfg, params, model = served
    prompt = rng.integers(2, cfg.vocab_size, (3, 12))
    want, wlen, witers = jax_generate(
        cfg, params, jnp.asarray(prompt),
        JGenerateConfig(max_new_tokens=max_new, eos_id=1),
        cache_dtype=jnp.float32, budgets=budgets)
    got, glen, giters = generate(
        port_reduced(arch), model, prompt,
        GenerateConfig(max_new_tokens=max_new, eos_id=1),
        cache_dtype=torch.float32, budgets=budgets, device="cpu")
    assert got.dtype == torch.int32 and glen.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(glen.numpy(), np.asarray(wlen))
    assert int(giters) == int(witers)


def test_eos_retires_a_sequence_as_in_jax(served, rng):
    """EOS chosen as the first greedy token of sequence 0: it stops at
    length 1 and is eos-padded, on both sides."""
    arch, cfg, params, model = served
    prompt = rng.integers(2, cfg.vocab_size, (2, 4))
    first, _, _ = generate(port_reduced(arch), model, prompt,
                           GenerateConfig(max_new_tokens=2, eos_id=1),
                           cache_dtype=torch.float32, device="cpu")
    eos = int(first[0, 0])
    want, wlen, witers = jax_generate(
        cfg, params, jnp.asarray(prompt),
        JGenerateConfig(max_new_tokens=8, eos_id=eos),
        cache_dtype=jnp.float32)
    got, glen, giters = generate(port_reduced(arch), model, prompt,
                                 GenerateConfig(max_new_tokens=8,
                                                eos_id=eos),
                                 cache_dtype=torch.float32, device="cpu")
    assert int(glen[0]) == 1 and (got[0, 1:] == eos).all()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(glen.numpy(), np.asarray(wlen))
    assert int(giters) == int(witers)


def test_greedy_equals_teacher_forced_argmax(served, rng):
    """The port's own consistency: its greedy tokens are the argmax of its
    scoring forward over prompt + generated tokens."""
    arch, cfg, params, model = served
    prompt = rng.integers(2, cfg.vocab_size, (3, 8))
    out, lengths, _ = generate(port_reduced(arch), model, prompt,
                               GenerateConfig(max_new_tokens=10, eos_id=1),
                               cache_dtype=torch.float32, device="cpu")
    full = torch.cat([torch.as_tensor(prompt), out.long()], dim=1)
    logits, _ = TT.forward(port_reduced(arch), model, {"tokens": full},
                           device="cpu")
    exp = logits[:, 7:-1].argmax(dim=-1)
    for b in range(3):
        L = int(lengths[b])
        assert torch.equal(out[b, :L].long(), exp[b, :L])


def test_sampled_decode_names_its_roadmap_item(served, rng):
    """Sampled decode (ROADMAP.md A9.5) runs: ``jax.random`` keys cannot be
    reproduced in torch, so it is held to determinism within the port (the
    same seed draws the same tokens, another seed other ones) and to the
    reference's shapes and budget rules."""
    arch, cfg, params, model = served
    prompt = rng.integers(2, cfg.vocab_size, (3, 6))

    def draw(seed):
        return generate(port_reduced(arch), model, prompt,
                        GenerateConfig(max_new_tokens=8, temperature=0.7,
                                       seed=seed),
                        cache_dtype=torch.float32, budgets=[8, 3, 8],
                        device="cpu")
    out, lengths, iters = draw(0)
    again, lengths2, _ = draw(0)
    other, _, _ = draw(1)
    assert out.shape == (3, 8) and out.dtype == torch.int32
    assert torch.equal(out, again) and torch.equal(lengths, lengths2)
    assert not torch.equal(out, other)
    assert int(lengths[1]) <= 3 and 1 <= int(iters) <= 8
