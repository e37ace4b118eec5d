"""Gradients of the port's ``lm_loss`` against the JAX package's, on the
reduced config of every family, leaf by leaf.

Weights come from the reference's ``init_params`` (``interop.
params_from_reference``); the port's gradients, by parameter name, go back
to the reference's tree through ``interop.reference_tree``, so the two
trees are compared leaf for leaf in the reference's order.  Inputs are
drawn with numpy from a seed.  Tolerance (float32): every leaf within
1e-4 of its largest reference entry (the worst gap measured is 1.2e-5 of
it, jamba's; XLA and torch sum in other orders), the loss within 1e-6
relative.  Both sides run the attention's einsum route, as training does.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced
from repro.models import transformer as JT
from repro.train.objective import grad_accum_step as jax_grad_accum_step
from repro_torch import interop
from repro_torch.configs import get_reduced as port_reduced
from repro_torch.models import transformer as TT
from repro_torch.train.objective import grad_accum_step, trainable

ARCHS = ["qwen3-1.7b", "gemma2-9b", "deepseek-moe-16b", "mamba2-130m",
         "jamba-v0.1-52b", "whisper-base", "phi-3-vision-4.2b"]
B, S = 4, 16


def family_batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
                 np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(
                 np.int32)}
    if cfg.is_encoder_decoder:
        batch["frames"] = rng.normal(
            size=(B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.vision_patches:
        batch["patch_embeds"] = rng.normal(
            size=(B, cfg.vision_patches, cfg.vision_embed_dim)).astype(
                np.float32)
    return batch


def port_model(arch, params):
    return interop.params_from_reference(
        port_reduced(arch), jax.tree.map(np.asarray, params), device="cpu")


def assert_leaves_close(want_tree, got_named, cfg, rel=1e-4):
    got_tree = interop.reference_tree(
        cfg, {k: v.detach().float() for k, v in got_named.items()})
    want = jax.tree_util.tree_leaves_with_path(want_tree)
    got = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda t: t.numpy(), got_tree))
    assert [p for p, _ in want] == [p for p, _ in got]
    for (path, w), (_, g) in zip(want, got):
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape, path
        np.testing.assert_allclose(
            g, w, rtol=0, atol=rel * float(np.abs(w).max()) + 1e-12,
            err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_gradients_match_leaf_by_leaf(arch):
    cfg = get_reduced(arch)
    params = JT.init_params(cfg, jax.random.PRNGKey(0))
    model = port_model(arch, params)
    batch = family_batch(cfg)
    jgrads, jloss, jmet = jax.jit(
        lambda p, b: jax_grad_accum_step(cfg, p, b, accum=1))(
            params, jax.tree.map(jnp.asarray, batch))
    grads, loss, metrics = grad_accum_step(port_reduced(arch), model, batch,
                                           device="cpu")
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    for k in ("loss", "lb_loss", "router_z", "drop_frac"):
        np.testing.assert_allclose(float(metrics[k]), float(jmet[k]),
                                   rtol=1e-5, atol=1e-7)
    assert list(grads) == [k for k, _ in model.named_parameters()]
    assert_leaves_close(jgrads, grads, port_reduced(arch))
    # the step leaves the model frozen again: evaluation builds no graph
    assert not any(p.requires_grad for p in model.parameters())


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "deepseek-moe-16b",
                                  "mamba2-130m"])
def test_remat_gives_the_same_gradients(arch, monkeypatch):
    """``cfg.remat`` checkpoints every layer of a forward that builds a
    graph (and none of an evaluation forward), with the same gradients."""
    cfg = port_reduced(arch)
    params = JT.init_params(get_reduced(arch), jax.random.PRNGKey(1))
    model = port_model(arch, params)
    batch = family_batch(cfg, seed=1)
    calls = []
    real = TT.checkpoint

    def counted(*a, **kw):
        calls.append(a[0])
        return real(*a, **kw)
    monkeypatch.setattr(TT, "checkpoint", counted)
    plain, _, _ = grad_accum_step(cfg, model, batch, device="cpu")
    assert not calls
    on = dataclasses.replace(cfg, remat=True)
    remat, _, _ = grad_accum_step(on, model, batch, device="cpu")
    assert len(calls) == cfg.num_layers
    for k in plain:
        torch.testing.assert_close(remat[k], plain[k], rtol=0, atol=0)
    TT.forward(on, model, {"tokens": batch["tokens"]}, device="cpu")
    assert len(calls) == cfg.num_layers


def test_trainable_restores_each_parameter():
    cfg = port_reduced("qwen3-1.7b")
    model = TT.init_params(cfg, device="cpu")
    model.embed.requires_grad_(True)
    with trainable(model) as named:
        assert all(p.requires_grad for p in named.values())
    assert model.embed.requires_grad
    assert not any(p.requires_grad for n, p in model.named_parameters()
                   if n != "embed")
    model.embed.requires_grad_(False)


def test_sharding_hook_wraps_self_attention_as_the_reference():
    """The hook sees ``attn_in`` and ``attn_out`` around each
    self-attention of an ``attn_sequence_parallel`` config, in the
    reference's order, and its result flows on."""
    import repro.models.transformer as JTM
    jcfg = dataclasses.replace(get_reduced("qwen3-1.7b"),
                               attn_sequence_parallel=True)
    cfg = dataclasses.replace(port_reduced("qwen3-1.7b"),
                              attn_sequence_parallel=True)
    params = JT.init_params(jcfg, jax.random.PRNGKey(0))
    model = port_model("qwen3-1.7b", params)
    tokens = family_batch(cfg)["tokens"]
    jtags, tags = [], []
    JTM.set_sharding_hook(lambda tag, x: (jtags.append(tag), x * 2.0)[1])
    TT.set_sharding_hook(lambda tag, x: (tags.append(tag), x * 2.0)[1])
    try:
        want, _ = JT.forward(jcfg, params, {"tokens": jnp.asarray(tokens)})
        got, _ = TT.forward(cfg, model, {"tokens": tokens}, device="cpu")
    finally:
        JTM.set_sharding_hook(None)
        TT.set_sharding_hook(None)
    assert tags == ["attn_in", "attn_out"] * cfg.num_layers
    assert sorted(set(jtags)) == ["attn_in", "attn_out"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    plain, _ = TT.forward(cfg, model, {"tokens": tokens}, device="cpu")
    assert float((plain - got).abs().max()) > 1e-3

