"""The port's vision-stub family (phi-3-vision-4.2b) against the JAX package
on the CPU.

Reduced phi-3-vision (``shrink``: 2 layers, d 64, 4/4 heads at hd 16, 4
patches of 24-d, float32).  Weights come from the reference's
``init_params`` through ``params_from_reference``; patch embeddings and
tokens are drawn with numpy from a seed.  Tolerances: forward logits 1e-5
relative (atol 1e-5 at logits of order one); ``lm_loss`` 1e-6 relative;
every prefill / decode step's logits 2e-5; the bf16 embedding within one
bf16 ulp; greedy tokens, lengths and iters exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced
from repro.models import transformer as JT
from repro.serve import GenerateConfig as JGenerateConfig
from repro.serve import generate as jax_generate
from repro.train.objective import lm_loss as jax_lm_loss
from repro_torch import interop
from repro_torch.configs import get_reduced as port_reduced
from repro_torch.models import transformer as TT
from repro_torch.serve import GenerateConfig, generate
from repro_torch.train.objective import lm_loss

ARCH = "phi-3-vision-4.2b"
B = 2


def t(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def vlm():
    cfg = get_reduced(ARCH)
    params = JT.init_params(cfg, jax.random.PRNGKey(0))
    model = interop.params_from_reference(
        port_reduced(ARCH), jax.tree.map(np.asarray, params), device="cpu")
    patches = np.random.default_rng(2).normal(
        size=(B, cfg.vision_patches, cfg.vision_embed_dim)).astype(np.float32)
    return cfg, params, model, patches


def test_forward_and_lm_loss_with_patches(vlm, rng):
    """The projected patches go before the text; the loss counts the text
    positions only."""
    cfg, params, model, patches = vlm
    P = cfg.vision_patches
    tokens = rng.integers(0, cfg.vocab_size, (B, 12))
    labels = rng.integers(0, cfg.vocab_size, (B, 12))
    jb = {"tokens": jnp.asarray(tokens), "patch_embeds": jnp.asarray(patches),
          "labels": jnp.asarray(labels)}
    want, _ = JT.forward(cfg, params, jb)
    jloss, jmet = jax_lm_loss(cfg, params, jb)
    batch = {"tokens": tokens, "patch_embeds": patches, "labels": labels}
    got, _ = TT.forward(port_reduced(ARCH), model, batch, device="cpu")
    loss, metrics = lm_loss(port_reduced(ARCH), model, batch, device="cpu")
    assert got.shape == (B, P + 12, cfg.padded_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    np.testing.assert_allclose(float(metrics["loss"]), float(jmet["loss"]),
                               rtol=1e-6)
    logp = torch.log_softmax(got[:, P:], dim=-1)
    ce = -torch.gather(logp, -1, t(labels)[..., None])[..., 0].mean()
    np.testing.assert_allclose(float(loss), float(ce), rtol=1e-6)


def test_forward_without_patches(vlm, rng):
    cfg, params, model, _ = vlm
    tokens = rng.integers(0, cfg.vocab_size, (B, 12))
    want, _ = JT.forward(cfg, params, {"tokens": jnp.asarray(tokens)})
    got, _ = TT.forward(port_reduced(ARCH), model, {"tokens": tokens},
                        device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_patches_are_cast_before_the_projection(rng):
    """A bf16 model takes float32 patch embeddings: cast to bf16, then
    projected, as the reference's ``.astype(x.dtype) @ vision_proj``."""
    cfg = dataclasses.replace(get_reduced(ARCH), dtype="bfloat16")
    params = JT.init_params(cfg, jax.random.PRNGKey(1))
    model = interop.params_from_reference(
        dataclasses.replace(port_reduced(ARCH), dtype="bfloat16"),
        jax.tree.map(np.asarray, params), device="cpu")
    patches = rng.normal(size=(B, cfg.vision_patches,
                               cfg.vision_embed_dim)).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (B, 3))
    want, wpos = JT.embed_inputs(cfg, params, jnp.asarray(tokens),
                                 jnp.asarray(patches))
    got, gpos = TT.embed_inputs(cfg, model, t(tokens),
                                patch_embeds=t(patches))
    assert got.dtype == torch.bfloat16
    want = np.array(want.astype(jnp.float32))
    torch.testing.assert_close(got.float(), torch.as_tensor(want),
                               rtol=2 ** -8, atol=1e-6)
    np.testing.assert_array_equal(got[:, cfg.vision_patches:].float().numpy(),
                                  want[:, cfg.vision_patches:])
    np.testing.assert_array_equal(gpos.numpy(), np.asarray(wpos))


def test_every_decode_step_matches_the_reference(vlm, rng):
    """Prefill patches + 8 tokens, then decode 8 at positions P + s, each
    step's logits against the reference's and the teacher-forced
    forward's."""
    cfg, params, model, patches = vlm
    pcfg, P = port_reduced(ARCH), cfg.vision_patches
    tokens = rng.integers(0, cfg.vocab_size, (B, 16))
    full, _ = TT.forward(pcfg, model, {"tokens": tokens,
                                       "patch_embeds": patches},
                         device="cpu")
    jc = JT.init_cache(cfg, B, 16 + P, jnp.float32)
    pc = TT.init_cache(pcfg, B, 16 + P, torch.float32, device="cpu")
    want, jc = JT.step_with_cache(cfg, params, jc, jnp.asarray(tokens[:, :8]),
                                  0, patch_embeds=jnp.asarray(patches))
    got, pc = TT.step_with_cache(pcfg, model, pc, t(tokens[:, :8]), 0,
                                 patch_embeds=t(patches))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    np.testing.assert_allclose(got.numpy(), full[:, :8 + P].numpy(),
                               atol=2e-5)
    for s in range(8, 16):
        want, jc = JT.decode_step(cfg, params, jc,
                                  jnp.asarray(tokens[:, s:s + 1]), P + s)
        got, pc = TT.decode_step(pcfg, model, pc, t(tokens[:, s:s + 1]),
                                 P + s)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
        np.testing.assert_allclose(got[:, 0].numpy(), full[:, P + s].numpy(),
                                   atol=2e-5)


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_greedy_generate_matches_jax(vlm, cache_dtype, rng):
    cfg, params, model, patches = vlm
    prompt = rng.integers(2, cfg.vocab_size, (B, 5))
    want, wlen, witers = jax_generate(
        cfg, params, jnp.asarray(prompt),
        JGenerateConfig(max_new_tokens=6, eos_id=1),
        cache_dtype=getattr(jnp, cache_dtype),
        patch_embeds=jnp.asarray(patches))
    got, glen, giters = generate(
        port_reduced(ARCH), model, prompt,
        GenerateConfig(max_new_tokens=6, eos_id=1),
        cache_dtype=getattr(torch, cache_dtype), patch_embeds=patches,
        device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(glen.numpy(), np.asarray(wlen))
    assert int(giters) == int(witers)


def test_greedy_equals_teacher_forced_argmax(vlm, rng):
    cfg, _, model, patches = vlm
    pcfg, P = port_reduced(ARCH), cfg.vision_patches
    prompt = rng.integers(2, cfg.vocab_size, (B, 6))
    out, lengths, _ = generate(pcfg, model, prompt,
                               GenerateConfig(max_new_tokens=8, eos_id=1),
                               cache_dtype=torch.float32,
                               patch_embeds=patches, device="cpu")
    full = torch.cat([t(prompt), out.long()], dim=1)
    logits, _ = TT.forward(pcfg, model, {"tokens": full,
                                         "patch_embeds": patches},
                           device="cpu")
    exp = logits[:, P + 5:-1].argmax(dim=-1)
    for b in range(B):
        L = int(lengths[b])
        assert torch.equal(out[b, :L].long(), exp[b, :L])


def test_per_sequence_pos_names_its_roadmap_item(vlm):
    """Per-sequence positions (ROADMAP.md A9.1) run on the vision stub's
    decoder too: a (B, 1) ``pos`` without caches gives the reference's
    logits (RoPE at each row's own position)."""
    cfg, params, model, _ = vlm
    tok = np.asarray([[5], [7]])
    pos = np.asarray([[3], [4]], np.int32)
    want, _ = JT.step_with_cache(cfg, params, None, jnp.asarray(tok),
                                 jnp.asarray(pos))
    got, _ = TT.step_with_cache(port_reduced(ARCH), model, None,
                                torch.as_tensor(tok), torch.as_tensor(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_interop_carries_the_vision_projection(vlm):
    cfg, params, model, _ = vlm
    ref = jax.tree.map(np.asarray, params)
    assert "vision_proj" in ref and "pos_embed" not in ref
    assert not hasattr(model, "pos_embed") and not hasattr(model, "encoder")
    np.testing.assert_array_equal(model.vision_proj.numpy(),
                                  ref["vision_proj"])
    n_ref = sum(leaf.shape[0] if path[0].key == "unit" else 1
                for path, leaf in jax.tree_util.tree_leaves_with_path(ref))
    assert n_ref == len(list(model.parameters()))
    with pytest.raises(ValueError, match="top-level leaves"):
        interop.params_from_reference(
            port_reduced(ARCH), {k: v for k, v in ref.items()
                                 if k != "vision_proj"}, device="cpu")
