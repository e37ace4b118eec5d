"""The port's encoder-decoder family (whisper-base) against the JAX package
on the CPU.

Reduced whisper-base (``shrink``: 2 + 2 layers, d 64, 4/4 heads at hd 16,
12 encoder frames, float32) with a 160-row position table.  Weights come
from the reference's ``init_params`` through ``params_from_reference``;
frames and tokens are drawn with numpy from a seed.  Tolerances: the
sinusoidal table exact; ``layer_norm``, cross-attention and the cross
caches 1e-6; ``encode``, forward logits and every prefill / decode step's
logits 1e-5 relative (atol 1e-5 at logits of order one) and 2e-5 on the
steps; ``lm_loss`` 1e-6 relative; greedy tokens, lengths and iters exact.
The reduced model's greedy decode repeats one token a row, so the decode
steps' logits are compared too: token parity alone would pass a broken
cross-attention.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as JA
from repro.configs import get_reduced
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.serve import GenerateConfig as JGenerateConfig
from repro.serve import generate as jax_generate
from repro.train.objective import lm_loss as jax_lm_loss
import repro_torch.models.attention as TA
from repro_torch import interop
from repro_torch.configs import get_reduced as port_reduced
from repro_torch.kernels import swa_attention as TS
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.serve import GenerateConfig, generate
from repro_torch.train.objective import lm_loss

ARCH = "whisper-base"
ROWS = 160         # pos_embed rows (max_position): the flash cases take 128
B = 2


def t(a):
    return torch.as_tensor(np.array(a))


@contextlib.contextmanager
def flash(enabled):
    """Both packages' flash flag, restored afterwards."""
    j, p = JA.USE_FLASH_SWA, TA.USE_FLASH_SWA
    JA.set_flash_swa(enabled)
    TA.set_flash_swa(enabled)
    try:
        yield
    finally:
        JA.set_flash_swa(j)
        TA.set_flash_swa(p)


@pytest.fixture(scope="module")
def whisper():
    cfg = get_reduced(ARCH)
    params = JT.init_params(cfg, jax.random.PRNGKey(0), max_position=ROWS)
    model = interop.params_from_reference(
        port_reduced(ARCH), jax.tree.map(np.asarray, params), device="cpu")
    frames = np.random.default_rng(1).normal(
        size=(B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    enc = JT.encode(cfg, params, jnp.asarray(frames))
    return cfg, params, model, frames, enc


def port_cross(cfg, enc):
    return interop.cross_caches_from_reference(
        port_reduced(ARCH),
        jax.tree.map(np.asarray, JT.prefill_cross_caches(cfg, *enc)),
        device="cpu")


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seq,dim", [(12, 64), (1500, 512)])
def test_sinusoidal_positions_exact(seq, dim):
    got = TL.sinusoidal_positions(seq, dim)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, JL.sinusoidal_positions(seq, dim))


def test_layer_norm(rng):
    x = rng.normal(size=(2, 5, 64)).astype(np.float32) * 3 + 1
    scale = rng.normal(size=(64,)).astype(np.float32)
    bias = rng.normal(size=(64,)).astype(np.float32)
    np.testing.assert_allclose(
        TL.layer_norm(t(x), t(scale), t(bias)).numpy(),
        np.asarray(JL.layer_norm(x, scale, bias)), atol=1e-6)


# ---------------------------------------------------------------------------
# cross-attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cached", [False, True])
def test_cross_attention(whisper, cached, rng):
    """The x_kv branch: keys and values from the encoder's output (or its
    read-only cache), no RoPE even at the default theta, no mask."""
    cfg, params, model, _, enc = whisper
    p = jax.tree.map(lambda a: a[0], params["unit"][0]["cross"])
    x = rng.normal(size=(B, 5, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(3, 8)[None], (B, 5))
    kw = dict(num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
              head_dim=cfg.resolved_head_dim, causal=False)
    jcache = tcache = None
    if cached:
        jcache = JT.prefill_cross_caches(cfg, params, enc)["unit"][0]
        jcache = jax.tree.map(lambda a: a[0], jcache)
        tcache = TT.prefill_cross_caches(port_reduced(ARCH), model,
                                         t(enc))[0]
        for key in "kv":
            np.testing.assert_allclose(tcache[key].numpy(),
                                       np.asarray(jcache[key]), atol=1e-6)
    want, wc = JA.attention(p, jnp.asarray(x), positions=jnp.asarray(pos),
                            x_kv=enc, kv_cache=jcache, **kw)
    got, gc = TA.attention(model.layers[0].cross, t(x), positions=t(pos),
                           x_kv=t(enc), kv_cache=tcache, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    assert (gc is None) == (wc is None) and (gc is tcache or not cached)


def test_prefill_cross_caches(whisper):
    cfg, params, model, _, enc = whisper
    got = TT.prefill_cross_caches(port_reduced(ARCH), model, t(enc))
    want = port_cross(cfg, (params, enc))
    assert len(got) == len(want) == cfg.num_layers
    for g, w in zip(got, want):
        assert sorted(g) == ["k", "v"]
        for key in "kv":
            assert g[key].shape == (B, cfg.encoder_seq, cfg.num_kv_heads,
                                    cfg.resolved_head_dim)
            np.testing.assert_allclose(g[key].numpy(), w[key].numpy(),
                                       atol=1e-6)


# ---------------------------------------------------------------------------
# encode, forward, loss
# ---------------------------------------------------------------------------

def test_encode(whisper):
    cfg, params, model, frames, enc = whisper
    got = TT.encode(port_reduced(ARCH), model, frames, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(enc), rtol=1e-5,
                               atol=1e-5)


def test_forward_and_lm_loss_with_frames(whisper, rng):
    cfg, params, model, frames, _ = whisper
    tokens = rng.integers(0, cfg.vocab_size, (B, 16))
    labels = rng.integers(0, cfg.vocab_size, (B, 16))
    jb = {"tokens": jnp.asarray(tokens), "frames": jnp.asarray(frames),
          "labels": jnp.asarray(labels)}
    want, _ = JT.forward(cfg, params, jb)
    jloss, _ = jax_lm_loss(cfg, params, jb)
    batch = {"tokens": tokens, "frames": frames, "labels": labels}
    got, aux = TT.forward(port_reduced(ARCH), model, batch, device="cpu")
    loss, metrics = lm_loss(port_reduced(ARCH), model, batch, device="cpu")
    assert got.shape == (B, 16, cfg.padded_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    assert float(metrics["loss"]) == float(loss)
    assert float(aux["lb_loss"]) == 0.0


def test_cross_attention_moves_the_logits(whisper, rng):
    """Other clips give other logits: the forward reads the frames."""
    cfg, params, model, frames, _ = whisper
    tokens = rng.integers(0, cfg.vocab_size, (B, 8))
    a, _ = TT.forward(port_reduced(ARCH), model,
                      {"tokens": tokens, "frames": frames}, device="cpu")
    b, _ = TT.forward(port_reduced(ARCH), model,
                      {"tokens": tokens[::-1].copy(),
                       "frames": frames[::-1].copy()}, device="cpu")
    c, _ = TT.forward(port_reduced(ARCH), model,
                      {"tokens": tokens, "frames": frames[::-1].copy()},
                      device="cpu")
    assert float((a - b.flip(0)).abs().max()) < 1e-5
    assert float((a - c).abs().max()) > 1e-3


@pytest.mark.parametrize("offset", [0, ROWS - 5, ROWS - 2, 3 * ROWS])
def test_pos_embed_slice_clamps_past_the_end(whisper, offset, rng):
    """``dynamic_slice_in_dim`` clamps the start so the rows fit."""
    cfg, params, model, _, _ = whisper
    tokens = rng.integers(0, cfg.vocab_size, (B, 5))
    want, wpos = JT.embed_inputs(cfg, params, jnp.asarray(tokens),
                                 pos_offset=offset)
    got, gpos = TT.embed_inputs(port_reduced(ARCH), model, t(tokens), offset)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(gpos.numpy(), np.asarray(wpos))


def test_frames_in_another_dtype_are_refused(whisper, rng):
    """A bf16 whisper with float32 frames: the reference's scan fails on
    the promoted carry (TypeError); the port names the cause
    (ValueError).  Frames in bf16 run on both; a float32 encoder output
    or cross cache is refused by the serving steps."""
    cfg16 = dataclasses.replace(get_reduced(ARCH), dtype="bfloat16")
    params = JT.init_params(cfg16, jax.random.PRNGKey(0), max_position=ROWS)
    pcfg = dataclasses.replace(port_reduced(ARCH), dtype="bfloat16")
    model = interop.params_from_reference(
        pcfg, jax.tree.map(np.asarray, params), device="cpu")
    _, _, _, frames, _ = whisper
    tokens = rng.integers(0, cfg16.vocab_size, (B, 8))
    with pytest.raises(TypeError):
        JT.forward(cfg16, params, {"tokens": jnp.asarray(tokens),
                                   "frames": jnp.asarray(frames)})
    with pytest.raises(ValueError, match="frames must be in the model dtype"):
        TT.forward(pcfg, model, {"tokens": tokens, "frames": frames},
                   device="cpu")
    f16 = torch.as_tensor(frames).to(torch.bfloat16)
    want, _ = JT.forward(cfg16, params, {
        "tokens": jnp.asarray(tokens),
        "frames": jnp.asarray(frames).astype(jnp.bfloat16)})
    got, _ = TT.forward(pcfg, model, {"tokens": tokens, "frames": f16},
                        device="cpu")
    assert np.isfinite(np.asarray(want)).all()
    assert torch.isfinite(got).all()
    enc = TT.encode(pcfg, model, f16, device="cpu")
    assert enc.dtype == torch.bfloat16
    cross = TT.prefill_cross_caches(pcfg, model, enc)
    caches = TT.init_cache(pcfg, B, 16, torch.bfloat16, device="cpu")
    with pytest.raises(ValueError, match="enc_out must be"):
        TT.decode_step(pcfg, model, caches, t(tokens[:, :1]), 0,
                       enc_out=enc.float(), cross_caches=cross)
    with pytest.raises(ValueError, match="cross cache must be"):
        generate(pcfg, model, tokens[:, :2], GenerateConfig(max_new_tokens=2),
                 enc_out=enc, device="cpu",
                 cross_caches=[{k: v.float() for k, v in c.items()}
                               for c in cross])


def test_per_sequence_pos_is_refused_as_in_the_reference(whisper):
    cfg, params, model, _, _ = whisper
    pos = np.array([[3], [4]])
    with pytest.raises(ValueError, match="absolute position embeddings"):
        JT.step_with_cache(cfg, params, None, jnp.zeros((B, 1), jnp.int32),
                           jnp.asarray(pos))
    with pytest.raises(ValueError, match="absolute position embeddings"):
        TT.step_with_cache(port_reduced(ARCH), model, None,
                           torch.zeros((B, 1), dtype=torch.long), t(pos))


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def test_every_decode_step_matches_the_reference(whisper, rng):
    """Prefill 8 tokens, then decode 8, each step's logits against the
    reference's ``step_with_cache`` / ``decode_step`` (and both against the
    teacher-forced forward), mirroring the reference's
    ``test_decode_matches_forward``."""
    cfg, params, model, frames, enc = whisper
    pcfg = port_reduced(ARCH)
    tokens = rng.integers(0, cfg.vocab_size, (B, 16))
    full, _ = TT.forward(pcfg, model, {"tokens": tokens, "frames": frames},
                         device="cpu")
    jcross = JT.prefill_cross_caches(cfg, params, enc)
    tcross = port_cross(cfg, (params, enc))
    tenc = t(enc)
    jc = JT.init_cache(cfg, B, 16, jnp.float32)
    pc = TT.init_cache(pcfg, B, 16, torch.float32, device="cpu")
    want, jc = JT.step_with_cache(cfg, params, jc, jnp.asarray(tokens[:, :8]),
                                  0, enc_out=enc, cross_caches=jcross)
    got, pc = TT.step_with_cache(pcfg, model, pc, t(tokens[:, :8]), 0,
                                 enc_out=tenc, cross_caches=tcross)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    np.testing.assert_allclose(got.numpy(), full[:, :8].numpy(), atol=2e-5)
    for s in range(8, 16):
        want, jc = JT.decode_step(cfg, params, jc,
                                  jnp.asarray(tokens[:, s:s + 1]), s,
                                  enc_out=enc, cross_caches=jcross)
        got, pc = TT.decode_step(pcfg, model, pc, t(tokens[:, s:s + 1]), s,
                                 enc_out=tenc, cross_caches=tcross)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
        np.testing.assert_allclose(got[:, 0].numpy(), full[:, s].numpy(),
                                   atol=2e-5)


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_greedy_generate_matches_jax(whisper, cache_dtype, rng):
    cfg, params, model, _, enc = whisper
    prompt = rng.integers(2, cfg.vocab_size, (B, 5))
    want, wlen, witers = jax_generate(
        cfg, params, jnp.asarray(prompt),
        JGenerateConfig(max_new_tokens=6, eos_id=1),
        cache_dtype=getattr(jnp, cache_dtype), enc_out=enc,
        cross_caches=JT.prefill_cross_caches(cfg, params, enc))
    got, glen, giters = generate(
        port_reduced(ARCH), model, prompt,
        GenerateConfig(max_new_tokens=6, eos_id=1),
        cache_dtype=getattr(torch, cache_dtype), enc_out=t(enc),
        cross_caches=port_cross(cfg, (params, enc)), device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(glen.numpy(), np.asarray(wlen))
    assert int(giters) == int(witers)


# ---------------------------------------------------------------------------
# interop
# ---------------------------------------------------------------------------

def test_interop_carries_every_new_leaf(whisper):
    cfg, params, model, _, _ = whisper
    ref = jax.tree.map(np.asarray, params)
    n_ref = sum(leaf.shape[0] if path[0].key in ("unit", "encoder")
                and any(getattr(p, "key", None) == "unit" for p in path)
                else 1
                for path, leaf in jax.tree_util.tree_leaves_with_path(ref))
    assert n_ref == len(list(model.parameters()))
    assert tuple(model.pos_embed.shape) == (ROWS, cfg.d_model)
    np.testing.assert_array_equal(model.pos_embed.numpy(), ref["pos_embed"])
    enc = ref["encoder"]
    for i, layer in enumerate(model.encoder.layers):
        np.testing.assert_array_equal(layer.attn.wq.numpy(),
                                      enc["unit"][0]["attn"]["wq"][i])
        np.testing.assert_array_equal(layer.mlp.up.numpy(),
                                      enc["unit"][0]["mlp"]["up"][i])
    np.testing.assert_array_equal(model.encoder.final_norm.numpy(),
                                  enc["final_norm"])
    for i, layer in enumerate(model.layers):
        # the cross leaves come from the same layer's subtree
        np.testing.assert_array_equal(layer.cross.wk.numpy(),
                                      ref["unit"][0]["cross"]["wk"][i])
        np.testing.assert_array_equal(layer.ln_x.numpy(),
                                      ref["unit"][0]["ln_x"][i])
    with pytest.raises(ValueError, match="encoder"):
        interop.params_from_reference(
            port_reduced(ARCH), {k: v for k, v in ref.items()
                                 if k != "encoder"}, device="cpu")


# ---------------------------------------------------------------------------
# the flash route and the gradient fault
# ---------------------------------------------------------------------------

def test_decoder_forward_on_the_flash_route(whisper, rng, monkeypatch):
    """S = 128 decoder tokens: the self-attention takes the flash route on
    both sides (the reference's Pallas kernel in interpret mode, the port's
    kernel wrapper on CPU tensors); the encoder and the cross-attention
    stay on the einsum route."""
    cfg, params, model, frames, _ = whisper
    calls = []
    real = TS.swa_attention
    monkeypatch.setattr(TS, "swa_attention",
                        lambda *a, **kw: calls.append(kw) or real(*a, **kw))
    tokens = rng.integers(0, cfg.vocab_size, (1, 128))
    with flash(True):
        want, _ = JT.forward(cfg, params, {"tokens": jnp.asarray(tokens),
                                           "frames": jnp.asarray(frames[:1])})
        got, _ = TT.forward(port_reduced(ARCH), model,
                            {"tokens": tokens, "frames": frames[:1]},
                            device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert len(calls) == cfg.num_layers
    assert all(c["causal"] and c["window"] == 0 for c in calls)


def test_kernel_route_refuses_gradients_and_the_einsum_route_gives_them(
        whisper, rng):
    cfg, _, model, frames, _ = whisper
    q, k, v = (torch.randn(4, 128, 16, requires_grad=True) for _ in range(3))
    with pytest.raises(RuntimeError, match="set_flash_swa\\(False\\)"):
        TS.swa_attention(q, k, v)
    with torch.no_grad():
        TS.swa_attention(q, k, v)
    TS.swa_attention(q.detach(), k.detach(), v.detach())

    pcfg = port_reduced(ARCH)
    tokens = rng.integers(0, cfg.vocab_size, (1, 128))
    batch = {"tokens": tokens, "frames": frames[:1]}
    wq = model.layers[0].attn.wq
    wq.requires_grad_(True)
    try:
        with flash(True), pytest.raises(RuntimeError, match="no backward"):
            TT.forward(pcfg, model, batch, device="cpu")
        with flash(False):
            logits, _ = TT.forward(pcfg, model, batch, device="cpu")
        logits.logsumexp(dim=-1).mean().backward()
        assert wq.grad is not None and float(wq.grad.abs().max()) > 0
    finally:
        wq.requires_grad_(False)
        wq.grad = None
