"""The port's SSM and hybrid families against the JAX package on the CPU.

``causal_conv`` (prefill and the decode cache), ``ssd_chunked`` against
the reference's ``ssd_chunked`` and ``ssd_ref`` (S a chunk multiple and
not, with and without ``h0``), ``mamba2_block`` prefill and decode, and
reduced mamba2-130m / jamba-v0.1-52b forwards, losses, prefill caches and
greedy serving.  Weights come from the reference's ``init_ssm`` /
``init_params``; inputs are drawn with numpy from a seed.  Tolerances:
float32 outputs and logits within atol 1e-5, except where the SSD's
chunked form feeds them (its outputs and states, the SSM and hybrid
stacks' logits): atol 2e-5 and rtol 1e-5 there.  The chunked form takes
differences of cumulative log-decays (|La| up to ~600 within a chunk),
and XLA's cumsum (a reduce_window) rounds them differently from
``torch.cumsum`` by up to 3e-5; the worst gap seen on the outputs is
1.4e-5.  The loss within 1e-6 relative; greedy tokens, lengths and iters
exact.
"""
import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as JA
from repro.configs import get_reduced
from repro.models import ssm as JS
from repro.models import transformer as JT
from repro.serve import GenerateConfig as JGenerateConfig
from repro.serve import generate as jax_generate
from repro.train.objective import lm_loss as jax_lm_loss
import repro_torch.models.attention as TA
from repro_torch import interop
from repro_torch.configs import get_reduced as port_reduced
from repro_torch.models import ssm as TS
from repro_torch.models import transformer as TT
from repro_torch.serve import GenerateConfig, generate
from repro_torch.train.objective import lm_loss


def t(a):
    return torch.as_tensor(np.array(a))


def close(got, want, atol=1e-5, rtol=0.0):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=rtol)


# ---------------------------------------------------------------------------
# causal conv
# ---------------------------------------------------------------------------

def test_causal_conv_prefill_and_decode_cache(rng):
    B, S, C, W = 2, 11, 24, 4
    x = rng.normal(size=(B, S, C)).astype(np.float32)
    w = (rng.normal(size=(W, C)) * 0.2).astype(np.float32)
    b = (rng.normal(size=(C,)) * 0.1).astype(np.float32)
    want, _ = JS.causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got, none = TS.causal_conv(t(x), t(w), t(b))
    assert none is None
    close(got, want)
    # the same sequence a token at a time through the (B, W-1, C) cache
    jc = jnp.zeros((B, W - 1, C), jnp.float32)
    pc = torch.zeros((B, W - 1, C))
    for s in range(S):
        wy, jc = JS.causal_conv(jnp.asarray(x[:, s:s + 1]), jnp.asarray(w),
                                jnp.asarray(b), jc)
        gy, pc = TS.causal_conv(t(x[:, s:s + 1]), t(w), t(b), pc)
        close(gy, wy)
        close(gy, got[:, s:s + 1])
        close(pc, jc, atol=0)


# ---------------------------------------------------------------------------
# SSD
# ---------------------------------------------------------------------------

def ssd_inputs(S, g, seed=0, Bt=2, nh=4, hd=8, n=16, h0=False):
    r = np.random.default_rng(seed)
    dims = dict(state=n, ngroups=g, nheads=nh, head_dim=hd)
    arrs = dict(
        x=r.normal(size=(Bt, S, nh, hd)).astype(np.float32),
        dt=r.uniform(0.01, 0.3, size=(Bt, S, nh)).astype(np.float32),
        A=np.log(np.linspace(1.0, 16.0, nh)).astype(np.float32),
        B=(r.normal(size=(Bt, S, g, n)) * 0.5).astype(np.float32),
        C=(r.normal(size=(Bt, S, g, n)) * 0.5).astype(np.float32),
        D=np.ones((nh,), np.float32))
    h0 = (r.normal(size=(Bt, nh, hd, n)).astype(np.float32) if h0
          else None)
    return arrs, dims, h0


def run_ssd(fn, arrs, dims, h0, conv):
    args = [conv(arrs[k]) for k in ("x", "dt", "A", "B", "C", "D")]
    return fn(*args, dims=dims, h0=None if h0 is None else conv(h0))


@pytest.mark.parametrize("S,g,h0", [(128, 1, False), (200, 1, False),
                                    (200, 2, True), (300, 1, True),
                                    (5, 1, True)])
def test_ssd_chunked_matches_reference(S, g, h0):
    """S = 200 and 300 pad to the chunk with dt = 0 steps (inert); S = 5
    is a single short chunk."""
    arrs, dims, h = ssd_inputs(S, g, h0=h0)
    wy, wh = run_ssd(JS.ssd_chunked, arrs, dims, h, jnp.asarray)
    ry, rh = run_ssd(JS.ssd_ref, arrs, dims, h, jnp.asarray)
    gy, gh = run_ssd(TS.ssd_chunked, arrs, dims, h, t)
    sy, sh = run_ssd(TS.ssd_ref, arrs, dims, h, t)
    assert gy.shape == (2, S, 4, 8) and gh.dtype == torch.float32
    close(gy, wy, atol=2e-5, rtol=1e-5)
    close(gh, wh, atol=2e-5, rtol=1e-5)
    # the sequential oracle, on both sides
    close(sy, ry, atol=1e-5, rtol=1e-5)
    close(sh, rh, atol=1e-5, rtol=1e-5)
    close(gy, ry, atol=1e-4)
    close(gh, rh, atol=1e-4, rtol=1e-4)


def test_ssd_padding_is_inert():
    """The chunked form at S = 200 equals the first 200 steps of a run at
    S = 256 whose extra steps are real: padding with dt = 0 adds nothing
    to the state that reaches step 200."""
    arrs, dims, _ = ssd_inputs(256, 1)
    cut = {k: (v[:, :200] if v.ndim > 1 else v) for k, v in arrs.items()}
    y200, h200 = run_ssd(TS.ssd_chunked, cut, dims, None, t)
    y256, _ = run_ssd(TS.ssd_chunked, arrs, dims, None, t)
    _, h_seq = run_ssd(TS.ssd_ref, cut, dims, None, t)
    close(y200, y256[:, :200].numpy(), atol=1e-5)
    close(h200, h_seq.numpy(), atol=1e-4, rtol=1e-4)


def test_softplus_has_no_identity_switch():
    x = torch.tensor([-30.0, -1.0, 0.0, 5.0, 20.5, 40.0, 90.0])
    close(TS.softplus(x), jax.nn.softplus(jnp.asarray(x.numpy())),
          atol=0, rtol=1e-7)


# ---------------------------------------------------------------------------
# the Mamba-2 block
# ---------------------------------------------------------------------------

D_MODEL = 32
DIMS = JS.ssm_dims(D_MODEL, 2, 8, 16, 4, 1)


def block_params(seed=0):
    p = JS.init_ssm(jax.random.PRNGKey(seed), D_MODEL, DIMS, jnp.float32)
    m = TS.SSM(D_MODEL, DIMS, device="cpu", dtype=torch.float32)
    for name, prm in m.named_parameters():
        prm.data.copy_(t(p[name]))
    return p, m


def test_ssm_parameters_follow_the_reference():
    p = JS.init_ssm(jax.random.PRNGKey(0), D_MODEL, DIMS, jnp.float32)
    m = TS.SSM(D_MODEL, DIMS, device="cpu", dtype=torch.bfloat16,
               generator=torch.Generator().manual_seed(0))
    assert {n for n, _ in m.named_parameters()} == set(p)
    for name, prm in m.named_parameters():
        assert tuple(prm.shape) == p[name].shape, name
    for name in ("A_log", "D", "dt_bias", "norm"):
        assert getattr(m, name).dtype == torch.float32
        # dt_bias is the reference's numpy draw, bit for bit; A_log's
        # linspace and log round differently in numpy and XLA (an ulp)
        close(getattr(m, name), p[name], atol=0,
              rtol=5e-7 if name == "A_log" else 0.0)
    for name in ("in_proj", "conv_w", "conv_b", "out_proj"):
        assert getattr(m, name).dtype == torch.bfloat16
    assert not m.conv_b.any()
    np.testing.assert_allclose(float(m.conv_w.float().std()),
                               float(np.std(np.asarray(p["conv_w"]))),
                               rtol=0.25)


def test_mamba2_block_prefill_and_decode(rng):
    p, m = block_params()
    B, S = 2, 150
    x = (rng.normal(size=(B, S + 3, D_MODEL)) * 0.5).astype(np.float32)
    want, _ = JS.mamba2_block(p, jnp.asarray(x[:, :S]), dims=DIMS)
    got, none = TS.mamba2_block(m, t(x[:, :S]), dims=DIMS)
    assert none is None
    close(got, want)
    ref_seq, _ = TS.mamba2_block(m, t(x[:, :S]), dims=DIMS, use_ref=True)
    close(ref_seq, got.numpy(), atol=1e-4)
    # prefill through the cache, then three single-token decode steps
    jc = JS.init_ssm_cache(B, DIMS, jnp.float32)
    pc = TS.init_ssm_cache(B, DIMS, torch.float32, device="cpu")
    for s0, s1 in ((0, S), (S, S + 1), (S + 1, S + 2), (S + 2, S + 3)):
        want, jc = JS.mamba2_block(p, jnp.asarray(x[:, s0:s1]), dims=DIMS,
                                   ssm_cache=jc)
        got, out_c = TS.mamba2_block(m, t(x[:, s0:s1]), dims=DIMS,
                                     ssm_cache=pc)
        assert out_c is pc                 # written in place
        close(got, want)
        close(pc["conv"], jc["conv"])
        close(pc["h"], jc["h"], atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# reduced mamba2-130m and jamba-v0.1-52b
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def flash(enabled):
    j, p = JA.USE_FLASH_SWA, TA.USE_FLASH_SWA
    JA.set_flash_swa(enabled)
    TA.set_flash_swa(enabled)
    try:
        yield
    finally:
        JA.set_flash_swa(j)
        TA.set_flash_swa(p)


@functools.lru_cache(maxsize=None)
def reference_params(arch):
    return JT.init_params(get_reduced(arch), jax.random.PRNGKey(0))


def models(arch):
    params = reference_params(arch)
    return (get_reduced(arch), port_reduced(arch), params,
            interop.params_from_reference(
                port_reduced(arch), jax.tree.map(np.asarray, params),
                device="cpu"))


@pytest.mark.parametrize("arch,S,use_flash", [
    ("mamba2-130m", 40, False), ("mamba2-130m", 200, False),
    ("jamba-v0.1-52b", 40, False), ("jamba-v0.1-52b", 128, True)])
def test_forward_logits_and_loss(arch, S, use_flash):
    cfg, pcfg, params, model = models(arch)
    rng = np.random.default_rng(4)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, S)),
             "labels": rng.integers(0, cfg.vocab_size, (2, S))}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    with flash(use_flash):
        want, waux = JT.forward(cfg, params, jbatch)
        jloss, _ = jax_lm_loss(cfg, params, jbatch)
        got, aux = TT.forward(pcfg, model, batch, device="cpu")
        loss, met = lm_loss(pcfg, model, batch, device="cpu")
    close(got, want, atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    for k in aux:
        np.testing.assert_allclose(float(aux[k]), float(waux[k]),
                                   rtol=1e-6, atol=1e-7)
    if arch == "mamba2-130m":
        assert float(loss) == float(met["loss"])
        assert all(float(v) == 0.0 for v in aux.values())


def test_params_from_reference_carries_ssm_leaves():
    cfg, pcfg, params, model = models("jamba-v0.1-52b")
    params = jax.tree.map(np.asarray, params)
    layers = interop.reference_layers(cfg, params)
    kinds = [("attn" if "attn" in l else "ssm",
              "moe" if "moe" in l else "mlp") for l in layers]
    assert kinds == [(s.kind, "moe" if s.ffn == "moe" else "mlp")
                     for s in model.specs]
    assert kinds[4][0] == "attn" and kinds[1][1] == "moe"
    for i, l in enumerate(layers):
        if "ssm" in l:
            for name in ("in_proj", "A_log", "dt_bias", "norm"):
                np.testing.assert_array_equal(
                    getattr(model.layers[i].ssm, name).numpy(),
                    l["ssm"][name])


def test_mamba_layers_have_no_ffn():
    _, pcfg, _, model = models("mamba2-130m")
    for layer in model.layers:
        assert sorted(n for n, _ in layer.named_children()) == ["ssm"]
        assert not hasattr(layer, "ln2")


@pytest.mark.parametrize("arch", ["mamba2-130m", "jamba-v0.1-52b"])
def test_prefill_caches_match_reference(arch):
    """KV caches on attention layers and {conv, h} on SSM layers, in run
    order, after a prefill and one decode step."""
    cfg, pcfg, params, model = models(arch)
    prompt = np.random.default_rng(5).integers(2, cfg.vocab_size, (3, 9))
    jc = JT.init_cache(cfg, 3, 16, jnp.float32)
    pc = TT.init_cache(pcfg, 3, 16, torch.float32, device="cpu")
    kinds = [sorted(c) for c in pc]
    assert kinds == [["k", "v"] if s.kind == "attn" else ["conv", "h"]
                     for s in model.specs]
    for step, (tok, pos) in enumerate(((prompt, 0), (prompt[:, :1], 9))):
        want, jc = JT.step_with_cache(cfg, params, jc, jnp.asarray(tok), pos)
        got, pc = TT.step_with_cache(pcfg, model, pc, torch.as_tensor(tok),
                                     pos)
        close(got, want)
        want_c = interop.caches_from_reference(
            cfg, jax.tree.map(np.asarray, jc), device="cpu")
        assert len(want_c) == len(pc)
        for w, g in zip(want_c, pc):
            assert sorted(w) == sorted(g)
            for key in w:
                assert w[key].dtype == g[key].dtype, key
                torch.testing.assert_close(g[key], w[key], rtol=1e-5,
                                           atol=1e-5)


@pytest.mark.parametrize("arch,max_new,budgets", [
    ("mamba2-130m", 8, None), ("mamba2-130m", 5, [5, 2, 3]),
    ("jamba-v0.1-52b", 8, None)])
def test_greedy_generate_matches_jax(arch, max_new, budgets):
    cfg, pcfg, params, model = models(arch)
    prompt = np.random.default_rng(6).integers(2, cfg.vocab_size, (3, 12))
    want, wlen, witers = jax_generate(
        cfg, params, jnp.asarray(prompt),
        JGenerateConfig(max_new_tokens=max_new, eos_id=1),
        cache_dtype=jnp.float32, budgets=budgets)
    got, glen, giters = generate(
        pcfg, model, prompt, GenerateConfig(max_new_tokens=max_new,
                                            eos_id=1),
        cache_dtype=torch.float32, budgets=budgets, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(glen.numpy(), np.asarray(wlen))
    assert int(giters) == int(witers)


def test_greedy_equals_teacher_forced_argmax_on_the_recurrence():
    """Prefill on the chunked form and decode on the sequential step give
    the tokens the scoring forward (chunked throughout) argmaxes."""
    _, pcfg, _, model = models("jamba-v0.1-52b")
    pcfg = dataclasses.replace(pcfg)
    prompt = np.random.default_rng(7).integers(2, pcfg.vocab_size, (2, 10))
    out, lengths, _ = generate(pcfg, model, prompt,
                               GenerateConfig(max_new_tokens=8, eos_id=1),
                               cache_dtype=torch.float32, device="cpu")
    full = torch.cat([torch.as_tensor(prompt), out.long()], dim=1)
    logits, _ = TT.forward(pcfg, model, {"tokens": full}, device="cpu")
    exp = logits[:, 9:-1].argmax(dim=-1)
    for b in range(2):
        L = int(lengths[b])
        assert torch.equal(out[b, :L].long(), exp[b, :L])
