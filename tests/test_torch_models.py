"""The port's LM stack (dense family) against the JAX package on the CPU.

Inputs are drawn with numpy from a seed; weights come from the reference's
``init_params`` and are carried over by ``params_from_reference``.
Tolerances: float32 throughout; atol 1e-5 on layer outputs and logits
(summation order differs between XLA and torch; the measured worst is
about 5e-6), rel 1e-6 on the mean loss.  The flash route on the CPU runs
the kernel's plain version on the port's side and the Pallas kernel in
interpret mode on the reference's.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as JA
from repro.configs import get_reduced
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.train.objective import lm_loss as jax_lm_loss
import repro_torch.models.attention as TA
from repro_torch import interop
from repro_torch.configs import get_reduced as port_reduced
from repro_torch.kernels import swa_attention as TS
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.train.objective import lm_loss


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


@pytest.fixture
def kernel_calls(monkeypatch):
    """Counts the flash route's calls of the kernel wrapper."""
    calls = []
    real = TS.swa_attention

    def counted(*a, **kw):
        calls.append(kw)
        return real(*a, **kw)
    monkeypatch.setattr(TS, "swa_attention", counted)
    return calls


def reference_model(arch, seed=0):
    cfg = get_reduced(arch)
    params = JT.init_params(cfg, jax.random.PRNGKey(seed))
    model = interop.params_from_reference(
        port_reduced(arch), jax.tree.map(np.asarray, params), device="cpu")
    return cfg, params, model


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_rms_norm_and_softcap(rng):
    x = rng.normal(size=(2, 5, 64)).astype(np.float32) * 3
    scale = rng.normal(size=(64,)).astype(np.float32) * 0.1
    np.testing.assert_allclose(TL.rms_norm(t(x), t(scale), 1e-6).numpy(),
                               np.asarray(JL.rms_norm(x, scale, 1e-6)),
                               atol=1e-5)
    np.testing.assert_allclose(TL.softcap(t(x) * 30, 30.0).numpy(),
                               np.asarray(JL.softcap(x * 30, 30.0)),
                               atol=1e-5)
    assert torch.equal(TL.softcap(t(x), 0.0), t(x))


def test_apply_rope(rng):
    x = rng.normal(size=(2, 40, 4, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(40)[None] + 7, (2, 40))
    for theta in (1e4, 1e6):
        want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
        got = TL.apply_rope(t(x), t(pos), theta)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("act,gated", [("gelu", True), ("silu", True),
                                       ("silu", False)])
def test_mlp(act, gated, rng):
    p = JL.init_mlp(jax.random.PRNGKey(1), 64, 160, gated, jnp.float32)
    m = TL.MLP(64, 160, gated, device="cpu", dtype=torch.float32)
    for name in p:
        getattr(m, name).data.copy_(t(p[name]))
    x = rng.normal(size=(2, 9, 64)).astype(np.float32)
    np.testing.assert_allclose(TL.mlp(m, t(x), act).numpy(),
                               np.asarray(JL.mlp(p, jnp.asarray(x), act)),
                               atol=1e-5)


# ---------------------------------------------------------------------------
# attention without a cache
# ---------------------------------------------------------------------------

ATTN_CASES = {
    # name: (head_dim, window, softcap, qk_norm, flash)
    "einsum": (16, 0, 0.0, False, False),
    "window_softcap": (16, 100, 50.0, False, False),
    "flash_global": (64, 0, 0.0, False, True),
    "flash_window_softcap": (64, 128, 50.0, False, True),
    "qk_norm_skips_flash": (16, 0, 0.0, True, True),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attention(case, rng, kernel_calls):
    hd, window, cap, qk_norm, use_flash = ATTN_CASES[case]
    B, S, D, H, KH = 2, 256, 64, 4, 2
    p = JA.init_attention(jax.random.PRNGKey(0), D, H, KH, hd, jnp.float32,
                          qk_norm=qk_norm)
    if qk_norm:
        p["q_norm"] = jnp.asarray(rng.normal(size=(hd,)) * 0.1, jnp.float32)
        p["k_norm"] = jnp.asarray(rng.normal(size=(hd,)) * 0.1, jnp.float32)
    a = TA.Attention(D, H, KH, hd, qk_norm=qk_norm, device="cpu",
                     dtype=torch.float32)
    for name in p:
        getattr(a, name).data.copy_(t(p[name]))
    x = (rng.normal(size=(B, S, D)) * 0.3).astype(np.float32)
    pos = np.broadcast_to(np.arange(S)[None], (B, S))
    kw = dict(num_heads=H, num_kv_heads=KH, head_dim=hd, rope_theta=1e4,
              causal=True, window=window, attn_softcap=cap, qk_norm=qk_norm)
    with flash(use_flash):
        want, _ = JA.attention(p, jnp.asarray(x), positions=jnp.asarray(pos),
                               **kw)
        got, cache = TA.attention(a, t(x), positions=t(pos), **kw)
    assert cache is None
    assert len(kernel_calls) == (1 if use_flash and not qk_norm else 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("B", [1, 2])
def test_flash_route_hands_the_kernel_contiguous_operands(B, monkeypatch):
    """The kernel takes contiguous (rows, S, hd) operands; at B=1 the
    (B,S,H,hd) -> (B·H,S,hd) reshape alone is a strided view (found on the
    card, where the wrapper refused it)."""
    seen = []

    def check(q, k, v, **kw):
        seen.append(q.is_contiguous() and k.is_contiguous()
                    and v.is_contiguous())
        return TS.swa_attention_plain(q, k, v, **kw)
    monkeypatch.setattr(TS, "swa_attention", check)
    a = TA.Attention(64, 4, 2, 16, device="cpu", dtype=torch.float32,
                     generator=torch.Generator().manual_seed(0))
    x = torch.randn((B, 128, 64), generator=torch.Generator().manual_seed(1))
    with flash(True):
        TA.attention(a, x, positions=torch.arange(128)[None].expand(B, 128),
                     num_heads=4, num_kv_heads=2, head_dim=16)
    assert seen == [True]


def test_flash_flag_default_takes_the_kernel_only_on_the_card():
    assert TA.USE_FLASH_SWA is None
    assert not TA._flash_enabled(torch.device("cpu"))
    assert TA._flash_enabled(torch.device("cuda"))
    with flash(False):
        assert not TA._flash_enabled(torch.device("cuda"))


def test_attention_refuses_later_slices():
    """The A9 paths run now (the ragged mask, per-sequence cache positions,
    the int8 cache); what stays refused is a per-sequence ring write of
    more than one key (continuous prefill stages one sequence at a
    time)."""
    a = TA.Attention(64, 4, 2, 16, device="cpu", dtype=torch.float32,
                     generator=torch.Generator().manual_seed(0))
    x = torch.randn((2, 4, 64), generator=torch.Generator().manual_seed(1))
    pos = torch.arange(4)[None].expand(2, 4)
    kw = dict(positions=pos, num_heads=4, num_kv_heads=2, head_dim=16)
    out, cache = TA.attention(a, x, x_kv=x, **kw)      # cross
    assert out.shape == x.shape and cache is None
    plain, _ = TA.attention(a, x, **kw)
    full, _ = TA.attention(a, x, kv_len=torch.tensor([4, 4]), **kw)
    torch.testing.assert_close(full, plain, rtol=0, atol=0)
    short, _ = TA.attention(a, x, kv_len=torch.tensor([4, 2]), **kw)
    torch.testing.assert_close(short[1, :2], plain[1, :2], rtol=0,
                               atol=1e-6)               # causal: unchanged
    cache = TA.init_kv_cache(2, 8, 2, 16, torch.float32, device="cpu")
    step = dict(kw, positions=torch.tensor([[3], [5]]))
    TA.attention(a, x[:, :1], kv_cache=cache,
                 cache_pos=torch.tensor([[3], [5]]), **step)
    written = cache["k"].abs().sum(dim=(2, 3)) > 0
    assert written.tolist() == [[i == 3 for i in range(8)],
                                [i == 5 for i in range(8)]]
    ring = TA.init_kv_cache(2, 16, 2, 16, torch.float32, window=8,
                            device="cpu")
    with pytest.raises(ValueError, match="decode-only"):
        TA.attention(a, x[:, :2], kv_cache=ring,
                     cache_pos=torch.tensor([[3], [4]]),
                     **dict(kw, positions=torch.tensor([[3, 4], [4, 5]])),
                     window=8)
    q = TA.init_kv_cache(2, 8, 2, 16, torch.float32, quant=True,
                         device="cpu")
    out, q = TA.attention(a, x, kv_cache=q, cache_pos=0, **kw)
    assert q["k"].dtype == torch.int8 and out.shape == x.shape


# ---------------------------------------------------------------------------
# the whole forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,use_flash", [
    ("gemma2-9b", False), ("gemma2-9b", True), ("yi-9b", True),
    ("qwen3-1.7b", True), ("phi3-medium-14b", True)])
def test_forward_logits_and_loss(arch, use_flash, rng, kernel_calls):
    cfg, params, model = reference_model(arch)
    B, S = 2, 256
    tokens = rng.integers(0, cfg.vocab_size, (B, S))
    labels = rng.integers(0, cfg.vocab_size, (B, S))
    with flash(use_flash):
        want, _ = JT.forward(cfg, params, {"tokens": jnp.asarray(tokens)})
        jloss, _ = jax_lm_loss(cfg, params, {"tokens": jnp.asarray(tokens),
                                             "labels": jnp.asarray(labels)})
        got, aux = TT.forward(port_reduced(arch), model, {"tokens": tokens},
                              device="cpu")
        loss, metrics = lm_loss(port_reduced(arch), model,
                                {"tokens": tokens, "labels": labels},
                                device="cpu")
    assert got.shape == (B, S, cfg.padded_vocab)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    assert float(metrics["loss"]) == float(loss)
    assert float(aux["lb_loss"]) == 0.0
    # qwen3 has qk-norm, so it never takes the flash route
    flash_layers = 0 if cfg.qk_norm else cfg.num_layers
    assert len(kernel_calls) == (2 * flash_layers if use_flash else 0)
    if use_flash and arch == "gemma2-9b":
        assert [c["window"] for c in kernel_calls[:4]] == [8, 0, 8, 0]
        assert all(c["softcap"] == 50.0 for c in kernel_calls)


def test_bf16_routes_agree():
    """A CPU rehearsal of chip_smoke.py phase 12's bf16 gate at reduced
    size: the flash route (plain version) and the einsum route give
    lm_loss within a tenth of the card's bound (TOL_LOSS_BF16 = 5e-3
    relative); measured ~1e-4 here."""
    import dataclasses
    cfg = dataclasses.replace(port_reduced("gemma2-9b"), dtype="bfloat16")
    model = TT.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (1, 256)),
             "labels": rng.integers(0, cfg.vocab_size, (1, 256))}
    losses = []
    for use_flash in (True, False):
        TA.set_flash_swa(use_flash)
        try:
            losses.append(float(lm_loss(cfg, model, batch, device="cpu")[0]))
        finally:
            TA.set_flash_swa(None)
    assert model.embed.dtype == torch.bfloat16
    assert abs(losses[0] - losses[1]) / abs(losses[1]) < 5e-4


def test_embed_scale_rounds_to_the_model_dtype():
    cfg = port_reduced("gemma2-9b")
    import dataclasses
    cfg = dataclasses.replace(cfg, d_model=3584, dtype="bfloat16")
    model = torch.nn.Module()
    model.embed = torch.ones((4, 3584), dtype=torch.bfloat16)
    x, pos = TT.embed_inputs(cfg, model, torch.tensor([[1, 2]]), 5)
    assert float(x[0, 0, 0]) == 59.75
    assert pos.tolist() == [[5, 6]]


# ---------------------------------------------------------------------------
# params_from_reference
# ---------------------------------------------------------------------------

def test_params_from_reference_order_and_shapes():
    cfg = get_reduced("gemma2-9b")
    params = jax.tree.map(np.asarray,
                          JT.init_params(cfg, jax.random.PRNGKey(3)))
    model = interop.params_from_reference(port_reduced("gemma2-9b"), params,
                                          device="cpu")
    prefix, unit, reps = cfg.block_pattern()
    assert (len(prefix), len(unit), reps) == (0, 2, 2)
    assert [s.window for s in model.specs] == [8, 0, 8, 0]
    for r in range(reps):
        for j in range(len(unit)):
            layer = model.layers[r * len(unit) + j]
            np.testing.assert_array_equal(layer.attn.wq.numpy(),
                                          params["unit"][j]["attn"]["wq"][r])
            np.testing.assert_array_equal(layer.mlp.down.numpy(),
                                          params["unit"][j]["mlp"]["down"][r])
    # every leaf of the reference has the port's shape at the same name
    n = 0
    for i, tree in enumerate(interop.reference_layers(cfg, params)):
        for name, prm in model.layers[i].named_parameters():
            leaf = tree
            for key in name.split("."):
                leaf = leaf[key]
            assert leaf.shape == tuple(prm.shape), name
            n += 1
    assert n == reps * sum(len(jax.tree.leaves(u)) for u in params["unit"])
    assert tuple(model.embed.shape) == params["embed"].shape
    bad = dict(params, unit=params["unit"][:1])
    with pytest.raises(ValueError, match="unit"):
        interop.params_from_reference(port_reduced("gemma2-9b"), bad,
                                      device="cpu")


def test_bf16_leaves_carry_over_bit_for_bit():
    a = np.asarray(jnp.asarray([1.5, -2.25, 3.1e-5, 59.866], jnp.bfloat16))
    got = interop.tensor_from_numpy(a, "cpu")
    assert got.dtype == torch.bfloat16
    assert got.float().tolist() == a.astype(np.float32).tolist()


def test_reference_layers_puts_the_prefix_first():
    cfg = get_reduced("deepseek-moe-16b")            # 1 prefix + 2 reps
    prefix, unit, reps = cfg.block_pattern()
    tree = {"prefix": [{"w": np.full((2,), -1)}],
            "unit": [{"w": np.arange(reps)[:, None] * np.ones((1, 2))}]}
    layers = interop.reference_layers(cfg, tree)
    assert [float(l["w"][0]) for l in layers] == [-1.0] + list(range(reps))


@pytest.mark.parametrize("entry", ["init_params", "init_cache"])
def test_unknown_family_raises(entry):
    import dataclasses
    cfg = dataclasses.replace(port_reduced("gemma2-9b"), family="speech")
    call = {"init_params": lambda: TT.init_params(cfg, device="cpu"),
            "init_cache": lambda: TT.init_cache(cfg, 1, 16, device="cpu")}
    with pytest.raises(ValueError, match="unknown family 'speech'"):
        call[entry]()


def test_init_params_shapes_scales_and_seed():
    cfg = port_reduced("gemma2-9b")
    a = TT.init_params(cfg, seed=7, device="cpu")
    b = TT.init_params(cfg, seed=7, device="cpu")
    ref = jax.tree.map(np.asarray, JT.init_params(get_reduced("gemma2-9b"),
                                                  jax.random.PRNGKey(0)))
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
    for i, tree in enumerate(interop.reference_layers(cfg, ref)):
        for name, prm in a.layers[i].named_parameters():
            leaf = tree
            for key in name.split("."):
                leaf = leaf[key]
            assert prm.dtype == torch.float32
            if leaf.size > 64:     # a random draw at the reference's scale
                np.testing.assert_allclose(float(prm.std()),
                                           float(leaf.std()), rtol=0.2)
            else:                  # norm scales: zeros
                assert not prm.any()
