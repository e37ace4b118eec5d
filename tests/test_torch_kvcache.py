"""The port's serving caches against the JAX package on the CPU: the ragged
``kv_len`` mask, per-sequence ring and scatter writes, per-sequence ``pos``
and ``prompt_len`` in ``step_with_cache``, and the int8 KV cache.

Inputs are drawn with numpy from a seed; model weights come from the
reference's ``init_params`` (``interop.params_from_reference``).
Tolerances: cache writes, masks, ring ``pos`` arrays and int8 values
exactly (they are copies and integer arithmetic); float32 logits and
cache values within atol 1e-5 (summation order, as tests/test_torch_serve.py);
scales within 1e-6 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as JA
from repro.configs import get_reduced
from repro.models import transformer as JT
import repro_torch.models.attention as TA
from repro_torch import interop
from repro_torch.configs import get_reduced as port_reduced
from repro_torch.models import transformer as TT


def t(a):
    return torch.as_tensor(np.array(a))


def j(x):
    return jnp.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def ring(rng, B, W, KH=2, hd=4, filled=True):
    """A ring cache as numpy: random keys/values, positions of an earlier
    occupant (or -1 = empty)."""
    k = rng.normal(size=(B, W, KH, hd)).astype(np.float32)
    v = rng.normal(size=(B, W, KH, hd)).astype(np.float32)
    pos = (rng.integers(0, 50, (B, W)) if filled
           else np.full((B, W), -1)).astype(np.int32)
    return {"k": k, "v": v, "pos": pos}


def port_cache(c):
    return {key: t(val) for key, val in c.items()}


def jax_cache(c):
    return {key: jnp.asarray(val) for key, val in c.items()}


def assert_same_cache(want, got):
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)


# ---------------------------------------------------------------------------
# the mask and the writes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 3), (False, 0)])
@pytest.mark.parametrize("kv_shape", [None, (3,), (3, 1)])
def test_mask_bias_with_kv_len(rng, causal, window, kv_shape):
    B, Q, S = 3, 5, 7
    q_pos = rng.integers(0, 8, (B, Q))
    k_pos = rng.integers(-1, 8, (B, S))
    kv_len = None if kv_shape is None else \
        rng.integers(1, 8, kv_shape).astype(np.int32)
    want = JA._mask_bias(j(q_pos), j(k_pos), causal=causal, window=window,
                         kv_len=None if kv_len is None else j(kv_len))
    got = TA._mask_bias(t(q_pos), t(k_pos), causal=causal, window=window,
                        kv_len=None if kv_len is None else t(kv_len))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("S_new,lens", [
    (5, [5, 3, 1]),          # S_new < W: short prompts, pads dropped
    (8, [8, 2, 6]),          # S_new == W
    (13, [13, 9, 4]),        # S_new > W: only [L - W, L) lands
    (20, [20, 8, 17]),       # a ring wrapped more than twice by the pads
])
@pytest.mark.parametrize("offset", [0, 3])
def test_ring_write_ragged_prefill(rng, S_new, lens, offset):
    B, W = 3, 8
    c = ring(rng, B, W, filled=offset > 0)
    k = rng.normal(size=(B, S_new, 2, 4)).astype(np.float32)
    v = rng.normal(size=(B, S_new, 2, 4)).astype(np.float32)
    positions = offset + np.broadcast_to(np.arange(S_new), (B, S_new))
    kv_len = np.asarray(lens, np.int32) + offset
    want = JA._ring_write(jax_cache(c), j(k), j(v), j(positions),
                          kv_len=j(kv_len))
    got = TA._ring_write(port_cache(c), t(k), t(v), t(positions),
                         kv_len=t(kv_len))
    assert_same_cache(dict(zip(("k", "v", "pos"), want)), got)
    if offset == 0:
        # into an empty ring: no pad (position >= its row's length) lands
        assert (got["pos"].numpy() < kv_len[:, None]).all()


def test_ring_write_per_sequence_decode(rng):
    B, W = 4, 8
    c = ring(rng, B, W)
    k = rng.normal(size=(B, 1, 2, 4)).astype(np.float32)
    v = rng.normal(size=(B, 1, 2, 4)).astype(np.float32)
    positions = np.asarray([[3], [8], [17], [0]])
    want = JA._ring_write(jax_cache(c), j(k), j(v), j(positions),
                          ragged=True)
    got = TA._ring_write(port_cache(c), t(k), t(v), t(positions),
                         ragged=True)
    assert_same_cache(dict(zip(("k", "v", "pos"), want)), got)
    with pytest.raises(ValueError, match="decode-only"):
        TA._ring_write(port_cache(c), t(k).expand(B, 2, 2, 4),
                       t(v).expand(B, 2, 2, 4),
                       t(positions).expand(B, 2), ragged=True)


@pytest.mark.parametrize("S_new", [1, 3])
@pytest.mark.parametrize("pos", [[[2], [0], [9], [-4]], [[5]], 4, -3, [[-12]]])
def test_scatter_cache_per_row_clamp(rng, S_new, pos):
    """(B, 1) positions write each row at its own start; a start past the
    end clamps per row, and a negative one counts from the end first, as
    ``dynamic_update_slice`` places it."""
    B, S = 4, 10
    cache = rng.normal(size=(B, S, 2, 3)).astype(np.float32)
    new = rng.normal(size=(B, S_new, 2, 3)).astype(np.float32)
    jpos = jnp.full((1, 1), pos, jnp.int32) if isinstance(pos, int) \
        else jnp.asarray(pos, jnp.int32)
    want = JA._scatter_cache(jnp.asarray(cache), jnp.asarray(new), jpos)
    got = TA._scatter_cache(t(cache), t(new),
                            pos if isinstance(pos, int)
                            else torch.as_tensor(pos, dtype=torch.int32))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the int8 cache
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_and_dequantize_exactly(rng, dtype):
    x = rng.normal(size=(2, 16, 4, 32)).astype(np.float32) * 3.0
    x[0, 0, 0] = 0.0                          # an all-zero row: the floor
    x[1, 2, 1, :4] = [0.5, -0.5, 1.5, 2.5]    # ties, rounded to even
    jx = jnp.asarray(x).astype(dtype)
    px = t(x).to(getattr(torch, dtype))
    q_want, s_want = JA._quantize_kv(jx)
    q_got, s_got = TA._quantize_kv(px)
    assert q_got.dtype == torch.int8 and s_got.dtype == torch.float32
    np.testing.assert_array_equal(q_got.numpy(), np.asarray(q_want))
    np.testing.assert_allclose(s_got.numpy(), np.asarray(s_want), rtol=1e-6,
                               atol=0)
    assert float(s_got.min()) >= 1e-10
    back_want = JA._dequantize_kv(q_want, s_want, jnp.float32)
    back = TA._dequantize_kv(q_got, s_got, torch.float32)
    np.testing.assert_allclose(back.numpy(), np.asarray(back_want),
                               rtol=1e-6, atol=0)
    # within half a quantisation step (the reference's own bound)
    rel = float((back - px.float()).abs().max() / px.float().abs().max())
    assert rel < 0.01


def test_init_cache_quant_layout():
    """int8 k/v and float32 scales (B, S, KH) on full layers; ring layers
    keep the model dtype, as the reference's ``init_cache(quant=True)``."""
    cfg = get_reduced("gemma2-9b")
    want = JT.init_cache(cfg, 2, 16, jnp.float32, quant=True)
    got = TT.init_cache(port_reduced("gemma2-9b"), 2, 16, torch.float32,
                        quant=True, device="cpu")
    conv = interop.caches_from_reference(
        cfg, jax.tree.map(np.asarray, want), device="cpu")
    assert len(conv) == len(got)
    for w, g in zip(conv, got):
        assert sorted(w) == sorted(g)
        for key in w:
            assert w[key].dtype == g[key].dtype and \
                w[key].shape == g[key].shape, key
            assert torch.equal(w[key], g[key])
    assert got[1]["k"].dtype == torch.int8
    assert got[1]["k_scale"].shape == (2, 16, 2) or \
        got[1]["k_scale"].shape[:2] == (2, 16)
    assert "pos" in got[0] and got[0]["k"].dtype == torch.float32


# ---------------------------------------------------------------------------
# step_with_cache: per-sequence positions and prompt lengths
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=["gemma2-9b", "qwen3-1.7b"])
def served(request):
    arch = request.param
    cfg = get_reduced(arch)
    params = JT.init_params(cfg, jax.random.PRNGKey(0))
    model = interop.params_from_reference(
        port_reduced(arch), jax.tree.map(np.asarray, params), device="cpu")
    return arch, cfg, params, model


def assert_caches_close(cfg, jax_caches, port_caches):
    want = interop.caches_from_reference(
        cfg, jax.tree.map(np.asarray, jax_caches), device="cpu")
    for w, g in zip(want, port_caches):
        assert sorted(w) == sorted(g)
        for key in w:
            assert w[key].dtype == g[key].dtype, key
            if w[key].dtype in (torch.int32, torch.int8):
                assert torch.equal(w[key], g[key]), key
            else:
                torch.testing.assert_close(g[key], w[key], rtol=1e-6,
                                           atol=1e-5)


def test_ragged_prefill_then_per_sequence_decode(served, rng):
    """A right-padded prefill under ``prompt_len`` (lengths straddling
    gemma2's window 8, so rings drop pads and wrap), then decode steps
    with a (B, 1) ``pos``: each row at its own depth."""
    arch, cfg, params, model = served
    B, S0, max_seq = 3, 12, 20
    lens = np.asarray([12, 5, 9], np.int32)
    prompt = rng.integers(2, cfg.vocab_size, (B, S0))
    jc = JT.init_cache(cfg, B, max_seq, jnp.float32)
    pc = TT.init_cache(port_reduced(arch), B, max_seq, torch.float32,
                       device="cpu")
    want, jc = JT.step_with_cache(cfg, params, jc, jnp.asarray(prompt), 0,
                                  prompt_len=jnp.asarray(lens))
    got, pc = TT.step_with_cache(port_reduced(arch), model, pc, t(prompt), 0,
                                 prompt_len=t(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert_caches_close(cfg, jc, pc)
    pos = lens[:, None].astype(np.int32)
    for _ in range(4):
        tok = rng.integers(2, cfg.vocab_size, (B, 1))
        want, jc = JT.decode_step(cfg, params, jc, jnp.asarray(tok),
                                  jnp.asarray(pos))
        got, pc = TT.decode_step(port_reduced(arch), model, pc, t(tok),
                                 t(pos))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
        assert_caches_close(cfg, jc, pc)
        pos = pos + 1


def test_tensor_pos_equals_int_pos(served, rng):
    """A 0-d tensor ``pos`` takes the device path and writes what the int
    does; a (B, 1) ``pos`` with every row alike does too."""
    arch, cfg, params, model = served
    pcfg = port_reduced(arch)
    B = 2
    prompt = t(rng.integers(2, cfg.vocab_size, (B, 6)))
    tok = t(rng.integers(2, cfg.vocab_size, (B, 1)))
    outs = []
    for pos in (6, torch.tensor(6), torch.full((B, 1), 6)):
        c = TT.init_cache(pcfg, B, 16, torch.float32, device="cpu")
        TT.step_with_cache(pcfg, model, c, prompt, 0)
        lg, c = TT.decode_step(pcfg, model, c, tok, pos)
        outs.append((lg, c))
    for lg, c in outs[1:]:
        torch.testing.assert_close(lg, outs[0][0], rtol=0, atol=1e-6)
        for a, b in zip(c, outs[0][1]):
            for key in a:
                torch.testing.assert_close(a[key], b[key], rtol=0,
                                           atol=1e-6)


def test_per_sequence_pos_refused_with_abs_positions():
    cfg = port_reduced("whisper-base")
    with pytest.raises(ValueError, match="absolute position"):
        TT.step_with_cache(cfg, None, None, torch.zeros((2, 1), dtype=int),
                           torch.zeros((2, 1), dtype=int))


@pytest.mark.parametrize("arch", ["yi-9b", "gemma2-9b"])
def test_int8_step_with_cache_matches_jax(arch, rng):
    """Prefill and decode on the int8 cache: the reference's logits and
    the int8 values it wrote.  A K/V value whose scaled float lies at a
    rounding tie lands one int8 step apart when the two float pipelines
    differ in its last bit (measured: one value in yi-9b's cache at step
    16, moving the logits by 9e-4 and by 1.7e-3 three steps on); the
    prefill, before any such value, is held within 1e-5."""
    cfg = get_reduced(arch)
    params = JT.init_params(cfg, jax.random.PRNGKey(0))
    model = interop.params_from_reference(
        port_reduced(arch), jax.tree.map(np.asarray, params), device="cpu")
    B, S = 2, 20
    tokens = rng.integers(0, cfg.vocab_size, (B, S))
    jc = JT.init_cache(cfg, B, S, jnp.float32, quant=True)
    pc = TT.init_cache(port_reduced(arch), B, S, torch.float32, quant=True,
                       device="cpu")
    want, jc = JT.step_with_cache(cfg, params, jc,
                                  jnp.asarray(tokens[:, :12]), 0)
    got, pc = TT.step_with_cache(port_reduced(arch), model, pc,
                                 t(tokens[:, :12]), 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    for s in range(12, S):
        want, jc = JT.decode_step(cfg, params, jc,
                                  jnp.asarray(tokens[:, s:s + 1]), s)
        got, pc = TT.decode_step(port_reduced(arch), model, pc,
                                 t(tokens[:, s:s + 1]), s)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-3)
    conv = interop.caches_from_reference(
        cfg, jax.tree.map(np.asarray, jc), device="cpu")
    for w, g in zip(conv, pc):
        for key in w:
            if w[key].dtype == torch.int8:
                # a value at a rounding tie may land one step apart when
                # the two float pipelines differ in the last bit
                assert (w[key].int() - g[key].int()).abs().max() <= 1, key
                assert (w[key] != g[key]).float().mean() < 1e-3, key
            else:
                torch.testing.assert_close(g[key], w[key], rtol=1e-5,
                                           atol=1e-5)


# ---------------------------------------------------------------------------
# the reference's own cache tests, on the port
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def yi():
    cfg = get_reduced("yi-9b")
    params = JT.init_params(cfg, jax.random.PRNGKey(0))
    return port_reduced("yi-9b"), interop.params_from_reference(
        port_reduced("yi-9b"), jax.tree.map(np.asarray, params),
        device="cpu")


def test_int8_decode_tracks_forward_within_quant_tolerance(yi, rng):
    """``TestInt8KVCache``: bounded absolute logit error and near-perfect
    logit correlation against the scoring forward."""
    cfg, model = yi
    S = 24
    tokens = t(rng.integers(0, cfg.vocab_size, (2, S)))
    full, _ = TT.forward(cfg, model, {"tokens": tokens}, device="cpu")
    caches = TT.init_cache(cfg, 2, S, torch.float32, quant=True,
                           device="cpu")
    assert caches[0]["k"].dtype == torch.int8
    lg, caches = TT.step_with_cache(cfg, model, caches, tokens[:, :8], 0)
    errs = [float((lg - full[:, :8]).abs().max())]
    corr = []
    for s in range(8, S):
        lg, caches = TT.decode_step(cfg, model, caches, tokens[:, s:s + 1],
                                    s)
        errs.append(float((lg[:, 0] - full[:, s]).abs().max()))
        corr.append(float(np.corrcoef(lg[:, 0].numpy().ravel(),
                                      full[:, s].numpy().ravel())[0, 1]))
    assert max(errs) < 0.15, max(errs)
    assert min(corr) > 0.995, min(corr)


@pytest.fixture(scope="module")
def gemma():
    cfg = get_reduced("gemma2-9b")
    params = JT.init_params(cfg, jax.random.PRNGKey(0))
    return port_reduced("gemma2-9b"), interop.params_from_reference(
        port_reduced("gemma2-9b"), jax.tree.map(np.asarray, params),
        device="cpu")


@pytest.mark.parametrize("prefill", [4, 20])
def test_ring_decode_past_window_tracks_forward(gemma, rng, prefill):
    """``TestRingCache``: decode far beyond the window (5 revolutions), from
    a short prefill and from one longer than the window."""
    cfg, model = gemma
    S = 40
    tokens = t(rng.integers(0, cfg.vocab_size, (2, S)))
    full, _ = TT.forward(cfg, model, {"tokens": tokens}, device="cpu")
    caches = TT.init_cache(cfg, 2, S, torch.float32, device="cpu")
    assert caches[0]["k"].shape[1] == cfg.sliding_window
    lg, caches = TT.step_with_cache(cfg, model, caches, tokens[:, :prefill],
                                    0)
    torch.testing.assert_close(lg[:, -1], full[:, prefill - 1], rtol=0,
                               atol=2e-3)
    for s in range(prefill, S):
        lg, caches = TT.decode_step(cfg, model, caches, tokens[:, s:s + 1],
                                    s)
        torch.testing.assert_close(lg[:, 0], full[:, s], rtol=0, atol=2e-3)


@pytest.mark.parametrize("pos", [5, 70])
def test_tensor_pos_reads_the_position_table_as_the_int(pos):
    """With absolute positions (whisper), a 0-d tensor ``pos`` gathers the
    table's rows on the device, clamped as the int's slice is (row 70 of a
    64-row table takes the last row)."""
    cfg = port_reduced("whisper-base")
    model = TT.init_params(cfg, seed=0, max_position=64, device="cpu")
    g = torch.Generator().manual_seed(3)
    enc = TT.encode(cfg, model, torch.randn(
        (2, 12, cfg.d_model), generator=g), device="cpu")
    cross = TT.prefill_cross_caches(cfg, model, enc)
    tok = torch.randint(2, cfg.vocab_size, (2, 1), generator=g)
    outs = []
    for p in (pos, torch.tensor(pos)):
        c = TT.init_cache(cfg, 2, 80, torch.float32, device="cpu")
        lg, c = TT.decode_step(cfg, model, c, tok, p, enc_out=enc,
                               cross_caches=cross)
        outs.append((lg, c))
    torch.testing.assert_close(outs[1][0], outs[0][0], rtol=0, atol=0)
    for a, b in zip(outs[1][1], outs[0][1]):
        for key in a:
            assert torch.equal(a[key], b[key]), key
