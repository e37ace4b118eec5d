"""Port parity: semantics, reduce and stencil modules of ``repro_torch.core``
against their JAX twins in ``repro.core`` (same numpy inputs, CPU)."""
import operator

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import reduce as JRd  # noqa: E402
from repro.core import semantics as JS  # noqa: E402
from repro.core import stencil as JSt  # noqa: E402
from repro_torch.core import reduce as TRd  # noqa: E402
from repro_torch.core import semantics as TS  # noqa: E402
from repro_torch.core import stencil as TSt  # noqa: E402

BOUNDARIES = ["zero", "nan", "reflect", "wrap"]


def field(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def t(x):
    return torch.as_tensor(np.asarray(x))


def assert_same(j, p, atol=0.0):
    np.testing.assert_allclose(np.asarray(p), np.asarray(j), atol=atol,
                               rtol=0, equal_nan=True)


@pytest.mark.parametrize("boundary", BOUNDARIES)
@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("shape", [(7, 9), (12, 5, 6)])
def test_boundary_pad_matches_jnp_pad(boundary, k, shape):
    a = field(k, shape)
    assert_same(JS.Boundary(boundary).pad(jnp.asarray(a), k),
                TS.Boundary(boundary).pad(t(a), k))


@pytest.mark.parametrize("boundary", BOUNDARIES)
def test_boundary_pad_selected_axes(boundary):
    a = field(1, (6, 8, 5))
    assert_same(JS.Boundary(boundary).pad(jnp.asarray(a), 2, axes=(0, 2)),
                TS.Boundary(boundary).pad(t(a), 2, axes=(0, 2)))


@pytest.mark.parametrize("boundary", ["zero", "reflect", "wrap"])
def test_neighborhoods_and_indexed(boundary):
    a = field(2, (9, 11))
    assert_same(JS.neighborhoods(jnp.asarray(a), 2, boundary),
                TS.neighborhoods(t(a), 2, boundary))
    jw, jidx = JS.indexed_neighborhoods(jnp.asarray(a), 1, boundary)
    tw, tidx = TS.indexed_neighborhoods(t(a), 1, boundary)
    assert_same(jw, tw)
    np.testing.assert_array_equal(np.asarray(jidx), tidx.numpy())


@pytest.mark.parametrize("name", ["sum", "max", "min", "prod"])
@pytest.mark.parametrize("n", [1, 100])
def test_tree_and_two_phase_reduce(name, n):
    a = field(n, (n,)) * 0.5 + (1.0 if name == "prod" else 0.0)
    jop, jid = JRd.MONOIDS[name]
    top, tid = TRd.MONOIDS[name]
    jr = JRd.tree_reduce(jop, jnp.asarray(a), jid)
    assert float(TRd.tree_reduce(top, t(a), tid)) == pytest.approx(
        float(jr), rel=1e-5)
    assert float(TRd.two_phase_reduce(top, t(a), tid, tile=8)) == \
        pytest.approx(float(JRd.two_phase_reduce(jop, jnp.asarray(a), jid,
                                                 tile=8)), rel=1e-5)
    assert float(TS.reduce_all(top, t(a), tid)) == pytest.approx(
        float(JS.reduce_all(jop, jnp.asarray(a), jid)), rel=1e-5)


@pytest.mark.parametrize("name", ["any", "all"])
def test_bool_monoids_exact(name):
    a = np.random.default_rng(3).uniform(size=(37,)) < 0.1
    jop, jid = JRd.MONOIDS[name]
    top, tid = TRd.MONOIDS[name]
    assert bool(TRd.tree_reduce(top, t(a), tid)) == \
        bool(JRd.tree_reduce(jop, jnp.asarray(a), jid))


@pytest.mark.parametrize("name", ["max", "min"])
def test_max_min_propagate_nan_like_jnp(name):
    a = field(4, (33,))
    a[17] = np.nan
    jop, jid = JRd.MONOIDS[name]
    top, tid = TRd.MONOIDS[name]
    assert np.isnan(float(JRd.tree_reduce(jop, jnp.asarray(a), jid)))
    assert np.isnan(float(TRd.tree_reduce(top, t(a), tid)))


def test_resolve_monoid():
    assert TRd.resolve_monoid("max", None) is TRd.MONOIDS["max"]
    assert TRd.resolve_monoid(operator.add, 0.0) == (operator.add, 0.0)
    with pytest.raises(ValueError, match="identity required"):
        TRd.resolve_monoid(operator.add, None)
    assert TRd.monoid_name(torch.maximum) == "max"
    assert TRd.monoid_name(operator.sub) is None


# (r_new, r_prev, live, converged, it, sentinel) cases for the health word
HEALTH_CASES = [
    (0.5, 1.0, True, False, 3, None),
    (0.5, 1.0, True, True, 3, None),
    (np.nan, 1.0, True, False, 3, TRd.Sentinel(nan=True)),
    (np.inf, 1.0, False, False, 3, TRd.Sentinel(nan=True)),
    (1.5, 1.0, True, False, 3, TRd.Sentinel(nan=False, patience=2)),
    (1.5, 1.0, True, False, 0, TRd.Sentinel(nan=False, patience=1)),
    (0.5, 1.0, True, False, 3, TRd.Sentinel(patience=2)),
]


@pytest.mark.parametrize("hw0", [0, 1, (1 << 16) | 1])
@pytest.mark.parametrize("case", range(len(HEALTH_CASES)))
def test_health_update_words_equal(hw0, case):
    r_new, r_prev, live, conv, it, sent = HEALTH_CASES[case]
    jsent = None if sent is None else JRd.Sentinel(nan=sent.nan,
                                                   patience=sent.patience)
    jhw, jq = JRd.health_update(
        jnp.asarray([hw0], jnp.int32), jnp.asarray([r_new], jnp.float32),
        jnp.asarray([r_prev], jnp.float32), jnp.asarray([live]),
        jnp.asarray([conv]), jnp.asarray(it), jsent)
    thw, tq = TRd.health_update(
        torch.tensor([hw0], dtype=torch.int32),
        torch.tensor([r_new], dtype=torch.float32),
        torch.tensor([r_prev], dtype=torch.float32), live,
        torch.tensor([conv]), it, sent)
    assert int(thw[0]) == int(jhw[0])
    assert bool(tq[0]) == bool(jq[0])
    assert TRd.health_status(int(thw[0])) == JRd.health_status(int(jhw[0]))
    assert (TRd.HEALTH_STALL_MASK, TRd.HEALTH_CONVERGED,
            TRd.HEALTH_POISONED, TRd.HEALTH_DIVERGED) == (
        JRd.HEALTH_STALL_MASK, JRd.HEALTH_CONVERGED, JRd.HEALTH_POISONED,
        JRd.HEALTH_DIVERGED)


def _jac(get):
    return 0.25 * (get(-1, 0) + get(1, 0) + get(0, -1) + get(0, 1))


@pytest.mark.parametrize("boundary", BOUNDARIES)
def test_stencil_taps_windows_conv(boundary):
    a = field(5, (10, 13))
    assert_same(JSt.stencil_taps(_jac, jnp.asarray(a), 1, boundary),
                TSt.stencil_taps(_jac, t(a), 1, boundary), atol=1e-6)

    def win(w):
        return w.sum(axis=(-1, -2)) if isinstance(w, jnp.ndarray) \
            else w.sum(dim=(-1, -2))
    assert_same(JSt.stencil_windows(win, jnp.asarray(a), 1, boundary),
                TSt.stencil_windows(win, t(a), 1, boundary), atol=1e-5)
    w = field(6, (5, 5))
    assert_same(JSt.conv_taps(jnp.asarray(w))(
        JSt.TapAccessor(jnp.asarray(a), 2, boundary)),
        TSt.conv_taps(t(w))(TSt.TapAccessor(t(a), 2, boundary)), atol=1e-5)


def test_stencil_indexed_and_tap_errors():
    a = field(7, (8, 6))

    def f(w, idx):
        rows = idx[..., 0]
        return (w * (rows % 2 == 0)).sum(-1).sum(-1)
    assert_same(JSt.stencil_indexed(f, jnp.asarray(a), 1),
                TSt.stencil_indexed(f, t(a), 1), atol=1e-5)
    get = TSt.TapAccessor(t(a), 1, "zero")
    with pytest.raises(ValueError, match="radius"):
        get(2, 0)
    with pytest.raises(ValueError, match="offsets"):
        get(1)
    torch.testing.assert_close(get.center, t(a))


def _jac_win(w):
    return 0.25 * (w[..., 0, 1] + w[..., 2, 1] + w[..., 1, 0] + w[..., 1, 2])


def test_formal_reference_interpreters():
    a = field(8, (12, 12))
    ja, jr, jit_ = JS.loop_of_stencil_reduce_ref(
        1, _jac_win, jnp.maximum, lambda r: r < 0.5, jnp.asarray(a),
        identity=-jnp.inf, max_iters=40)
    ta, tr, tit = TS.loop_of_stencil_reduce_ref(
        1, _jac_win, torch.maximum, lambda r: r < 0.5, t(a),
        identity=float("-inf"), max_iters=40)
    assert jit_ == tit
    assert_same(ja, ta, atol=1e-5)
    delta = lambda n, o: abs(n - o)  # noqa: E731
    ja, jr, jit_ = JS.loop_of_stencil_reduce_d_ref(
        1, _jac_win, delta, jnp.maximum, lambda r: r < 1e-3,
        jnp.asarray(a), identity=-jnp.inf, max_iters=500)
    ta, tr, tit = TS.loop_of_stencil_reduce_d_ref(
        1, _jac_win, delta, torch.maximum, lambda r: r < 1e-3, t(a),
        identity=float("-inf"), max_iters=500)
    assert jit_ == tit
    assert_same(ja, ta, atol=1e-5)
    ja, jr, jit_, js = JS.loop_of_stencil_reduce_s_ref(
        1, _jac_win, operator.add, lambda r, s: s >= 5, jnp.asarray(a),
        identity=0.0, init=lambda: 0, update=lambda s: s + 1)
    ta, tr, tit, ts = TS.loop_of_stencil_reduce_s_ref(
        1, _jac_win, operator.add, lambda r, s: s >= 5, t(a),
        identity=0.0, init=lambda: 0, update=lambda s: s + 1)
    assert (jit_, js) == (tit, ts) == (5, 5)
    assert_same(ja, ta, atol=1e-5)
    assert float(tr) == pytest.approx(float(jr), rel=1e-5)
