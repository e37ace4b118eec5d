"""Port parity: ``repro_torch.core.pattern.LoopOfStencilReduce`` and the
persistent-frame engine against the JAX pattern on its ``"jnp"`` and
``"pallas"`` (interpret mode) backends.  ``iters`` and health words are
compared exactly, grids within atol 1e-5, reduces within rtol 1e-5."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import pattern as JP  # noqa: E402
from repro.core import reduce as JRd  # noqa: E402
from repro.core.executor import check_unroll_feasible as j_check  # noqa: E402,E501
from repro_torch.core import executor as TE  # noqa: E402
from repro_torch.core import pattern as TP  # noqa: E402
from repro_torch.core import reduce as TRd  # noqa: E402
from repro_torch.kernels import ref as TR  # noqa: E402


def field(seed, shape=(24, 24)):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def jac(get):
    return 0.25 * (get(-1, 0) + get(1, 0) + get(0, -1) + get(0, 1))


def damped(get):
    return 0.5 * get(0, 0) + 0.125 * (get(-1, 0) + get(1, 0) + get(0, -1)
                                      + get(0, 1))


def absdelta(new, old):
    return abs(new - old)


def both(a, jkw=None, tkw=None, env=(), **kw):
    """Run the JAX pattern and the port on the same numpy inputs."""
    jres = JP.LoopOfStencilReduce(**kw, **(jkw or {})).run(
        jnp.asarray(a), env=tuple(map(jnp.asarray, env)))
    tres = TP.LoopOfStencilReduce(**kw, device="cpu", **(tkw or {})).run(
        a, env=env)
    return jres, tres


def assert_results(jres, tres, atol=1e-5):
    assert int(tres.iters) == int(jres.iters)
    assert int(tres.health) == int(jres.health)
    np.testing.assert_allclose(np.asarray(tres.a), np.asarray(jres.a),
                               atol=atol, rtol=0, equal_nan=True)
    if tres.reduced.dtype == torch.bool:
        assert bool(tres.reduced) == bool(jres.reduced)
    else:
        np.testing.assert_allclose(float(tres.reduced), float(jres.reduced),
                                   rtol=1e-5, atol=1e-7, equal_nan=True)


@pytest.mark.parametrize("iters", [1, 7])
def test_base_variant_fixed_iterations(iters):
    jres, tres = both(field(1), f=jac, k=1, combine="max",
                      cond=lambda r: False, max_iters=iters)
    assert int(tres.iters) == iters
    assert_results(jres, tres)


@pytest.mark.parametrize("boundary", ["zero", "reflect", "wrap"])
def test_d_variant_converges_with_equal_iters(boundary):
    jres, tres = both(field(2, (16, 20)), f=damped, k=1, combine="max",
                      cond=lambda r: r < 1e-3, delta=absdelta,
                      boundary=boundary, max_iters=500)
    assert int(tres.iters) < 500
    assert_results(jres, tres)


@pytest.mark.parametrize("unroll", [3, "auto"])
def test_unroll(unroll):
    jres, tres = both(field(3, (16, 16)), f=jac, k=1, combine="max",
                      cond=lambda r: r < 1e-3, delta=absdelta,
                      max_iters=500, unroll=unroll)
    assert_results(jres, tres)


def test_s_variant_state_controls_termination():
    jres, tres = both(
        field(4), f=jac, k=1, combine="sum", cond=lambda r, s: s >= 9,
        jkw=dict(state_init=lambda: jnp.asarray(0, jnp.int32)),
        tkw=dict(state_init=lambda: torch.tensor(0, dtype=torch.int32)),
        state_update=lambda s, a, it: s + 1)
    assert int(tres.iters) == int(tres.state) == 9 == int(jres.state)
    assert_results(jres, tres, atol=1e-4)


def test_indexed_and_windows_modes():
    def f_idx(w, idx):
        rows = idx[..., 0]
        return (w * (rows % 2 == 0)).sum(-1).sum(-1) * 0.1

    jres, tres = both(field(5, (12, 10)), f=f_idx, k=1, combine="sum",
                      cond=lambda r: False, mode="indexed", max_iters=3)
    assert_results(jres, tres)

    def f_win(w):
        return 0.25 * (w[..., 0, 1] + w[..., 2, 1] + w[..., 1, 0]
                       + w[..., 1, 2])
    jres, tres = both(field(6, (12, 10)), f=f_win, k=1, combine="max",
                      cond=lambda r: r < 1e-3, delta=absdelta,
                      mode="windows", boundary="wrap", max_iters=300)
    assert_results(jres, tres)


def test_step_mode_with_measure():
    jres, tres = both(field(7, (5, 6)), f=lambda a: 0.5 * a, k=0,
                      combine="max", cond=lambda r: r < 1e-2,
                      measure=lambda a: abs(a), mode="step", max_iters=50)
    assert_results(jres, tres)


def test_sentinel_poison_and_divergence_health_words():
    # NaN boundary with a max measure poisons the first check
    jres, tres = both(field(8, (10, 10)), f=jac, k=1, combine="max",
                      cond=lambda r: r < 1e-3, delta=absdelta,
                      boundary="nan", max_iters=50,
                      jkw=dict(sentinel=JRd.Sentinel(nan=True)),
                      tkw=dict(sentinel=TRd.Sentinel(nan=True)))
    assert TRd.health_status(tres.health) == "poisoned"
    assert_results(jres, tres)
    # a growing iterate never decreases its measure: diverged after 3
    grow = lambda get: 1.5 * get(0, 0)  # noqa: E731
    jres, tres = both(field(9, (10, 10)), f=grow, k=1, combine="max",
                      cond=lambda r: r < 1e-3, delta=absdelta,
                      max_iters=50,
                      jkw=dict(sentinel=JRd.Sentinel(nan=False, patience=3)),
                      tkw=dict(sentinel=TRd.Sentinel(nan=False,
                                                     patience=3)))
    assert TRd.health_status(tres.health) == "nonconverged"
    assert int(tres.iters) == 4
    assert_results(jres, tres, atol=1e-3)


def test_persistent_frame_loop_matches_pallas_backend():
    """The "cuda" loop body (persistent frame, ping-pong buffers, ghost
    refresh) driven on the CPU through the kernel wrapper's plain version,
    against the JAX persistent-frame loop on "pallas" (interpret mode)."""
    a = field(10, (100, 130))
    fxy = field(11, (100, 130))
    kw = dict(k=1, combine="max", cond=lambda r: r < 1e-4,
              boundary="reflect", max_iters=60, unroll=2)
    jres = JP.LoopOfStencilReduce(
        f=lambda get, e: jac(get) + 0.01 * e, delta=absdelta,
        backend="pallas", interpret=True, **kw).run(
        jnp.asarray(a), env=(jnp.asarray(fxy),))
    loop = TP.LoopOfStencilReduce(
        f=lambda get, e: jac(get) + 0.01 * e, delta=TR.abs_delta,
        device="cpu", backend="torch", **kw)
    tres = loop._run_persistent(torch.as_tensor(a), None,
                                (torch.as_tensor(fxy),))
    assert_results(jres, tres)


def test_engine_ping_pongs_two_buffers():
    eng = TE.StencilEngine(f=TR.heat_taps(0.1), k=1, boundary="wrap",
                           combine="max", delta=TR.abs_delta, unroll=3)
    frame, env, spec = eng.prepare(torch.as_tensor(field(12, (40, 50))))
    bufs = eng._buffers
    seen = set()
    for _ in range(4):
        frame, red = eng.sweeps(frame, env, spec)
        assert any(frame is b for b in bufs)
        seen.add(id(frame))
    assert seen == {id(b) for b in bufs}
    with pytest.raises(ValueError, match="staged by prepare"):
        eng.sweeps(frame.clone(), env, spec)
    # 12 heat sweeps on the frame ≡ 12 sweeps of the shift algebra
    want = TP.LoopOfStencilReduce(
        f=TR.heat_taps(0.1), boundary="wrap", combine="max",
        cond=lambda r: False, max_iters=12, device="cpu").run(
        field(12, (40, 50)))
    torch.testing.assert_close(eng.unframe(frame, spec), want.a, rtol=0,
                               atol=1e-5)


def test_validation_matches_reference_contract(monkeypatch):
    with pytest.raises(ValueError, match="termination condition"):
        TP.LoopOfStencilReduce(f=jac, device="cpu")
    with pytest.raises(ValueError, match="unknown mode"):
        TP.LoopOfStencilReduce(f=jac, cond=bool, mode="x", device="cpu")
    with pytest.raises(ValueError, match="unroll must be"):
        TP.LoopOfStencilReduce(f=jac, cond=bool, unroll=0, device="cpu")
    with pytest.raises(ValueError, match="patience"):
        TP.LoopOfStencilReduce(f=jac, cond=bool, device="cpu",
                               sentinel=TRd.Sentinel(patience=1 << 17))
    with pytest.raises(ValueError, match="unknown backend"):
        TP.LoopOfStencilReduce(f=jac, cond=bool, backend="pallas",
                               device="cpu")
    # the sharded backend is ported: it needs a partition, and runs a
    # kernel, so a mesh of CPU devices is refused
    with pytest.raises(ValueError, match="needs a partition="):
        TP.LoopOfStencilReduce(f=jac, cond=bool, backend="cuda-sharded",
                               device="cpu")
    from repro_torch.sharding import GridPartition, make_mesh
    part = GridPartition(make_mesh((2,), ("data",), devices=["cpu"] * 2),
                         ("data",), (0,))
    with pytest.raises(ValueError, match="needs a CUDA device"):
        TP.LoopOfStencilReduce(f=jac, cond=bool, backend="cuda-sharded",
                               partition=part)
    # the temporal-blocking backend is ported: it constructs on a card
    # (a card is pretended here; construction launches nothing)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    loop = TP.LoopOfStencilReduce(f=TR.jacobi_taps(), cond=bool,
                                  backend="cuda-multistep", unroll=4)
    assert (loop.backend, loop.unroll) == ("cuda-multistep", 4)
    with pytest.raises(TypeError, match="measure"):
        TP.LoopOfStencilReduce(f=lambda a: (a, a), cond=bool, mode="step",
                               max_iters=1, device="cpu").run(
            torch.zeros(3))


@pytest.mark.parametrize("m,n,T,k", [(16, 128, 20, 1), (24, 24, 8, 3),
                                     (10, 40, 10, 1)])
def test_check_unroll_feasible_same_error(m, n, T, k):
    with pytest.raises(ValueError) as te:
        TE.check_unroll_feasible(m, n, T, k=k)
    with pytest.raises(ValueError) as je:
        j_check(m, n, T, k=k)
    assert str(te.value) == str(je.value)
    TE.check_unroll_feasible(m, n, 1, k=1)
