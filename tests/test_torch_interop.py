"""State carried across from the JAX package to the port
(``repro_torch.interop``): N sweeps in JAX, the frame or loop result carried
over, M sweeps in the port ≡ N+M sweeps in JAX."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import pattern as JP  # noqa: E402
from repro.core.executor import StencilEngine as JEngine  # noqa: E402
from repro.kernels import ref as JR  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import frames as TF  # noqa: E402
from repro_torch.core import pattern as TP  # noqa: E402
from repro_torch.kernels import ref as TR  # noqa: E402
from repro_torch.kernels.stencil2d import stencil2d_fused_framed  # noqa: E402,E501

N, M = 3, 4


def field(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def jax_sweeps(a, f, boundary, iters, env=()):
    return JP.LoopOfStencilReduce(
        f=f, k=1, combine="max", cond=lambda r: False, delta=JR.abs_delta,
        boundary=boundary, max_iters=iters).run(
        jnp.asarray(a), env=tuple(map(jnp.asarray, env)))


@pytest.mark.parametrize("boundary", ["zero", "reflect", "wrap"])
def test_frame_carried_across(boundary):
    a, fxy = field(0, (48, 64)), field(1, (48, 64))
    jf = JR.helmholtz_jacobi_taps(2.0, 0.2)
    eng = JEngine(f=jf, k=1, boundary=boundary, combine="max",
                  delta=JR.abs_delta, unroll=N, backend="pallas",
                  interpret=True)
    jframe, jenv, jspec = eng.prepare(jnp.asarray(a), (jnp.asarray(fxy),))
    jframe, _ = eng.sweeps(jframe, jenv, jspec)

    spec = TF.frame_spec(48, 64, k=1)
    frame = interop.frame_from_numpy(
        np.asarray(jframe), m=48, n=64, pad=jspec.pad, boundary=boundary,
        spec=spec, device="cpu")
    env = (TF.frame_env(torch.as_tensor(fxy), spec, boundary),)
    tf = interop.elemental_from_reference("helmholtz_jacobi_taps",
                                          alpha=2.0, dx=0.2)
    other = torch.zeros_like(frame)
    for _ in range(M):
        frame, other = stencil2d_fused_framed(
            frame, tf, spec, env_framed=env, combine="max",
            measure=TR.abs_delta, out=other)[0], frame
        TF.refresh_frame(frame, spec, boundary)

    want = jax_sweeps(a, jf, boundary, N + M, env=(fxy,))
    np.testing.assert_allclose(TF.unframe(frame, spec).numpy(),
                               np.asarray(want.a), atol=1e-5, rtol=0)


def test_loop_result_carried_across():
    a = field(2, (40, 56))
    jres = jax_sweeps(a, JR.heat_taps(0.1), "wrap", N)
    res = interop.loop_result_from_numpy(
        np.asarray(jres.a), np.asarray(jres.reduced), np.asarray(jres.iters),
        np.asarray(jres.health), device="cpu")
    assert int(res.iters) == N and res.iters.dtype == torch.int32
    assert res.health.dtype == torch.int32
    tres = TP.LoopOfStencilReduce(
        f=TR.heat_taps(0.1), k=1, combine="max", cond=lambda r: False,
        delta=TR.abs_delta, boundary="wrap", max_iters=M,
        device="cpu").run(res.a)
    want = jax_sweeps(a, JR.heat_taps(0.1), "wrap", N + M)
    np.testing.assert_allclose(tres.a.numpy(), np.asarray(want.a),
                               atol=1e-5, rtol=0)
    assert float(tres.reduced) == pytest.approx(float(want.reduced),
                                                rel=1e-5)


def test_elemental_from_reference_names():
    assert interop.elemental_from_reference("abs_delta") is TR.abs_delta
    mask, repl = interop.elemental_from_reference("amf_detect_taps", kmax=2)
    assert (mask.functor, repl.functor, mask.k) == ("amf_mask", "amf_repl",
                                                    2)
    for name, kw, functor in [
            ("jacobi_taps", {}, "jacobi"), ("sobel_taps", {}, "sobel"),
            ("gol_taps", {}, "gol"), ("median3_taps", {}, "median3"),
            ("restore_taps", {"beta": 1.5}, "restore"),
            ("heat_taps", {"nu": 0.2}, "heat"),
            ("conv_taps", {"weights": np.ones((5, 5))}, "conv")]:
        el = interop.elemental_from_reference(name, **kw)
        assert isinstance(el, TR.Elemental) and el.functor == functor
    with pytest.raises(ValueError, match="no port counterpart"):
        interop.elemental_from_reference("swa_attention")
    with pytest.raises(ValueError, match="holds no"):
        interop.frame_from_numpy(np.zeros((10, 10)), m=48, n=64, pad=1,
                                 boundary="zero",
                                 spec=TF.frame_spec(48, 64), device="cpu")
