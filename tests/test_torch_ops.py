"""Port parity: the §4 apps (``repro_torch.kernels.ops``) against the JAX
apps (``repro.kernels.ops``) on the ``"jnp"`` and ``"pallas"`` backends —
the slice as a whole, on the CPU."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels import ops as JO  # noqa: E402
from repro.kernels import ref as JR  # noqa: E402
from repro_torch.kernels import ops as TO  # noqa: E402
from repro_torch.kernels import ref as TR  # noqa: E402


def noisy_frame(seed, shape):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]]
    clean = np.clip(0.5 + 0.3 * np.sin(xx / 20.0) * np.cos(yy / 15.0),
                    0, 1).astype(np.float32)
    imp = rng.uniform(size=shape) < 0.3
    sp = np.where(rng.uniform(size=shape) < 0.5, 0.0, 1.0)
    return clean, imp, np.where(imp, sp, clean).astype(np.float32)


def close(t, j, atol=1e-5):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), atol=atol,
                               rtol=0)


@pytest.mark.parametrize("shape,jbackend", [((48, 64), "jnp"),
                                            ((100, 130), "jnp"),
                                            ((48, 64), "pallas")])
def test_jacobi_solve(shape, jbackend):
    rng = np.random.default_rng(0)
    u0 = np.zeros(shape, np.float32)
    fx = rng.normal(size=shape).astype(np.float32)
    kw = dict(alpha=2.0, dx=0.2, tol=1e-5, max_iters=800)
    ju, jd, ji = JO.jacobi_solve(jnp.asarray(u0), jnp.asarray(fx),
                                 backend=jbackend, **kw)
    tu, td, ti = TO.jacobi_solve(u0, fx, device="cpu", **kw)
    assert int(ti) == int(ji) < 800
    close(tu, ju)
    # max|Δu| at convergence is a difference of two f32 iterates that agree
    # to a few ulps (XLA contracts multiply-adds inside its jitted loop; the
    # port does not): cancellation makes that an absolute error
    assert float(td) == pytest.approx(float(jd), rel=1e-5, abs=1e-7)


@pytest.mark.parametrize("shape", [(96, 160), (100, 130)])
def test_sobel(shape):
    img = np.random.default_rng(1).uniform(size=shape).astype(np.float32)
    je, jm = JO.sobel(jnp.asarray(img))
    te, tm = TO.sobel(img, device="cpu")
    close(te, je)
    assert float(tm) == pytest.approx(float(jm), rel=1e-5)


@pytest.mark.parametrize("shape", [(48, 64), (100, 130)])
def test_adaptive_median_detect_and_restore(shape):
    _, _, noisy = noisy_frame(2, shape)
    jm, jr = JO.adaptive_median_detect(jnp.asarray(noisy))
    tm, tr = TO.adaptive_median_detect(noisy, device="cpu")
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))   # exact
    close(tr, jr)
    jo, jd, ji = JO.restore(jr, jm, max_iters=60)
    to, td, ti = TO.restore(tr, tm, max_iters=60, device="cpu")
    assert int(ti) == int(ji)
    close(to, jo)
    assert float(td) == pytest.approx(float(jd), rel=1e-5, abs=1e-7)


def test_restoration_pipeline_against_pallas():
    clean, imp, noisy = noisy_frame(3, (96, 160))
    jm, jr = JO.adaptive_median_detect(jnp.asarray(noisy), use_pallas=True)
    jo, _, ji = JO.restore(jr, jm, max_iters=60, use_pallas=True)
    tm, tr = TO.adaptive_median_detect(noisy, device="cpu")
    to, _, ti = TO.restore(tr, tm, max_iters=60, device="cpu")
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert int(ti) == int(ji)
    close(to, jo)

    def psnr(x):
        return -10 * np.log10(np.mean((np.asarray(x) - clean) ** 2) + 1e-12)
    assert psnr(to) > psnr(noisy) + 10.0
    assert (tm.numpy()[imp] > 0).mean() > 0.95


def test_fused_sweep_and_backend_axis():
    a = np.random.default_rng(4).normal(size=(40, 72)).astype(np.float32)
    jn, jr = JO.fused_sweep(jnp.asarray(a), JR.heat_taps(0.1), k=1,
                            combine="max", measure=JR.abs_delta,
                            boundary="wrap", backend="jnp", unroll=3)
    tn, tr = TO.fused_sweep(a, TR.heat_taps(0.1), k=1, combine="max",
                            measure=TR.abs_delta, boundary="wrap",
                            use_kernel=False, unroll=3, device="cpu")
    close(tn, jn)
    assert float(tr) == pytest.approx(float(jr), rel=1e-5)
    # fused_sweep defaults to the kernel, as the reference defaults to
    # Pallas: on CPU tensors that is refused, never run on the plain path
    with pytest.raises(ValueError, match="CUDA device"):
        TO.fused_sweep(a, TR.heat_taps(0.1), device="cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        TO.sobel(a, use_kernel=True, device="cpu")
    # part= selects the sharded deployment, a kernel backend: a mesh of
    # CPU devices is refused like a CPU tensor, and a conflicting
    # single-device backend is refused with the reference's message
    from repro_torch.sharding import GridPartition, make_mesh
    part = GridPartition(make_mesh((2,), ("data",), devices=["cpu"] * 2),
                         ("data",), (0,))
    with pytest.raises(ValueError, match="CUDA device"):
        TO.jacobi_solve(a, a, part=part)
    with pytest.raises(ValueError, match="CUDA device"):
        TO.restore(a, a, part=part)
    with pytest.raises(ValueError, match="part= selects the sharded"):
        TO.jacobi_solve(a, a, part=part, backend="torch")
    assert isinstance(TO.sobel(torch.as_tensor(a), device="cpu")[0],
                      torch.Tensor)
