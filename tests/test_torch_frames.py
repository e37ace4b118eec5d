"""Port parity: persistent halo frames (``repro_torch.core.frames``) against
``Boundary.pad`` and against the JAX ``repro.core.frames``."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import frames as JF  # noqa: E402
from repro_torch.core import frames as TF  # noqa: E402
from repro_torch.core.semantics import Boundary  # noqa: E402

BOUNDARIES = ["zero", "nan", "reflect", "wrap"]


def field(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def ring_and_domain(frame, spec):
    """The domain plus its pad-wide ghost ring (what the contract fixes;
    deep round-up cells are inert)."""
    p = spec.pad
    return np.asarray(frame)[:spec.m + 2 * p, :spec.n + 2 * p]


@pytest.mark.parametrize("boundary", BOUNDARIES)
@pytest.mark.parametrize("pad", [1, 3])
def test_make_frame_is_boundary_pad(boundary, pad):
    """On a block-rounded domain the whole frame equals Boundary.pad."""
    a = torch.as_tensor(field(pad, (32, 64)))
    spec = TF.frame_spec(32, 64, k=1, block=(32, 32), sweeps=pad)
    assert spec.interior == (32, 64)
    np.testing.assert_array_equal(
        TF.make_frame(a, spec, boundary).numpy(),
        Boundary(boundary).pad(a, pad).numpy())


@pytest.mark.parametrize("boundary", BOUNDARIES)
@pytest.mark.parametrize("shape,k", [((48, 64), 1), ((100, 130), 1),
                                     ((100, 130), 3)])
def test_make_frame_matches_reference(boundary, shape, k):
    """Non-multiple domains: domain and ghost ring equal the JAX frame's
    cell for cell, although the two packages tile differently."""
    a = field(k, shape)
    tspec = TF.frame_spec(*shape, k=k)
    jspec = JF.frame_spec(*shape, k=k)
    assert (tspec.m, tspec.n, tspec.pad) == (jspec.m, jspec.n, jspec.pad)
    got = TF.make_frame(torch.as_tensor(a), tspec, boundary)
    want = JF.make_frame(jnp.asarray(a), jspec, boundary)
    np.testing.assert_array_equal(ring_and_domain(got, tspec),
                                  ring_and_domain(want, jspec))
    # and the ring is Boundary.pad's, cell for cell
    np.testing.assert_array_equal(
        ring_and_domain(got, tspec),
        Boundary(boundary).pad(torch.as_tensor(a), k).numpy())


@pytest.mark.parametrize("boundary", BOUNDARIES)
def test_refresh_reasserts_ring_only(boundary):
    a = torch.as_tensor(field(4, (40, 70)))
    spec = TF.frame_spec(40, 70, k=2)
    fresh = TF.make_frame(a, spec, boundary)
    frame = torch.full(spec.shape, 123.0)
    p = spec.pad
    frame[p:p + 40, p:p + 70] = a
    out = TF.refresh_frame(frame, spec, boundary)
    assert out is frame                              # in place
    np.testing.assert_array_equal(ring_and_domain(frame, spec),
                                  ring_and_domain(fresh, spec))
    torch.testing.assert_close(TF.unframe(frame, spec), a)
    # deep round-up cells beyond the ring are left untouched
    assert float(frame[-1, -1]) == 123.0


@pytest.mark.parametrize("boundary", BOUNDARIES)
@pytest.mark.parametrize("halo", [False, True])
def test_frame_env_matches_reference(boundary, halo):
    e = field(5, (100, 130))
    tspec = TF.frame_spec(100, 130, k=1)
    jspec = JF.frame_spec(100, 130, k=1)
    got = TF.frame_env(torch.as_tensor(e), tspec, boundary, halo=halo)
    want = JF.frame_env(jnp.asarray(e), jspec, boundary, halo=halo)
    if halo:
        np.testing.assert_array_equal(ring_and_domain(got, tspec),
                                      ring_and_domain(want, jspec))
    else:
        assert tuple(got.shape) == tspec.interior
        np.testing.assert_array_equal(got.numpy()[:100, :130], e)
        assert float(got[100:].abs().sum() + got[:, 130:].abs().sum()) == 0


def test_frame_spec_geometry_and_limits():
    spec = TF.frame_spec(100, 130, k=1)
    assert (spec.bm, spec.bn) == TF.DEFAULT_BLOCK
    assert spec.interior == (128, 160) and spec.shape == (130, 162)
    small = TF.frame_spec(5, 7, k=1)
    assert (small.bm, small.bn) == (8, 32)           # clipped to the domain
    assert TF.ceil_mul(33, 8) == 40
    with pytest.raises(ValueError) as te:
        TF.frame_spec(16, 128, k=1, sweeps=20)
    with pytest.raises(ValueError) as je:
        JF.frame_spec(16, 128, k=1, sweeps=20)
    assert str(te.value) == str(je.value)
