"""Port parity: the lane farm — ``LoopOfStencilReduce.farm_run`` and the
lane half of the single-device frames — against the JAX package.

``farm_run`` runs a stack of items as one done-masked loop, each lane to its
own trip count.  On the CPU the kernel backends run through their wrappers'
plain versions; the farm is held against the JAX ``farm_run`` (``"jnp"``, and
``"pallas-multistep"`` in interpret mode once) and against solo ``run``s:
per-lane ``iters`` and health words exactly, grids within atol 1e-5,
reduces within atol 1e-6.  ``tests/test_torch_cuda.py`` holds the farm on
the card against its solo runs and counts one launch per sweep for all
lanes.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import frames as JF  # noqa: E402
from repro.core import pattern as JP  # noqa: E402
from repro.kernels import ref as JR  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import executor as TE  # noqa: E402
from repro_torch.core import frames as TF  # noqa: E402
from repro_torch.core import pattern as TP  # noqa: E402
from repro_torch.kernels import ref as TR  # noqa: E402

SCALES = (1.0, 5.0, 0.1, 2.0)


def j_heat(get, *_):
    lap = (get(-1, 0) + get(1, 0) + get(0, -1) + get(0, 1)
           - 4.0 * get(0, 0))
    return get(0, 0) + 0.1 * lap


def mixed_batch(seed=0, n=4, shape=(40, 136)):
    """Stacked items with deliberately different convergence speeds."""
    u0 = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return np.stack([u0 * SCALES[i % len(SCALES)] for i in range(n)])


def jloop(backend, unroll=1, max_iters=60, **kw):
    return JP.LoopOfStencilReduce(
        f=j_heat, k=1, combine="max", cond=lambda r: r < 2e-3,
        delta=JR.abs_delta, boundary="reflect", max_iters=max_iters,
        unroll=unroll, backend=backend, interpret=True, block=(32, 128),
        **kw)


def tloop(backend, unroll=1, max_iters=60, f=None, **kw):
    """A port loop on the CPU; the kernel backends run their wrappers'
    plain versions there (the device check is bypassed on purpose)."""
    loop = TP.LoopOfStencilReduce(
        f=f or TR.heat_taps(0.1), k=1, combine="max",
        cond=lambda r: r < 2e-3, delta=TR.abs_delta, boundary="reflect",
        max_iters=max_iters, unroll=unroll, backend="torch", device="cpu",
        **kw)
    loop.backend = backend
    return loop


def assert_lanes(got, want, atol=1e-5):
    np.testing.assert_array_equal(np.asarray(got.iters),
                                  np.asarray(want.iters))
    np.testing.assert_array_equal(np.asarray(got.health),
                                  np.asarray(want.health))
    np.testing.assert_allclose(np.asarray(got.a), np.asarray(want.a),
                               atol=atol, rtol=0)
    np.testing.assert_allclose(np.asarray(got.reduced),
                               np.asarray(want.reduced), atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# (d) farm_run against the reference's farm_run and against solo runs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend,unroll,jbackend", [
    ("torch", 1, "jnp"), ("cuda", 1, "jnp"), ("cuda", 2, "jnp"),
    ("cuda-multistep", 3, "pallas-multistep")])
def test_farm_run_matches_reference_mixed_trip_counts(backend, unroll,
                                                      jbackend):
    batch = mixed_batch()
    want = jloop(jbackend, unroll).farm_run(jnp.asarray(batch))
    loop = tloop(backend, unroll)
    got = loop.farm_run(batch)
    iters = got.iters.tolist()
    assert len(set(iters)) > 1, "want MIXED trip counts"
    assert_lanes(got, want)
    for i in range(len(batch)):               # ≡ solo runs, lane for lane
        solo = loop.run(batch[i])
        assert int(solo.iters) == iters[i]
        assert int(solo.health) == int(got.health[i])
        torch.testing.assert_close(got.a[i], solo.a, rtol=0, atol=0)


@pytest.mark.parametrize("backend,unroll", [("torch", 1), ("cuda", 1),
                                            ("cuda-multistep", 2)])
def test_done0_premasks_lanes(backend, unroll):
    batch = mixed_batch()
    done0 = [False, True, False, False]
    want = jloop("jnp", unroll).farm_run(jnp.asarray(batch),
                                         done0=jnp.asarray(done0))
    got = tloop(backend, unroll).farm_run(batch, done0=torch.tensor(done0))
    assert int(got.iters[1]) == 0
    np.testing.assert_array_equal(got.a[1].numpy(), batch[1])
    assert_lanes(got, want)


@pytest.mark.parametrize("backend,unroll", [("cuda", 1),
                                            ("cuda-multistep", 3)])
def test_env_fields_per_lane(backend, unroll):
    batch = np.abs(mixed_batch(n=3)) * 0.3
    masks = (batch > 0.3).astype(np.float32)
    want = JP.LoopOfStencilReduce(
        f=JR.restore_taps(2.0), k=1, combine="max", cond=lambda r: r < 1e-3,
        delta=JR.abs_delta, boundary="reflect", max_iters=24, unroll=unroll,
        backend="jnp").farm_run(jnp.asarray(batch),
                                env=(jnp.asarray(batch), jnp.asarray(masks)))
    loop = tloop(backend, unroll, max_iters=24, f=TR.restore_taps(2.0))
    loop.cond = lambda r: r < 1e-3
    got = loop.farm_run(batch, env=(batch, masks))
    assert_lanes(got, want)
    for i in range(3):
        solo = loop.run(batch[i], env=(batch[i], masks[i]))
        assert int(got.iters[i]) == int(solo.iters)
        torch.testing.assert_close(got.a[i], solo.a, rtol=0, atol=0)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_condition_sees_one_lane_at_a_time(backend):
    """A condition that keeps its input's shape but is not elementwise
    (here it compares against the mean) still sees one lane's reduce, as
    under the reference's vmap, so the trip counts are the reference's."""
    def cond(r):
        return r < r.mean() + 2e-3
    batch = mixed_batch()
    jl = jloop("jnp", max_iters=12)
    jl.cond = cond
    want = jl.farm_run(jnp.asarray(batch))
    loop = tloop(backend, max_iters=12)
    loop.cond = cond
    got = loop.farm_run(batch)
    assert got.iters.tolist() == [1, 1, 1, 1]
    assert_lanes(got, want)


def test_s_variant_and_sharded_rejected():
    loop = TP.LoopOfStencilReduce(
        f=TR.heat_taps(), cond=lambda r, s: True, device="cpu",
        state_init=lambda: torch.zeros(()),
        state_update=lambda s, a, it: s)
    with pytest.raises(ValueError, match="-s variant"):
        loop.farm_run(torch.zeros((2, 8, 128)))
    with pytest.raises(ValueError, match="needs a partition="):
        TP.LoopOfStencilReduce(f=TR.heat_taps(), cond=bool,
                               backend="cuda-sharded", device="cpu")
    sharded = tloop("cuda-sharded")
    with pytest.raises(ValueError, match="FarmEngine"):
        sharded.farm_run(torch.zeros((2, 8, 128)))
    with pytest.raises(ValueError, match="lanes, m, n"):
        tloop("cuda").farm_run(torch.zeros((8, 128)))


# ---------------------------------------------------------------------------
# (e) a lane frozen for an odd number of checks keeps its own iterate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend,unroll", [("cuda", 1), ("cuda", 2),
                                            ("cuda-multistep", 3)])
def test_lane_frozen_for_an_odd_number_of_checks(backend, unroll):
    """The engine ping-pongs two lane buffers; a finished lane must still
    hold its own final iterate after an odd number of further checks (a
    slot left alone in the output buffer would hold one two sweeps old)."""
    batch = mixed_batch()[[2, 1]]                 # fast lane, slow lane
    fast = tloop(backend, unroll).run(batch[0])
    it0 = int(fast.iters)
    frozen_checks = 3
    loop = tloop(backend, unroll, max_iters=it0 + frozen_checks * unroll)
    got = loop.farm_run(batch)
    assert got.iters.tolist() == [it0, it0 + frozen_checks * unroll]
    assert (int(got.iters[1]) - it0) // unroll % 2 == 1
    torch.testing.assert_close(got.a[0], fast.a, rtol=0, atol=0)
    torch.testing.assert_close(got.a[1], loop.run(batch[1]).a, rtol=0,
                               atol=0)
    assert float(got.reduced[0]) == float(fast.reduced)


# ---------------------------------------------------------------------------
# lane frames (the lane half of core/frames.py) and the engine's lane methods
# ---------------------------------------------------------------------------

def ring_window(frames, spec_pad, m, n):
    """Domain plus the pad-wide ring around it, per lane: the cells both
    packages define the same way, whatever their tiles."""
    p = spec_pad
    return np.asarray(frames)[:, :2 * p + m, :2 * p + n]


@pytest.mark.parametrize("boundary", ["zero", "nan", "reflect", "wrap"])
@pytest.mark.parametrize("halo", [False, True])
def test_lane_frames_match_reference(boundary, halo):
    m, n, T = 20, 50, 3
    stack = mixed_batch(1, 3, (m, n))
    nxt = mixed_batch(2, 3, (m, n))
    jspec = JF.frame_spec(m, n, k=1, block=(8, 128), sweeps=T)
    spec = TF.frame_spec(m, n, k=1, sweeps=T)
    assert spec.pad == jspec.pad
    p = spec.pad
    jfr = JF.make_lane_frames(jnp.asarray(stack), jspec, boundary)
    tfr = TF.make_lane_frames(torch.as_tensor(stack), spec, boundary)
    np.testing.assert_array_equal(ring_window(tfr, p, m, n),
                                  ring_window(jfr, p, m, n))
    jfr = JF.refill_lane_frames(jfr, jnp.asarray(nxt), jspec, boundary)
    TF.refill_lane_frames(tfr, torch.as_tensor(nxt), spec, boundary)
    np.testing.assert_array_equal(ring_window(tfr, p, m, n),
                                  ring_window(jfr, p, m, n))
    np.testing.assert_array_equal(TF.unframe(tfr, spec).numpy(),
                                  np.asarray(JF.unframe_lanes(jfr, jspec)))
    # env slots: interior layout, or full frames (zero/wrap ring) with halo
    jenv = JF.lane_env_frames(jnp.asarray(stack), jspec, boundary, halo)
    tenv = TF.lane_env_frames(torch.as_tensor(stack), spec, boundary, halo)
    slots = TF.alloc_lane_env(TF.LaneFrameSpec(3, spec), torch.float32, halo)
    assert slots.shape == tenv.shape and not slots.any()
    jenv = JF.refill_lane_env(jenv, jnp.asarray(nxt), jspec, boundary, halo)
    TF.refill_lane_env(tenv, torch.as_tensor(nxt), spec, boundary, halo)
    if halo:
        np.testing.assert_array_equal(ring_window(tenv, p, m, n),
                                      ring_window(jenv, p, m, n))
    else:
        np.testing.assert_array_equal(tenv[:, :m, :n].numpy(),
                                      np.asarray(jenv)[:, :m, :n])


def test_lane_frames_carried_across_from_the_reference():
    m, n, T = 20, 50, 2
    stack = mixed_batch(3, 2, (m, n))
    jspec = JF.frame_spec(m, n, k=1, block=(8, 128), sweeps=T)
    jfr = JF.make_lane_frames(jnp.asarray(stack), jspec, "reflect")
    spec = TF.frame_spec(m, n, k=1, sweeps=T)
    got = interop.lane_frames_from_numpy(
        np.asarray(jfr), m=m, n=n, pad=jspec.pad, boundary="reflect",
        spec=spec, device="cpu")
    assert got.shape == TF.LaneFrameSpec(2, spec).shape
    torch.testing.assert_close(
        got, TF.make_lane_frames(torch.as_tensor(stack), spec, "reflect"),
        rtol=0, atol=0)
    with pytest.raises(ValueError, match="spec domain"):
        interop.lane_frames_from_numpy(np.asarray(jfr), m=m + 1, n=n,
                                       pad=jspec.pad, boundary="reflect",
                                       spec=spec, device="cpu")


@pytest.mark.parametrize("backend", ["cuda", "cuda-multistep"])
def test_engine_refill_lanes_reuses_the_slots(backend):
    eng = TE.StencilEngine(f=TR.restore_taps(2.0), k=1, boundary="reflect",
                           combine="sum", delta=TR.abs_delta, unroll=2,
                           backend=backend)
    first = torch.as_tensor(np.abs(mixed_batch(4, 2, (20, 50))))
    second = torch.as_tensor(np.abs(mixed_batch(5, 2, (20, 50))))
    masks = (first > 1.0).float()
    frames, env, lspec = eng.prepare_lanes(first, (first, masks))
    assert lspec.shape == frames.shape
    frames, red = eng.sweeps(frames, env, lspec.frame)
    assert red.shape == (2,)
    frames, env = eng.refill_lanes(frames, env, second, (second, masks),
                                   lspec)
    assert any(frames is b for b in eng._buffers)
    fresh, fenv, _ = dataclasses.replace(eng).prepare_lanes(second,
                                                            (second, masks))
    p, (m, n) = lspec.frame.pad, (20, 50)
    torch.testing.assert_close(frames[:, :2 * p + m, :2 * p + n],
                               fresh[:, :2 * p + m, :2 * p + n], rtol=0,
                               atol=0)
    for e, fe in zip(env, fenv):
        torch.testing.assert_close(e[:, :2 * p + m, :2 * p + n],
                                   fe[:, :2 * p + m, :2 * p + n], rtol=0,
                                   atol=0)
    np.testing.assert_array_equal(eng.unframe(frames, lspec.frame).numpy(),
                                  second.numpy())
