"""Port parity: the chained continuous path of ``FarmEngine`` (staging ring,
device-side seating, lag-1 drain), its frame units (masked refills, single
slot refills, the ring) and the segment fold of ``unroll="auto"`` —
against the JAX package and against the port's own classic loop.

The contracts of the reference's ``tests/core/test_chain.py``, on the port:
on a fault-free stream the chained path emits the same results (payload,
reduce, iters, status, order) as ``chained=False``; every index emits
exactly once; segment t's metadata is read only after segment t+1 is
dispatched, in one packed read per drained segment.  Emission sequences
equal the reference's exactly (``"jnp"``, and ``"pallas"`` in interpret
mode once); grids within atol 1e-5.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import frames as JF  # noqa: E402
from repro.core import pattern as JP  # noqa: E402
from repro.core import streaming as JS  # noqa: E402
from repro.core.executor import auto_unroll as j_auto_unroll  # noqa: E402
from repro.kernels import ref as JR  # noqa: E402
from repro_torch.core import frames as TF  # noqa: E402
from repro_torch.core import pattern as TP  # noqa: E402
from repro_torch.core import streaming as TS  # noqa: E402
from repro_torch.core.executor import auto_unroll  # noqa: E402
from repro_torch.kernels import ref as TR  # noqa: E402

TRIPS = [3, 9, 5, 7, 4, 6, 2, 8, 5, 3, 11, 2]
BOUNDARIES = ["zero", "nan", "reflect", "wrap"]


def countdown(get, *_):
    return get(0, 0) - 1.0


def trip_items(trips, shape=(8, 128)):
    base = np.linspace(0.1, 0.9, shape[0] * shape[1],
                       dtype=np.float32).reshape(shape)
    return [base + float(t) - 1.0 for t in trips]


def jcount(backend="jnp", max_iters=64):
    return JP.LoopOfStencilReduce(
        f=countdown, k=1, combine="max", cond=lambda r: r < 0.5,
        boundary="zero", max_iters=max_iters, backend=backend,
        interpret=True, block=(32, 128))


def tcount(backend="torch", max_iters=64):
    """A port loop on the CPU; the kernel backends run their wrappers'
    plain versions there (the device check is bypassed on purpose)."""
    loop = TP.LoopOfStencilReduce(
        f=countdown, k=1, combine="max", cond=lambda r: r < 0.5,
        boundary="zero", max_iters=max_iters, backend="torch", device="cpu")
    loop.backend = backend
    return loop


def teng(loop, **kw):
    return TS.FarmEngine(loop, device="cpu", **kw)


def stream(eng, items, **kw):
    """Emissions of one continuous stream, in order; each index once."""
    got = []

    def sink(r):
        assert r.index not in {g.index for g in got}, \
            f"duplicate emission for {r.index}"
        got.append(r)
    n = eng.run_continuous(items, sink, **kw)
    assert n == len(got)
    return got


def sequence(results):
    return [(int(r.index), r.status, int(r.attempts), int(r.iters))
            for r in results]


def by_index(results):
    return {int(r.index): r for r in results}


# reference runs shared by several tests (each JAX engine compiles anew)
_REF = {}


def reference(key, make):
    if key not in _REF:
        _REF[key] = make()
    return _REF[key]


def ref_stream(chained, backend="jnp", lanes=4, segment=4):
    def make():
        eng = JS.FarmEngine(jcount(backend), lanes=lanes, segment=segment,
                            chained=chained)
        return eng, stream(eng, trip_items(TRIPS))
    return reference(("stream", chained, backend, lanes, segment), make)


# ---------------------------------------------------------------------------
# bit-identity with the classic loop, and with the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_chained_matches_classic_and_reference(backend):
    items = trip_items(TRIPS)
    eng_c = teng(tcount(backend), lanes=4, segment=4)
    eng_s = teng(tcount(backend), lanes=4, segment=4, chained=False)
    got_c, got_s = stream(eng_c, items), stream(eng_s, items)
    j_eng, want = ref_stream(chained=True)
    assert sequence(got_c) == sequence(want)
    # chained and classic: the same results, item for item
    assert sorted(sequence(got_c)) == sorted(sequence(got_s))
    c, s = by_index(got_c), by_index(got_s)
    for i in c:
        assert c[i].status == "ok"
        torch.testing.assert_close(c[i].a, s[i].a, rtol=0, atol=0)
        torch.testing.assert_close(c[i].reduced, s[i].reduced, rtol=0,
                                   atol=0)
        np.testing.assert_allclose(c[i].a.numpy(),
                                   np.asarray(by_index(want)[i].a),
                                   atol=1e-5)
    assert eng_c.stats["refills"] == eng_s.stats["refills"] == \
        j_eng.stats["refills"]
    assert eng_c.stats["segments"] == j_eng.stats["segments"]
    assert eng_c.stats["segments"] >= eng_s.stats["segments"]
    assert eng_c.stats["wasted_lane_steps"] == \
        eng_s.stats["wasted_lane_steps"] == j_eng.stats["wasted_lane_steps"]
    if backend == "cuda":
        assert eng_c.buffer_pointers() == eng_c.bound_pointers


def test_pallas_interpret_chained_stream_matches():
    """One stream through the reference's Pallas kernel (interpret mode)
    against the port's kernel backend."""
    j_eng, want = ref_stream(chained=True, backend="pallas", lanes=3,
                             segment=5)
    eng = teng(tcount("cuda"), lanes=3, segment=5)
    got = stream(eng, trip_items(TRIPS))
    assert sequence(got) == sequence(want)
    for g in got:
        np.testing.assert_allclose(g.a.numpy(),
                                   np.asarray(by_index(want)[g.index].a),
                                   atol=1e-5)
    assert eng.stats["wasted_lane_steps"] == j_eng.stats["wasted_lane_steps"]


@pytest.mark.parametrize("stage_depth", [1, 3, None])
def test_ring_depth_never_changes_results(stage_depth):
    want = sequence(ref_stream(chained=True)[1])
    eng = teng(tcount("cuda"), lanes=4, segment=4, stage_depth=stage_depth)
    got = stream(eng, trip_items(TRIPS))
    assert sorted(sequence(got)) == sorted(want)
    if stage_depth is None:
        assert sequence(got) == want
        assert eng._ring_depth == 8


def test_single_item_and_single_lane():
    got = stream(teng(tcount("cuda"), lanes=1, segment=4), trip_items([5]))
    assert sequence(got) == [(0, "ok", 1, 5)]


# ---------------------------------------------------------------------------
# the pipeline contract: drain after the next dispatch, one read a segment
# ---------------------------------------------------------------------------


def test_drain_reads_only_after_next_dispatch():
    eng = teng(tcount("cuda"), lanes=4, segment=4)
    events = []
    chain_fn, meta_read = eng._chain_entry, eng._meta_read

    def spy_chain(*a, **k):
        events.append("dispatch")
        return chain_fn(*a, **k)

    def spy_read(*a):
        events.append("read")
        return meta_read(*a)

    eng._chain_entry, eng._meta_read = spy_chain, spy_read
    stream(eng, trip_items(TRIPS))
    n_dispatch, n_read = events.count("dispatch"), events.count("read")
    assert n_dispatch == eng.stats["segments"] > 0
    assert n_read == n_dispatch
    reads_seen = 0
    for j, ev in enumerate(events):
        if ev != "read":
            continue
        reads_seen += 1
        if reads_seen < n_read:     # steady state: the next is in flight
            assert events[:j].count("dispatch") >= reads_seen + 1, events


def test_one_packed_metadata_read_per_segment():
    """The drain's whole decision state crosses as ONE packed int32 vector
    a segment: (fin | it | hw | take | steps)."""
    eng = teng(tcount("cuda"), lanes=4, segment=4)
    meta_read = eng._meta_read
    shapes = []

    def spy_read(*arrs):
        out = meta_read(*arrs)
        shapes.extend((a.dtype, a.shape) for a in out)
        return out
    eng._meta_read = spy_read
    stream(eng, trip_items(TRIPS))
    assert len(shapes) == eng.stats["segments"]
    assert set(shapes) == {(np.dtype(np.int32), (4 * 4 + 1,))}


# ---------------------------------------------------------------------------
# frame units: the ring, masked and single-slot refills vs the reference
# ---------------------------------------------------------------------------


def test_stage_ring_write_and_gather():
    ring = TF.alloc_stage_ring(4, (3, 3), torch.float32)
    ptr = ring.data_ptr()
    for i in range(5):      # wraps: position 0 written twice
        TF.stage_ring_write(ring, torch.full((3, 3), float(i + 1)), i % 4)
    assert ring[:, 0, 0].tolist() == [5.0, 2.0, 3.0, 4.0]
    assert ring[torch.tensor([2, 0, 1])][:, 0, 0].tolist() == [3.0, 5.0, 2.0]
    assert ring.data_ptr() == ptr


def _spec_pair(m, n, sweeps=1):
    return (JF.frame_spec(m, n, k=1, block=(32, 32), sweeps=sweeps),
            TF.frame_spec(m, n, k=1, block=(32, 32), sweeps=sweeps))


@pytest.mark.parametrize("boundary", BOUNDARIES)
def test_refill_lanes_masked_matches_reference(boundary):
    m, n, lanes = 20, 40, 3
    jspec, tspec = _spec_pair(m, n, sweeps=2)
    rng = np.random.default_rng(1)
    frames = rng.normal(size=(lanes, *tspec.shape)).astype(np.float32)
    fresh = rng.normal(size=(lanes, m, n)).astype(np.float32)
    take = np.array([True, False, True])
    p = tspec.pad
    want = JF.refill_lanes_masked(jnp.asarray(frames), jnp.asarray(take),
                                  jnp.asarray(fresh), jspec, boundary)
    t_frames = torch.as_tensor(frames.copy())
    ptr = t_frames.data_ptr()
    got = TF.refill_lanes_masked(t_frames, torch.as_tensor(take),
                                 torch.as_tensor(fresh), tspec, boundary)
    assert got.data_ptr() == ptr                      # in place
    # the cells the kernel reads: domain + the pad-wide ghost ring
    ring = (slice(None), slice(0, p + m + p), slice(0, p + n + p))
    np.testing.assert_array_equal(got.numpy()[ring],
                                  np.asarray(want)[ring])
    np.testing.assert_array_equal(got.numpy()[1, p:p + m, p:p + n],
                                  frames[1, p:p + m, p:p + n])


@pytest.mark.parametrize("halo", [False, True])
@pytest.mark.parametrize("boundary", ["zero", "wrap"])
def test_env_refills_match_reference(halo, boundary):
    m, n, lanes = 20, 40, 3
    jspec, tspec = _spec_pair(m, n, sweeps=2)
    rng = np.random.default_rng(2)
    shape = tspec.shape if halo else tspec.interior
    env = rng.normal(size=(lanes, *shape)).astype(np.float32)
    fresh = rng.normal(size=(lanes, m, n)).astype(np.float32)
    take = np.array([False, True, True])
    want = JF.refill_lanes_env_masked(
        jnp.asarray(env), jnp.asarray(take), jnp.asarray(fresh), jspec,
        boundary, halo=halo)
    got = TF.refill_lanes_env_masked(
        torch.as_tensor(env.copy()), torch.as_tensor(take),
        torch.as_tensor(fresh), tspec, boundary, halo=halo)
    p = tspec.pad if halo else 0
    cells = (slice(None), slice(0, p + m + p if halo else m),
             slice(0, p + n + p if halo else n))
    np.testing.assert_array_equal(got.numpy()[cells],
                                  np.asarray(want)[cells])
    # one slot, in env slots whose rings agree with their domains (the
    # reference re-asserts every lane's ring, the port the slot's own)
    clean = rng.normal(size=(lanes, m, n)).astype(np.float32)
    want1 = JF.refill_slot_env(
        JF.lane_env_frames(jnp.asarray(clean), jspec, boundary, halo=halo),
        jnp.asarray(fresh[0]), 2, jspec, boundary, halo=halo)
    got1 = TF.refill_slot_env(
        TF.lane_env_frames(torch.as_tensor(clean), tspec, boundary,
                           halo=halo),
        torch.as_tensor(fresh[0]), 2, tspec, boundary, halo=halo)
    np.testing.assert_array_equal(got1.numpy()[cells],
                                  np.asarray(want1)[cells])


@pytest.mark.parametrize("boundary", BOUNDARIES)
def test_refill_slot_frame_matches_reference(boundary):
    m, n, lanes = 20, 40, 3
    jspec, tspec = _spec_pair(m, n)
    rng = np.random.default_rng(3)
    clean = rng.normal(size=(lanes, m, n)).astype(np.float32)
    # frames whose rings agree with their domains, as between sweeps
    jf = JF.make_lane_frames(jnp.asarray(clean), jspec, boundary)
    tf = TF.make_lane_frames(torch.as_tensor(clean), tspec, boundary)
    fresh = rng.normal(size=(m, n)).astype(np.float32)
    want = JF.refill_slot_frame(jf, jnp.asarray(fresh), 1, jspec, boundary)
    got = TF.refill_slot_frame(tf, torch.as_tensor(fresh), 1, tspec,
                               boundary)
    p = tspec.pad
    cells = (slice(None), slice(0, p + m + p), slice(0, p + n + p))
    np.testing.assert_array_equal(got.numpy()[cells],
                                  np.asarray(want)[cells])


# ---------------------------------------------------------------------------
# unroll="auto" folds the segment length in (continuous mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,n,segment", [(64, 512, 4), (6, 512, 1),
                                         (64, 512, 256), (40, 136, 16),
                                         (1080, 1920, 16)])
def test_segment_fold_equals_reference(m, n, segment):
    for seg in (None, segment):
        assert auto_unroll(m, n, k=1, block=(32, 128), segment=seg) == \
            j_auto_unroll(m, n, k=1, block=(32, 128), segment=seg)
    assert auto_unroll(64, 512, k=1, block=(32, 128), segment=4) == 8


def test_continuous_engine_resolves_the_reference_T(monkeypatch):
    """A continuous engine with ``unroll="auto"`` resolves T with its
    segment folded in, as the reference's engine does, and streams on it;
    round mode resolves without the fold."""
    monkeypatch.setattr(TP, "resolve_backend", lambda b, d: b or "torch")
    items = trip_items([3, 9, 5, 7], shape=(16, 128))
    kw = dict(f=countdown, k=1, combine="max", cond=lambda r: r < 0.5,
              boundary="zero", max_iters=64, unroll="auto")
    j_eng = JS.FarmEngine(JP.LoopOfStencilReduce(
        backend="pallas-multistep", interpret=True, **kw), lanes=2,
        segment=2)
    want = stream(j_eng, items)
    t_eng = teng(TP.LoopOfStencilReduce(backend="cuda-multistep",
                                        device="cpu", **kw),
                 lanes=2, segment=2)
    got = stream(t_eng, items)
    assert t_eng._loop.unroll == j_eng._loop.unroll > 1
    assert sequence(got) == sequence(want)
    assert all(int(r.iters) % t_eng._loop.unroll == 0 for r in got)
    r_eng = teng(TP.LoopOfStencilReduce(backend="cuda-multistep",
                                        device="cpu", **kw), lanes=2)
    r_eng.run(items, lambda r: None)
    assert r_eng._loop.unroll == auto_unroll(16, 128, k=1)


# ---------------------------------------------------------------------------
# a restore-shaped stream: env fields through the ring
# ---------------------------------------------------------------------------


def test_env_fields_through_the_ring_match_classic():
    rng = np.random.default_rng(4)
    u0 = np.abs(rng.normal(size=(24, 64))).astype(np.float32)
    items = [u0 * s for s in (0.3, 1.5, 0.7, 2.0, 1.0)]
    loop = TP.LoopOfStencilReduce(
        f=TR.restore_taps(2.0), k=1, combine="max", cond=lambda r: r < 1e-3,
        delta=TR.abs_delta, boundary="reflect", max_iters=24,
        backend="torch", device="cpu")
    loop.backend = "cuda"

    def prep(item):
        return item, (item, (item > 1.0).to(torch.float32))
    jl = JP.LoopOfStencilReduce(
        f=JR.restore_taps(2.0), k=1, combine="max", cond=lambda r: r < 1e-3,
        delta=JR.abs_delta, boundary="reflect", max_iters=24, backend="jnp")
    want = stream(JS.FarmEngine(jl, lanes=2, segment=3, prep=lambda x: (
        x, (x, (x > 1.0).astype(jnp.float32)))), items)
    got_c = stream(teng(loop, lanes=2, segment=3, prep=prep), items)
    got_s = stream(teng(loop, lanes=2, segment=3, prep=prep,
                        chained=False), items)
    assert sequence(got_c) == sequence(want)
    assert sorted(sequence(got_c)) == sorted(sequence(got_s))
    s = by_index(got_s)
    for r in got_c:
        torch.testing.assert_close(r.a, s[r.index].a, rtol=0, atol=0)
        np.testing.assert_allclose(r.a.numpy(),
                                   np.asarray(by_index(want)[r.index].a),
                                   atol=1e-5)
