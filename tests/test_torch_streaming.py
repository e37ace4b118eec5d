"""Port parity: the streaming tier — item layer, generic tier (pipe / farm /
ofarm / StreamRunner), FarmEngine in round and continuous (classic) mode,
and the segment seams of the pattern — against the JAX package.

The same stream items, made from a numpy seed, go through the reference's
``FarmEngine`` on ``"jnp"`` and the port's on ``"torch"`` and on the kernel
backends (whose wrappers run their plain versions on the CPU: the device
check is bypassed, as in ``tests/test_torch_farm.py``).  Exact: stream
indices, emission order, iters, statuses, attempts, health words and the
engines' step and byte counters.  Grids within atol 1e-5, reduces within
atol 1e-6.  The reference's trace and jaxpr contracts become, here: the
slot buffers keep their ``data_ptr()`` across a stream, one stencil sweep
call per body step covers every lane, and a refill moves one interior per
item (``stats["h2d_bytes"]``).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import pattern as JP  # noqa: E402
from repro.core import streaming as JS  # noqa: E402
from repro.kernels import ref as JR  # noqa: E402
from repro_torch.core import pattern as TP  # noqa: E402
from repro_torch.core import streaming as TS  # noqa: E402
from repro_torch.core.reduce import health_status  # noqa: E402
from repro_torch.kernels import ref as TR  # noqa: E402
from repro_torch.kernels import stencil2d as TK  # noqa: E402

SCALES = (1.0, 5.0, 0.1, 2.0, 0.5, 3.0)


def countdown(get, *_):
    """Every cell decrements by 1 a sweep: an item whose max is v converges
    in exactly v sweeps (cond: max < 0.5) — programmable trip counts."""
    return get(0, 0) - 1.0


def trip_items(trips, shape=(8, 128)):
    base = np.linspace(0.1, 0.9, shape[0] * shape[1],
                       dtype=np.float32).reshape(shape)
    return [base + float(t) - 1.0 for t in trips]


def mixed_items(seed=0, n=5, shape=(40, 136)):
    u0 = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return [u0 * SCALES[i % len(SCALES)] for i in range(n)]


def jcount(backend="jnp", max_iters=256, unroll=1):
    return JP.LoopOfStencilReduce(
        f=countdown, k=1, combine="max", cond=lambda r: r < 0.5,
        boundary="zero", max_iters=max_iters, unroll=unroll,
        backend=backend, interpret=True, block=(32, 128))


def tcount(backend="torch", max_iters=256, unroll=1):
    """A port loop on the CPU; the kernel backends run their wrappers'
    plain versions there (the device check is bypassed on purpose)."""
    loop = TP.LoopOfStencilReduce(
        f=countdown, k=1, combine="max", cond=lambda r: r < 0.5,
        boundary="zero", max_iters=max_iters, unroll=unroll,
        backend="torch", device="cpu")
    loop.backend = backend
    return loop


def jheat(backend="jnp", unroll=1, max_iters=60):
    return JP.LoopOfStencilReduce(
        f=JR.heat_taps(0.1), k=1, combine="max", cond=lambda r: r < 2e-3,
        delta=JR.abs_delta, boundary="reflect", max_iters=max_iters,
        unroll=unroll, backend=backend, interpret=True, block=(32, 128))


def theat(backend="torch", unroll=1, max_iters=60):
    loop = TP.LoopOfStencilReduce(
        f=TR.heat_taps(0.1), k=1, combine="max", cond=lambda r: r < 2e-3,
        delta=TR.abs_delta, boundary="reflect", max_iters=max_iters,
        unroll=unroll, backend="torch", device="cpu")
    loop.backend = backend
    return loop


@pytest.fixture
def plain_kernels(monkeypatch):
    """Let a kernel-backend loop be built on the CPU (resolved copies
    included), where every kernel wrapper runs its plain version."""
    monkeypatch.setattr(TP, "resolve_backend", lambda b, d: b or "torch")


def teng(loop, **kw):
    return TS.FarmEngine(loop, device="cpu", **kw)


def collect(eng, items, **kw):
    """Run a continuous stream; every index exactly once."""
    got = []
    n = eng.run(items, got.append, continuous=True, **kw)
    assert n == len(got)
    assert len({r.index for r in got}) == len(got), "duplicate emission"
    return got


def sequence(results):
    return [(int(r.index), r.status, int(r.attempts), int(r.iters))
            for r in results]


def assert_payloads(got, want, atol=1e-5):
    """Grids and reduces of two emission lists, matched by index."""
    want = {int(r.index): r for r in want}
    for r in got:
        w = want[int(r.index)]
        if w.a is None:
            assert r.a is None
            continue
        np.testing.assert_allclose(np.asarray(r.a), np.asarray(w.a),
                                   atol=atol, rtol=0)
        np.testing.assert_allclose(float(r.reduced), float(w.reduced),
                                   atol=1e-6, rtol=0)


STAT_KEYS = ("items", "rounds", "h2d_bytes", "d2h_bytes", "segments",
             "refills", "lane_steps", "wasted_lane_steps",
             "quarantined_lane_steps", "retries", "rejected",
             "quarantined_slots", "sink_errors")


def assert_stats(t_eng, j_eng):
    t_eng.lane_steps, j_eng.lane_steps      # flush round-mode buffers
    assert {k: t_eng.stats[k] for k in STAT_KEYS} == \
        {k: j_eng.stats[k] for k in STAT_KEYS}


# ---------------------------------------------------------------------------
# the item layer
# ---------------------------------------------------------------------------


def test_item_status_taxonomy_matches_reference():
    from repro_torch.core.reduce import (HEALTH_CONVERGED, HEALTH_DIVERGED,
                                         HEALTH_POISONED)
    words = [0, HEALTH_CONVERGED, HEALTH_POISONED, HEALTH_DIVERGED,
             HEALTH_CONVERGED | HEALTH_POISONED, HEALTH_CONVERGED | 5]
    for hw in words:
        for iters in (0, 7, 64, 80):
            assert TS.item_status(hw, iters, 64) == \
                JS.item_status(hw, iters, 64)
    assert issubclass(TS.NonFiniteItemError, ValueError)


def test_item_helpers():
    a = np.ones((3, 4), np.float32)
    assert TS._default_prep(a) == (a, ())
    x, env = TS._default_prep((a, a * 2))
    assert x is a and len(env) == 1
    item = TS._as_item((a, a.astype(np.float64)))
    assert all(isinstance(leaf, torch.Tensor) for leaf in item)
    assert TS._item_nbytes(item) == a.nbytes + 2 * a.nbytes
    stacked = TS._stack_items([(a, a), (a, a)])
    assert [tuple(s.shape) for s in stacked] == [(2, 3, 4), (2, 3, 4)]
    assert tuple(TS._stack_items([a, a, a]).shape) == (3, 3, 4)
    r = TS.StreamResult(index=3, a=None, reduced=None, iters=0)
    assert (r.status, r.attempts, r.error) == ("ok", 1, None)


# ---------------------------------------------------------------------------
# the generic tier
# ---------------------------------------------------------------------------


def test_pipe_and_farm_match_reference():
    items = np.stack(mixed_items(n=3, shape=(16, 32)))
    jl, tl = jheat(max_iters=12), theat(max_iters=12)
    want = JS.farm(JS.pipe(lambda x: x * 0.5, jl.run))(jnp.asarray(items))
    got = TS.ofarm(TS.pipe(lambda x: x * 0.5, tl.run))(
        torch.as_tensor(items))
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(want.iters))
    np.testing.assert_array_equal(got.health.numpy(),
                                  np.asarray(want.health))
    np.testing.assert_allclose(got.a.numpy(), np.asarray(want.a), atol=1e-5)


def test_stream_runner_empty_ragged_and_lazy():
    r = TS.StreamRunner(worker=lambda b: b * 2, source=lambda: iter([]),
                        sink=lambda x: None, batch=3)
    assert r.run() == 0
    out = []
    r = TS.StreamRunner(worker=lambda b: b + 1,
                        source=lambda: iter([np.full((2,), i, np.float32)
                                             for i in range(7)]),
                        sink=out.append, batch=3)
    assert r.run() == 7                               # 3 + 3 + ragged 1
    assert [float(o[0]) for o in out] == [i + 1.0 for i in range(7)]
    batched = (torch.zeros((4, 2)), torch.ones((4, 3)))
    gen = TS.StreamRunner._unstack(batched)
    first = next(gen)                                 # lazy: one at a time
    assert [tuple(x.shape) for x in first] == [(2,), (3,)]
    assert len(list(gen)) == 3


def test_sharded_deployments_raise_naming_the_roadmap():
    with pytest.raises(NotImplementedError, match="A7"):
        TS.sharded_farm(lambda x: x, mesh=object())
    with pytest.raises(NotImplementedError, match="A7"):
        teng(tcount(), lanes=2, mesh=object())
    loop = tcount()
    loop.backend = "cuda-sharded"
    with pytest.raises(NotImplementedError, match="A7"):
        teng(loop, lanes=2)


def test_validation():
    with pytest.raises(ValueError, match="segment"):
        teng(tcount(), lanes=2, segment=0)
    with pytest.raises(ValueError, match="max_attempts"):
        teng(tcount(), lanes=2, max_attempts=0)
    with pytest.raises(ValueError, match="slot_patience"):
        teng(tcount(), lanes=2, slot_patience=0)
    with pytest.raises(ValueError, match="stage_depth"):
        teng(tcount(), lanes=2, stage_depth=0)
    with pytest.raises(ValueError, match="loop runs on"):
        TS.FarmEngine(tcount(), lanes=2, device="meta")
    s_loop = TP.LoopOfStencilReduce(
        f=countdown, cond=lambda r, s: True, state_init=lambda: 0,
        state_update=lambda s, a, it: s, device="cpu")
    with pytest.raises(ValueError, match="-s variant"):
        teng(s_loop, lanes=2)


# ---------------------------------------------------------------------------
# round mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend,unroll,jbackend", [
    ("torch", 1, "jnp"), ("cuda", 1, "jnp"),
    ("cuda-multistep", 3, "pallas-multistep")])
def test_round_stream_matches_reference_and_solo_runs(backend, unroll,
                                                      jbackend):
    """5 items through 2 slots (2 full rounds + a ragged one): each result
    equals the reference's round and the item's solo run — a refilled slot
    carries nothing over from its previous occupant."""
    items = mixed_items(n=5)
    j_eng = JS.FarmEngine(jheat(jbackend, unroll), lanes=2)
    want = []
    j_eng.run(items, want.append)
    loop = theat(backend, unroll)
    t_eng = teng(loop, lanes=2)
    got = []
    assert t_eng.run(items, got.append) == 5
    assert t_eng.stats["rounds"] == 3
    for it, g, w in zip(items, got, want):
        assert int(g.iters) == int(w.iters)
        assert int(g.health) == int(w.health)
        assert g.a.device.type == "cpu"
        np.testing.assert_allclose(g.a.numpy(), np.asarray(w.a), atol=1e-5)
        np.testing.assert_allclose(float(g.reduced), float(w.reduced),
                                   atol=1e-6)
        solo = loop.run(it)
        assert int(solo.iters) == int(g.iters)
        torch.testing.assert_close(g.a, solo.a, rtol=0, atol=0)
    assert_stats(t_eng, j_eng)
    if backend != "torch":
        assert t_eng.buffer_pointers() == t_eng.bound_pointers


def test_round_host_transfer_is_interior_sized():
    m, n = 40, 136
    items = mixed_items(n=4, shape=(m, n))
    eng = teng(theat("cuda", max_iters=8), lanes=2)
    count = eng.run(items, lambda r: None)
    cell = 4
    assert eng.stats["h2d_bytes"] == eng.stats["rounds"] * 2 * m * n * cell
    assert eng.stats["d2h_bytes"] == \
        eng.stats["rounds"] * 2 * (m * n * cell + cell + 4)
    assert eng.stats["h2d_bytes"] / count < (m + 2) * (n + 2) * cell


def test_round_empty_source_oversize_batch_and_mode_mixing():
    eng = teng(tcount("cuda"), lanes=2)
    assert eng.run(lambda: iter([]), lambda r: None) == 0
    with pytest.raises(ValueError, match="exceeds"):
        eng.round(np.zeros((3, 8, 128), np.float32))
    eng.run(trip_items([2, 3]), lambda r: None)
    with pytest.raises(ValueError, match="round mode"):
        eng.run(trip_items([2]), lambda r: None, continuous=True)
    with pytest.raises(ValueError, match="continuous=True"):
        eng.run(trip_items([2]), lambda r: None, on_segment=print)
    eng = teng(tcount(), lanes=2, segment=3)
    eng.run(trip_items([2]), lambda r: None, continuous=True)
    with pytest.raises(ValueError, match="continuous mode"):
        eng.round(np.stack(trip_items([2, 3])))


# ---------------------------------------------------------------------------
# continuous mode (classic loop)
# ---------------------------------------------------------------------------

SPREADS = {"uniform": [6, 6, 6, 6, 6, 6], "bimodal": [1, 40, 1, 40, 1, 1],
           "straggler": [2, 2, 2, 40, 2, 2]}


@pytest.mark.parametrize("spread", list(SPREADS))
def test_continuous_matches_reference_and_cuts_waste(spread):
    """Completion order, iters, payloads and every step counter equal the
    reference's classic continuous farm; the lane sweeps drop below round
    mode's wherever the spread gives the barrier something to waste."""
    trips = SPREADS[spread]
    items = trip_items(trips)
    j_eng = JS.FarmEngine(jcount(), lanes=2, segment=8, chained=False)
    want = collect(j_eng, items)
    results = {}
    for backend in ("torch", "cuda"):
        t_eng = teng(tcount(backend), lanes=2, segment=8, chained=False)
        got = collect(t_eng, items)
        assert sequence(got) == sequence(want)
        assert_payloads(got, want)
        assert_stats(t_eng, j_eng)
        results[backend] = t_eng
    rnd = teng(tcount("cuda"), lanes=2)
    rounds = []
    rnd.run(items, rounds.append)
    assert [int(r.iters) for r in rounds] == trips
    cont = results["cuda"]
    assert cont.lane_steps <= rnd.lane_steps
    if spread != "uniform":
        assert cont.lane_steps < rnd.lane_steps
        assert cont.wasted_lane_steps < rnd.wasted_lane_steps


@pytest.mark.parametrize("backend,unroll,jbackend", [
    ("cuda", 1, "jnp"), ("cuda-multistep", 3, "pallas-multistep")])
def test_continuous_heat_stream_matches_reference(backend, unroll,
                                                  jbackend):
    items = mixed_items(n=6)
    j_eng = JS.FarmEngine(jheat(jbackend, unroll), lanes=2, segment=6,
                          chained=False)
    want = collect(j_eng, items)
    t_eng = teng(theat(backend, unroll), lanes=2, segment=6, chained=False)
    got = collect(t_eng, items)
    assert sequence(got) == sequence(want)
    assert_payloads(got, want)
    assert_stats(t_eng, j_eng)
    assert t_eng.buffer_pointers() == t_eng.bound_pointers


def test_completion_order_beats_the_barrier():
    items = trip_items([60, 1, 1, 1])
    trips = []
    teng(tcount(), lanes=2).run(items, lambda r: trips.append(int(r.iters)))
    assert trips == [60, 1, 1, 1]
    order = []
    teng(tcount(), lanes=2, segment=8).run(
        items, lambda r: order.append(r.index), continuous=True)
    assert order[0] == 1 and order[-1] == 0, order


@pytest.mark.parametrize("chained", [False, True])
def test_ragged_tail_empty_source_and_second_stream(chained):
    eng = teng(tcount("cuda"), lanes=4, segment=4, chained=chained)
    assert eng.run(lambda: iter([]), lambda r: None, continuous=True) == 0
    got = collect(eng, trip_items([5, 2]))          # items < lanes
    assert sorted((r.index, int(r.iters)) for r in got) == [(0, 5), (1, 2)]
    ptrs = eng.buffer_pointers()
    got = collect(eng, trip_items([4, 2, 6, 1, 3]))  # the same slots
    assert sorted((r.index, int(r.iters)) for r in got) == \
        [(0, 4), (1, 2), (2, 6), (3, 1), (4, 3)]
    assert eng.buffer_pointers() == ptrs == eng.bound_pointers


def test_sink_exception_degrades_to_dead_letter():
    items = trip_items([2, 3, 4])
    for make in (lambda: JS.FarmEngine(jcount(), lanes=2, segment=4),
                 lambda: teng(tcount("cuda"), lanes=2, segment=4)):
        eng = make()

        def boom(r):
            raise RuntimeError("sink failed")
        assert eng.run(items, boom, continuous=True) == 3
        assert eng.stats["sink_errors"] == 3
        assert sorted(r.index for r in eng.dead_letter) == [0, 1, 2]
        assert all(r.status == "failed" and "sink failed" in r.error
                   for r in eng.dead_letter)
        assert sorted(r.index for r in collect(eng, items)) == [0, 1, 2]


def restore_prep_pair():
    def jprep(item):
        return item, (item, (item > 1.0).astype(jnp.float32))

    def tprep(item):
        return item, (item, (item > 1.0).to(torch.float32))
    return jprep, tprep


@pytest.mark.parametrize("backend,unroll", [("cuda", 1),
                                            ("cuda-multistep", 2)])
def test_env_fields_ride_the_refill(backend, unroll):
    """Per-item env fields from ``prep``: every item matches the
    reference's stream and its own solo run with ITS env."""
    jprep, tprep = restore_prep_pair()
    items = mixed_items(n=5)
    jl = JP.LoopOfStencilReduce(
        f=JR.restore_taps(2.0), k=1, combine="max", cond=lambda r: r < 1e-3,
        delta=JR.abs_delta, boundary="reflect", max_iters=24,
        unroll=unroll, backend="jnp")
    want = collect(JS.FarmEngine(jl, lanes=2, prep=jprep, segment=6,
                                 chained=False), items)
    tl = TP.LoopOfStencilReduce(
        f=TR.restore_taps(2.0), k=1, combine="max", cond=lambda r: r < 1e-3,
        delta=TR.abs_delta, boundary="reflect", max_iters=24,
        unroll=unroll, backend="torch", device="cpu")
    tl.backend = backend
    got = collect(teng(tl, lanes=2, prep=tprep, segment=6, chained=False),
                  items)
    assert sequence(got) == sequence(want)
    assert_payloads(got, want)
    for r in got:
        a0, envs = tprep(torch.as_tensor(items[r.index]))
        solo = tl.run(a0, env=envs)
        assert int(solo.iters) == int(r.iters)
        torch.testing.assert_close(r.a, solo.a, rtol=0, atol=0)


@pytest.mark.parametrize("continuous", [False, True])
def test_tuple_items_and_drift_guards(continuous):
    items = mixed_items(n=4)
    tuples = [(b, b, (b > 1.0).astype(np.float32)) for b in items]
    jl = JP.LoopOfStencilReduce(
        f=JR.restore_taps(2.0), k=1, combine="max", cond=lambda r: r < 1e-3,
        delta=JR.abs_delta, boundary="reflect", max_iters=24,
        backend="jnp")
    tl = TP.LoopOfStencilReduce(
        f=TR.restore_taps(2.0), k=1, combine="max", cond=lambda r: r < 1e-3,
        delta=TR.abs_delta, boundary="reflect", max_iters=24,
        backend="torch", device="cpu")
    tl.backend = "cuda"
    want, got = [], []
    JS.FarmEngine(jl, lanes=2, segment=6).run(tuples, want.append,
                                              continuous=continuous)
    teng(tl, lanes=2, segment=6).run(tuples, got.append,
                                     continuous=continuous)
    for g, w in zip(got, want):
        if continuous:
            assert (g.index, g.status) == (w.index, w.status)
        assert int(g.iters) == int(w.iters)
        np.testing.assert_allclose(np.asarray(g.a), np.asarray(w.a),
                                   atol=1e-5)
    bad = tuples[:2] + [(tuples[2][0], tuples[2][1],
                         np.zeros((8, 8), np.float32))]
    with pytest.raises(ValueError, match="env stream item.*fresh "
                                         "FarmEngine"):
        teng(tl, lanes=2, segment=6).run(bad, lambda r: None,
                                         continuous=continuous)
    if continuous:
        bad = tuples[:2] + [(tuples[2][0], tuples[2][1])]
        with pytest.raises(ValueError, match="arity changed"):
            teng(tl, lanes=2, segment=6).run(bad, lambda r: None,
                                             continuous=True)


# ---------------------------------------------------------------------------
# the torch meaning of the reference's trace and jaxpr contracts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend,unroll", [("cuda", 1),
                                            ("cuda-multistep", 3)])
def test_one_sweep_call_per_body_step_for_all_lanes(backend, unroll,
                                                    monkeypatch):
    """Each body step sweeps every lane in ONE call of the kernel wrapper
    (per fused sweep on "cuda", per T sweeps on "cuda-multistep") — there
    is no Python loop over lanes and no extra call in a refill."""
    from repro_torch.kernels import multistep as TM
    mod, name = ((TK, "stencil2d_fused_framed") if backend == "cuda"
                 else (TM, "stencil2d_multistep_framed"))
    calls = []
    real = getattr(mod, name)

    def counted(frame, *a, **k):
        calls.append(tuple(frame.shape))
        return real(frame, *a, **k)
    monkeypatch.setattr(mod, name, counted)
    lanes = 3
    eng = teng(tcount(backend, unroll=unroll, max_iters=30), lanes=lanes,
               segment=5)
    collect(eng, trip_items([3, 9, 4, 17, 3, 5, 2]))
    body_steps = eng.lane_steps // (lanes * unroll)
    sweeps_per_step = unroll if backend == "cuda" else 1
    assert len(calls) == body_steps * sweeps_per_step
    assert all(shape[0] == lanes for shape in calls)


@pytest.mark.parametrize("chained", [False, True])
def test_refill_moves_one_interior_per_item(chained):
    """h2d: exactly each item's interior crosses into the device — never a
    frame — and the slot buffers are the ones allocated at bind time."""
    m, n = 8, 128
    items = trip_items([3, 9, 4, 7, 3], shape=(m, n))
    j_eng = JS.FarmEngine(jcount(), lanes=2, segment=4, chained=chained)
    collect(j_eng, items)
    eng = teng(tcount("cuda"), lanes=2, segment=4, chained=chained)
    collect(eng, items)
    assert eng.stats["h2d_bytes"] == len(items) * m * n * 4 == \
        j_eng.stats["h2d_bytes"]
    assert eng.stats["d2h_bytes"] == j_eng.stats["d2h_bytes"]
    assert eng.buffer_pointers() == eng.bound_pointers


# ---------------------------------------------------------------------------
# the pattern's seams: segmented_while, lane_segment, fault_hook, unroll
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("segment,early_exit", [(3, True), (10, True),
                                                (4, False)])
def test_segmented_while_exits_at_the_reference_step(segment, early_exit):
    """Lanes count down from different starts; a lane is finished at 0.
    The port's host loop stops at the reference's step, carry for carry,
    from fresh and from partly finished carries."""
    starts = np.array([5, 2, 7, 0], np.int32)

    def jbody(c):
        return jnp.maximum(c - 1, 0)

    def tbody(c):
        return torch.clamp(c - 1, min=0)
    jc, tc = jnp.asarray(starts), torch.as_tensor(starts)
    for _ in range(4):
        jc, jsteps = JP.segmented_while(
            jbody, jc, finished=lambda c: c == 0, segment=segment,
            early_exit=early_exit)
        tc, tsteps = TP.segmented_while(
            tbody, tc, finished=lambda c: c == 0, segment=segment,
            early_exit=early_exit)
        assert tsteps == int(jsteps)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_lane_segment_matches_reference(backend):
    items = np.stack(trip_items([3, 6, 2]))
    jl, tl = jcount(), tcount(backend)
    jcarry = (jnp.asarray(items), jnp.full((3,), -jnp.inf),
              jnp.zeros((3,), jnp.int32), jnp.zeros((3,), bool),
              jnp.zeros((3,), jnp.int32))
    tcarry = (torch.as_tensor(items), torch.full((3,), float("-inf")),
              torch.zeros((3,), dtype=torch.int32),
              torch.zeros((3,), dtype=torch.bool),
              torch.zeros((3,), dtype=torch.int32))
    if backend == "cuda":                  # the kernel on lane frames
        eng = tl._engine()
        frames, _, lspec = eng.prepare_lanes(tcarry[0])
        tcarry = (frames,) + tcarry[1:]
        step = lambda fr, live: eng.sweeps(fr, (), lspec.frame, live)
    else:
        step = tl._lane_step_torch(())
    for _ in range(3):
        jcarry, jsteps = jl.lane_segment(jcarry, step=jl._lane_step_jnp(()),
                                         segment=4)
        tcarry, tsteps = tl.lane_segment(tcarry, step=step, segment=4)
        assert tsteps == int(jsteps)
        for t, j in zip(tcarry[1:], jcarry[1:]):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_fault_hook_sees_the_fresh_reduce_before_the_condition():
    """A hook that pins lane 1's reduce high until sweep 5 holds it back
    exactly as the reference's hook does."""
    def jhook(r, it):
        return jnp.where((jnp.arange(r.shape[0]) == 1) & (it < 5), 9.0, r)

    def thook(r, it):
        return torch.where((torch.arange(r.shape[0]) == 1) & (it < 5),
                           torch.full_like(r, 9.0), r)
    items = np.stack(trip_items([2, 2, 3]))
    jl = jcount()
    jl.fault_hook = jhook
    want = jl.farm_run(jnp.asarray(items))
    for backend in ("torch", "cuda"):
        tl = tcount(backend)
        tl.fault_hook = thook
        got = tl.farm_run(items)
        assert got.iters.tolist() == np.asarray(want.iters).tolist() == \
            [2, 6, 3]


@pytest.mark.parametrize("shape,segment", [
    ((64, 512), 4), ((64, 512), None), ((64, 512), 256), ((6, 512), 1),
    ((40, 136), 16)])
def test_resolve_unroll_folds_the_segment_like_the_reference(
        plain_kernels, shape, segment):
    jl = JP.LoopOfStencilReduce(f=countdown, cond=lambda r: True,
                                unroll="auto", backend="pallas-multistep")
    tl = TP.LoopOfStencilReduce(f=countdown, cond=lambda r: True,
                                unroll="auto", backend="cuda-multistep",
                                device="cpu")
    assert tl._resolve_unroll(shape, segment=segment).unroll == \
        jl._resolve_unroll(shape, segment=segment).unroll


def test_round_mode_health_decodes_per_lane():
    eng = teng(tcount("cuda"), lanes=2)
    outs = []
    eng.run(trip_items([3, 5]), outs.append)
    assert [health_status(r.health) for r in outs] == ["ok", "ok"]
