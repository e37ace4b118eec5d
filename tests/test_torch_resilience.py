"""Port parity: the resilience tier — ``FaultPlan``, retry / quarantine /
dead letter, the admission check, the journal and snapshots, elastic
resume and the kill-and-respawn harness — against the JAX package.

The same seeded plans and stream items go through the reference's
``FarmEngine`` (``"jnp"``) and the port's (``"torch"`` and ``"cuda"``,
whose wrappers run their plain versions on the CPU).  Exact: the seeded
plans, the full emission sequence (index, status, attempts, iters) under
faults, the dead-letter contents and the fault counters.  Grids within
atol 1e-5.  The on-disk formats are the reference's: each package reads
the snapshots and journals the other wrote.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import pattern as JP  # noqa: E402
from repro.core import streaming as JS  # noqa: E402
from repro.core.reduce import Sentinel as JSentinel  # noqa: E402
from repro.resilience import faults as JFa  # noqa: E402
from repro.resilience import recovery as JRec  # noqa: E402
from repro_torch.core import pattern as TP  # noqa: E402
from repro_torch.core import streaming as TS  # noqa: E402
from repro_torch.core.reduce import Sentinel, health_status  # noqa: E402
from repro_torch.resilience import (FaultPlan, Journal,  # noqa: E402
                                    PreemptionError, RecoveryConfig,
                                    load_snapshot, run_to_completion,
                                    save_snapshot)
from repro_torch.resilience.recovery import (fresh_tmp_dir,  # noqa: E402
                                             list_steps, publish_dir,
                                             sweep_strays)

SRC = Path(__file__).resolve().parents[1] / "src"
TRIPS = [3, 9, 5, 7, 4, 6, 2, 8]


def countdown(get, *_):
    return get(0, 0) - 1.0


def trip_items(trips, shape=(8, 128)):
    base = np.linspace(0.1, 0.9, shape[0] * shape[1],
                       dtype=np.float32).reshape(shape)
    return [base + float(t) - 1.0 for t in trips]


def jcount(max_iters=64, sentinel=None, hook=None):
    return JP.LoopOfStencilReduce(
        f=countdown, k=1, combine="max", cond=lambda r: r < 0.5,
        boundary="zero", max_iters=max_iters, backend="jnp",
        sentinel=sentinel, fault_hook=hook)


@pytest.fixture(autouse=True)
def plain_kernels(monkeypatch):
    """Let kernel-backend loops (and their copies, as ``instrument`` makes)
    be built on the CPU, where every kernel wrapper runs its plain version
    (only the device check stops them)."""
    monkeypatch.setattr(TP, "resolve_backend", lambda b, d: b or "torch")


def tcount(backend="torch", max_iters=64, sentinel=None, hook=None):
    return TP.LoopOfStencilReduce(
        f=countdown, k=1, combine="max", cond=lambda r: r < 0.5,
        boundary="zero", max_iters=max_iters, backend=backend,
        sentinel=sentinel, fault_hook=hook, device="cpu")


def teng(loop, **kw):
    return TS.FarmEngine(loop, device="cpu", **kw)


def stream(eng, items, **kw):
    got = []

    def sink(r):
        assert r.index not in {g.index for g in got}, \
            f"duplicate emission for {r.index}"
        got.append(r)
    n = eng.run(items, sink, continuous=True, **kw)
    assert n == len(got)
    return got


def sequence(results):
    return [(int(r.index), r.status, int(r.attempts), int(r.iters))
            for r in results]


def by_index(results):
    return {int(r.index): r for r in results}


FAULT_KEYS = ("retries", "rejected", "quarantined_slots",
              "quarantined_lane_steps", "wasted_lane_steps", "lane_steps",
              "refills", "segments", "sink_errors")


def assert_same_stream(t_eng, got, j_eng, want):
    assert sequence(got) == sequence(want)
    w = by_index(want)
    for r in got:
        if w[r.index].a is None:
            assert r.a is None
        else:
            np.testing.assert_allclose(r.a.numpy(), np.asarray(w[r.index].a),
                                       atol=1e-5, equal_nan=True)
    assert sequence(t_eng.dead_letter) == sequence(j_eng.dead_letter)
    assert {k: t_eng.stats[k] for k in FAULT_KEYS} == \
        {k: j_eng.stats[k] for k in FAULT_KEYS}


# ---------------------------------------------------------------------------
# FaultPlan: the same plans from the same seeds, the same hook
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 3, 7, 11])
@pytest.mark.parametrize("kw", [
    dict(lanes=4), dict(lanes=8, n_corrupt=2, n_items=32),
    dict(lanes=4, n_nan=2, n_stall=2, preempt_within=6),
    dict(lanes=1, n_corrupt=1, n_items=5, nan_from_max=9)])
def test_seeded_plan_equals_reference(seed, kw):
    want = JFa.FaultPlan.seeded(seed, **kw)
    got = FaultPlan.seeded(seed, **kw)
    assert dataclass_fields(got) == dataclass_fields(want)
    assert FaultPlan.seeded(seed, **kw) == got


def dataclass_fields(plan):
    return (plan.lanes, plan.nan_events, plan.stall_events,
            plan.corrupt_indices, plan.stall_value, plan.preempt_at_segment)


def test_reduce_hook_equals_reference():
    plan_kw = dict(lanes=4, nan_events=((1, 2),), stall_events=((3, 5),))
    jhook = JFa.FaultPlan(**plan_kw).reduce_hook()
    thook = FaultPlan(**plan_kw).reduce_hook()
    r = np.array([0.1, 0.2, 0.3, 0.4], np.float32)
    for its in ([0, 1, 2, 3], [2, 2, 4, 5], [9, 9, 9, 9]):
        it = np.array(its, np.int32)
        want = np.asarray(jhook(jnp.asarray(r), jnp.asarray(it)))
        got = thook(torch.as_tensor(r), torch.as_tensor(it)).numpy()
        np.testing.assert_array_equal(got, want)


def test_plan_validation_corruption_and_preempt_hook():
    with pytest.raises(ValueError, match="fault lane"):
        FaultPlan(lanes=2, nan_events=((2, 1),))
    plan = FaultPlan(lanes=2, corrupt_indices=(1,))
    items = trip_items([3, 4, 5])
    out = list(plan.corrupt_stream(items))
    assert not np.isfinite(out[1]).all()
    assert np.isfinite(out[0]).all() and np.isfinite(out[2]).all()
    assert np.isfinite(items[1]).all()                # original untouched
    t = plan.corrupt_item(torch.as_tensor(items[1]))
    assert int(torch.isnan(t).sum()) == 1
    assert np.isnan(np.asarray(JFa.FaultPlan(lanes=2).corrupt_item(
        items[1]))).flatten()[items[1].size // 2]
    assert np.isnan(t.numpy().flatten()[items[1].size // 2])
    hook = FaultPlan(lanes=2, preempt_at_segment=3).preempt_hook(
        mode="raise")
    hook(1)
    hook(2)
    with pytest.raises(PreemptionError):
        hook(3)
    hook(4)                            # fires once
    assert FaultPlan(lanes=2).preempt_hook() is None


# ---------------------------------------------------------------------------
# farm chaos: the reference's fault plan through both packages
# ---------------------------------------------------------------------------

PLAN = dict(lanes=4, nan_events=((1, 2),), stall_events=((2, 1 << 20),))


def chaos_pair(max_iters=32, **eng_kw):
    jloop = jcount(max_iters, JSentinel(nan=True, patience=3),
                   JFa.FaultPlan(**PLAN).reduce_hook())
    j_eng = JS.FarmEngine(jloop, lanes=4, segment=4, **eng_kw)
    return j_eng, eng_kw


@pytest.mark.parametrize("chained", [True, False])
@pytest.mark.parametrize("max_attempts,slot_patience", [(1, 3), (3, 2)])
def test_chaos_stream_equals_reference(chained, max_attempts,
                                       slot_patience):
    """Under the same plan: the same emission sequence (statuses, attempts,
    iters), the same dead letters, retries and quarantined slots — the
    chained path's one-dispatch quarantine lag included."""
    items = trip_items(TRIPS)
    kw = dict(max_attempts=max_attempts, slot_patience=slot_patience,
              chained=chained)
    j_eng, _ = chaos_pair(**kw)
    want = stream(j_eng, items)
    plan = FaultPlan(**PLAN)
    for backend in ("torch", "cuda"):
        loop = plan.instrument(tcount(backend, 32,
                                      Sentinel(nan=True, patience=3)))
        t_eng = teng(loop, lanes=4, segment=4, **kw)
        got = stream(t_eng, items)
        assert_same_stream(t_eng, got, j_eng, want)
    statuses = {r.status for r in got}
    if max_attempts == 1:
        assert "poisoned" in statuses and len(t_eng.dead_letter) >= 2
    else:
        assert statuses == {"ok"} and t_eng.stats["retries"] > 0
        assert 1 <= t_eng.stats["quarantined_slots"] <= 2


def test_quarantine_never_eats_the_last_slot():
    items = trip_items([3, 4])
    jloop = jcount(8, hook=JFa.FaultPlan(
        lanes=1, stall_events=((0, 1 << 20),)).reduce_hook())
    j_eng = JS.FarmEngine(jloop, lanes=1, segment=4, max_attempts=2,
                          slot_patience=1)
    want = stream(j_eng, items)
    loop = FaultPlan(lanes=1, stall_events=((0, 1 << 20),)).instrument(
        tcount("cuda", 8))
    t_eng = teng(loop, lanes=1, segment=4, max_attempts=2, slot_patience=1)
    got = stream(t_eng, items)
    assert_same_stream(t_eng, got, j_eng, want)
    assert all(r.status == "timed_out" and r.attempts == 2 for r in got)
    assert t_eng.stats["quarantined_slots"] == 0


def test_round_mode_statuses_and_waste_dominance():
    plan = FaultPlan(**PLAN)
    loop = plan.instrument(tcount("cuda", 32, Sentinel(nan=True,
                                                       patience=3)))
    eng = teng(loop, lanes=4)
    got = []
    eng.run(trip_items([3, 5, 4, 6]), got.append)
    statuses = [health_status(r.health) for r in got]
    assert statuses[1] == "poisoned" and statuses[0] == "ok"
    assert statuses[2] != "ok" and eng.quarantined_lane_steps > 0
    eng_r = teng(loop, lanes=4)
    eng_r.run(trip_items(TRIPS), lambda r: None)
    eng_c = teng(loop, lanes=4, segment=4)
    eng_c.run(trip_items(TRIPS), lambda r: None, continuous=True)

    def cost(e):
        return e.wasted_lane_steps + e.quarantined_lane_steps
    assert cost(eng_c) < cost(eng_r)


# ---------------------------------------------------------------------------
# the admission check
# ---------------------------------------------------------------------------


def test_round_mode_rejects_nonfinite_batch_loudly():
    eng = teng(tcount("cuda"), lanes=2)
    eng.run(trip_items([2, 3]), lambda r: None)
    bad = trip_items([2, 3])
    bad[1][4, 7] = np.nan
    with pytest.raises(TS.NonFiniteItemError, match="NaN/Inf"):
        eng.run(bad, lambda r: None)


@pytest.mark.parametrize("chained", [True, False])
def test_continuous_rejects_and_keeps_streaming(chained):
    plan_kw = dict(lanes=2, corrupt_indices=(1, 4))
    items = trip_items([3, 5, 4, 6, 2])
    j_eng = JS.FarmEngine(jcount(), lanes=2, segment=4, chained=chained)
    want = stream(j_eng, JFa.FaultPlan(**plan_kw).corrupt_stream(items))
    t_eng = teng(tcount("cuda"), lanes=2, segment=4, chained=chained)
    got = stream(t_eng, FaultPlan(**plan_kw).corrupt_stream(items))
    assert_same_stream(t_eng, got, j_eng, want)
    assert {r.index: r.status for r in got} == {
        0: "ok", 1: "rejected", 2: "ok", 3: "ok", 4: "rejected"}
    assert t_eng.stats["rejected"] == 2


def test_env_leaves_checked_and_check_finite_off():
    from repro_torch.kernels import ref as TR
    loop = TP.LoopOfStencilReduce(
        f=TR.restore_taps(2.0), k=1, combine="max", cond=lambda r: r < 1e-3,
        delta=TR.abs_delta, boundary="reflect", max_iters=16,
        backend="torch", device="cpu")
    a = trip_items([3])[0]
    mask = (a > 0.5).astype(np.float32)
    eng = teng(loop, lanes=2)
    eng.run([(a, a.copy(), mask)], lambda r: None)
    bad_mask = mask.copy()
    bad_mask[3, 9] = np.inf
    with pytest.raises(TS.NonFiniteItemError, match="env"):
        eng.run([(a, a.copy(), bad_mask)], lambda r: None)
    # admitted anyway: the sentinel quarantines the lane on the device
    items = list(FaultPlan(lanes=2, corrupt_indices=(1,)).corrupt_stream(
        trip_items([3, 5, 4])))
    eng = teng(tcount("cuda", 32, Sentinel(nan=True)), lanes=2, segment=4,
               check_finite=False)
    got = by_index(stream(eng, items))
    assert got[1].status == "poisoned" and int(got[1].iters) < 32
    assert got[0].status == got[2].status == "ok"


# ---------------------------------------------------------------------------
# recovery files: atomic publish, journal, snapshots — and the other
# package's files
# ---------------------------------------------------------------------------


def test_atomic_publish_and_stray_recovery(tmp_path):
    parent = str(tmp_path)
    final = os.path.join(parent, "step_1")
    for payload in ("one", "two"):
        tmp = fresh_tmp_dir(parent, "1")
        Path(tmp, "x").write_text(payload)
        publish_dir(tmp, final)
        assert Path(final, "x").read_text() == payload
    os.replace(final, os.path.join(parent, ".old-step_1"))   # torn publish
    os.makedirs(os.path.join(parent, ".tmp-9"))
    sweep_strays(parent)
    assert Path(final, "x").read_text() == "two"
    assert sorted(os.listdir(parent)) == ["step_1"]
    assert list_steps(parent) == [1]


def test_journal_round_trip_torn_tail_and_crc(tmp_path):
    path = str(tmp_path / "j.jsonl")
    j = Journal(path, fsync=False)
    a = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    j.append({"index": 0, "a": a, "status": "ok", "err": None})
    j.append({"index": 1, "a": a.to(torch.bfloat16),
              "nested": {"x": [1, 2.5, True]}})
    j.append({"index": 2})
    j.close()
    recs = list(Journal.replay(path))
    assert [r["index"] for r in recs] == [0, 1, 2]
    torch.testing.assert_close(recs[0]["a"], a, rtol=0, atol=0)
    assert recs[1]["a"].dtype == torch.bfloat16
    assert recs[1]["nested"]["x"] == [1, 2.5, True]
    data = Path(path).read_bytes()
    Path(path).write_bytes(data[:-5])                 # torn tail
    assert [r["index"] for r in Journal.replay(path)] == [0, 1]
    lines = data.splitlines(keepends=True)
    lines[1] = b"deadbeef" + lines[1][8:]             # corrupt CRC
    Path(path).write_bytes(b"".join(lines))
    assert [r["index"] for r in Journal.replay(path)] == [0]
    j = Journal(path, fsync=False)                    # append after replay
    j.append({"index": 3})
    j.close()
    assert [r["index"] for r in Journal.replay(path)] == [0]


def test_snapshot_tree_round_trip_and_keep(tmp_path):
    snap = str(tmp_path / "snaps")
    tree = {"kind": "farm", "version": 1, "complete": False,
            "occupants": [{"index": 4, "item": torch.ones((3, 5)),
                           "carry": (torch.zeros((2,), dtype=torch.bfloat16),
                                     0.5, 7)}],
            "retry": [], "none": None}
    save_snapshot(snap, 11, tree)
    out = load_snapshot(snap)
    assert out["kind"] == "farm" and out["none"] is None
    carry = out["occupants"][0]["carry"]
    assert isinstance(carry, tuple) and carry[0].dtype == torch.bfloat16
    assert carry[1:] == (0.5, 7)
    torch.testing.assert_close(out["occupants"][0]["item"],
                               torch.ones((3, 5)))
    for step in (12, 13, 14):
        save_snapshot(snap, step, {"step": step}, keep=2)
    assert list_steps(snap) == [13, 14]
    assert load_snapshot(snap)["step"] == 14
    assert load_snapshot(str(tmp_path / "nothing")) is None


def test_each_package_reads_the_others_files(tmp_path):
    """Snapshots and journals cross between the packages both ways, bf16
    leaves included (the reference's bf16 is a uint16 view + a tag)."""
    a32 = np.arange(6, dtype=np.float32).reshape(2, 3)
    bf = np.asarray(jnp.asarray(a32, jnp.bfloat16))
    # port -> reference
    save_snapshot(str(tmp_path / "t"), 1, {
        "a": torch.as_tensor(a32), "b": torch.as_tensor(a32).bfloat16(),
        "t": (1, "x"), "r": torch.tensor(0.25)})
    j = Journal(str(tmp_path / "t.jsonl"), fsync=False)
    j.append({"index": 5, "a": torch.as_tensor(a32).bfloat16(),
              "reduced": torch.tensor(0.25)})
    j.close()
    got = JRec.load_snapshot(str(tmp_path / "t"))
    np.testing.assert_array_equal(got["a"], a32)
    assert got["b"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(got["b"], bf)
    assert got["t"] == (1, "x") and float(got["r"]) == 0.25
    (rec,) = list(JRec.Journal.replay(str(tmp_path / "t.jsonl")))
    assert rec["a"].dtype == jnp.bfloat16 and rec["index"] == 5
    np.testing.assert_array_equal(rec["a"], bf)
    # reference -> port
    JRec.save_snapshot(str(tmp_path / "j"), 2, {
        "a": a32, "b": bf, "s": np.float32(1.5), "l": [None, True]})
    j = JRec.Journal(str(tmp_path / "j.jsonl"), fsync=False)
    j.append({"index": 6, "a": bf, "reduced": np.float32(1.5)})
    j.close()
    got = load_snapshot(str(tmp_path / "j"))
    torch.testing.assert_close(got["a"], torch.as_tensor(a32))
    assert got["b"].dtype == torch.bfloat16
    torch.testing.assert_close(got["b"].float(), torch.as_tensor(
        bf.astype(np.float32)), rtol=0, atol=0)
    assert float(got["s"]) == 1.5 and got["l"] == [None, True]
    (rec,) = list(Journal.replay(str(tmp_path / "j.jsonl")))
    assert rec["a"].dtype == torch.bfloat16 and float(rec["reduced"]) == 1.5


# ---------------------------------------------------------------------------
# preemption and elastic resume
# ---------------------------------------------------------------------------

RESUME_TRIPS = [3, 9, 5, 12, 7, 4, 10, 6]


def preempt_then_resume(root, make_eng, lanes0, lanes1, chained=True,
                        preempt_at=3):
    """Kill a stream at a segment (raise mode), resume it on another lane
    count; returns (first run's emissions, resumed engine, its
    emissions)."""
    items = trip_items(RESUME_TRIPS)
    rec = RecoveryConfig(dir=str(root), snapshot_every=1, fsync=False)
    plan = FaultPlan(lanes=lanes0, preempt_at_segment=preempt_at)
    eng = make_eng(lanes0, chained)
    got0 = []
    with pytest.raises(PreemptionError):
        eng.run(items, got0.append, continuous=True, recovery=rec,
                on_segment=plan.preempt_hook(mode="raise"))
    eng2 = make_eng(lanes1, chained)
    got = stream(eng2, items, recovery=rec, resume=True)
    return got0, eng2, got


@pytest.mark.parametrize("lanes0,lanes1,chained", [
    (4, 2, True), (2, 4, True), (4, 3, False)])
def test_elastic_resume_equals_reference(tmp_path, lanes0, lanes1,
                                         chained):
    def jmake(lanes, chained):
        return JS.FarmEngine(jcount(), lanes=lanes, segment=2,
                             chained=chained)

    def tmake(lanes, chained):
        return teng(tcount("cuda"), lanes=lanes, segment=2,
                    chained=chained)
    j0, j_eng, want = preempt_then_resume(tmp_path / "j", jmake, lanes0,
                                          lanes1, chained)
    t0, t_eng, got = preempt_then_resume(tmp_path / "t", tmake, lanes0,
                                         lanes1, chained)
    assert sequence(t0) == sequence(j0)
    assert sequence(got) == sequence(want)
    assert sorted(r.index for r in got) == list(range(len(RESUME_TRIPS)))
    ref = by_index(stream(teng(tcount("cuda"), lanes=4, segment=2),
                          trip_items(RESUME_TRIPS)))
    for r in got:
        assert r.status == "ok"
        torch.testing.assert_close(torch.as_tensor(r.a), ref[r.index].a,
                                   rtol=0, atol=0)
        assert int(r.iters) == int(ref[r.index].iters)
    for key in ("replayed_items", "recovered_occupants", "segments",
                "refills"):
        assert t_eng.stats[key] == j_eng.stats[key], key
    assert t_eng.stats["replayed_items"] == len(t0)
    assert t_eng.stats["recovery_seconds"] > 0
    # a second resume: everything replays from the journal, no work left
    eng3 = teng(tcount("cuda"), lanes=3, segment=2)
    again = stream(eng3, trip_items(RESUME_TRIPS),
                   recovery=RecoveryConfig(dir=str(tmp_path / "t"),
                                           fsync=False), resume=True)
    assert eng3.stats["replayed_items"] == len(RESUME_TRIPS)
    assert sorted(r.index for r in again) == list(range(len(RESUME_TRIPS)))


def test_port_resumes_a_reference_preempted_stream(tmp_path):
    """The reference's snapshot and journal (numpy leaves on disk) resume
    on the port: exactly once, the same results."""
    items = trip_items(RESUME_TRIPS)
    rec = JRec.RecoveryConfig(dir=str(tmp_path), snapshot_every=1,
                              fsync=False)
    eng = JS.FarmEngine(jcount(), lanes=4, segment=2)
    got0 = []
    with pytest.raises(JRec.PreemptionError):
        eng.run(items, got0.append, continuous=True, recovery=rec,
                on_segment=JFa.FaultPlan(
                    lanes=4, preempt_at_segment=5).preempt_hook("raise"))
    t_eng = teng(tcount("cuda"), lanes=2, segment=2)
    got = stream(t_eng, items, recovery=RecoveryConfig(
        dir=str(tmp_path), snapshot_every=1, fsync=False), resume=True)
    assert sorted(r.index for r in got) == list(range(len(items)))
    assert t_eng.stats["replayed_items"] == len(got0) > 0
    assert t_eng.stats["recovered_occupants"] > 0
    ref = by_index(stream(teng(tcount("cuda"), lanes=4, segment=2), items))
    for r in got:
        assert int(r.iters) == int(ref[r.index].iters) == \
            RESUME_TRIPS[r.index]
        np.testing.assert_array_equal(np.asarray(r.a),
                                      ref[r.index].a.numpy())


def test_snapshot_and_restore_api(tmp_path):
    items = trip_items(RESUME_TRIPS)
    eng = teng(tcount("cuda"), lanes=2, segment=2)
    with pytest.raises(ValueError, match="nothing has streamed"):
        eng.snapshot()
    taken = []

    def on_segment(n):
        if n == 3:
            taken.append(eng.snapshot())
            raise PreemptionError("stop")
    first = []
    with pytest.raises(PreemptionError):
        eng.run(items, first.append, continuous=True, on_segment=on_segment)
    (state,) = taken
    assert state["kind"] == "farm" and not state["complete"]
    eng2 = teng(tcount("cuda"), lanes=3, segment=2).restore(state)
    rest = stream(eng2, items)
    done = {r.index for r in first}
    assert sorted({r.index for r in rest} | done) == list(range(len(items)))
    with pytest.raises(ValueError, match="not a FarmEngine"):
        eng2.restore({"kind": "serve"})


_CHILD = textwrap.dedent("""
    import json, os, sys
    import numpy as np
    sys.path.insert(0, {src!r})
    from repro_torch.core.pattern import LoopOfStencilReduce
    from repro_torch.core.streaming import FarmEngine
    from repro_torch.resilience import FaultPlan, RecoveryConfig

    loop = LoopOfStencilReduce(
        f=lambda get, *_: get(0, 0) - 1.0, k=1, combine="max",
        cond=lambda r: r < 0.5, boundary="zero", max_iters=64,
        backend="torch", device="cpu")
    base = np.linspace(0.1, 0.9, 8 * 128, dtype=np.float32).reshape(8, 128)
    items = [base + float(t) - 1.0 for t in {trips}]
    rec = RecoveryConfig(dir={recdir!r}, snapshot_every=1, fsync=False)
    resume = os.path.exists(rec.journal_path)
    # the kill arms on the first launch only
    hook = None if resume else FaultPlan(
        lanes=3, preempt_at_segment=3).preempt_hook()
    out = open({outpath!r}, "a")
    def sink(r):
        out.write(json.dumps({{"index": int(r.index), "status": r.status,
                               "iters": int(r.iters),
                               "sum": float(r.a.sum())}}) + "\\n")
        out.flush()
    FarmEngine(loop, lanes=3, segment=2, device="cpu").run(
        items, sink, continuous=True, recovery=rec, resume=resume,
        on_segment=hook)
    out.close()
""")


def test_kill_and_respawn_is_exactly_once(tmp_path):
    """One child process dies by ``os._exit(PREEMPTED_EXIT)`` at segment
    3; ``run_to_completion`` respawns it, and the resumed child finishes
    the stream: every index's final record is the uninterrupted run's."""
    import json
    outpath = str(tmp_path / "emitted.jsonl")
    code = _CHILD.format(src=str(SRC), trips=RESUME_TRIPS,
                         recdir=str(tmp_path / "rec"), outpath=outpath)
    restarts = run_to_completion([sys.executable, "-c", code],
                                 max_restarts=2, timeout=300)
    assert restarts == 1
    recs = [json.loads(line) for line in Path(outpath).read_text()
            .splitlines()]
    final = {r["index"]: r for r in recs}
    assert sorted(final) == list(range(len(RESUME_TRIPS)))
    ref = by_index(stream(teng(tcount(), lanes=3, segment=2),
                          trip_items(RESUME_TRIPS)))
    for i, r in final.items():
        assert r["status"] == "ok" and r["iters"] == RESUME_TRIPS[i]
        assert r["sum"] == float(ref[i].a.sum())
    for r in recs:                  # replays are the journaled records
        assert r == final[r["index"]]
    with pytest.raises(RuntimeError, match="not a preemption"):
        run_to_completion([sys.executable, "-c", "raise SystemExit(3)"],
                          timeout=60)


def test_subprocess_env_is_clean():
    """The child above imports the port alone: no JAX on its path."""
    out = subprocess.run(
        [sys.executable, "-c", f"import sys; sys.path.insert(0, {str(SRC)!r})"
         "; import repro_torch.core.streaming, repro_torch.resilience; "
         "print('jax' in sys.modules)"],
        capture_output=True, text=True, timeout=120, check=True)
    assert out.stdout.strip() == "False"
