"""Port parity: the streaming farm over a device mesh — ``FarmEngine(mesh=
...)`` with lanes over a mesh axis on the single-device backends, and the
composed lanes x spatial farm on ``"cuda-sharded"`` — against the JAX
package's ``FarmEngine`` on the same meshes.

The JAX side needs eight XLA devices, so ONE module-scoped fixture runs one
subprocess with ``--xla_force_host_platform_device_count=8`` that computes
every JAX case (meshes from ``repro.sharding.specs.make_mesh``, whose
``Auto`` axes let the farm's host gather run) and writes the results to a
``.json`` and an ``.npz``.  The port runs on meshes that repeat the CPU
device (``["cpu"] * 4`` as ``(4,)``, ``["cpu"] * 8`` as ``(2, 4)``), its
kernel backends' wrappers running their plain versions (the device check
is bypassed, as in ``tests/test_torch_sharded.py``).

Exact: the emission sequence (index, status, attempts, iters), the
engines' ``lane_steps`` / ``wasted_lane_steps`` / ``segments`` and fault
counters, and the countdown streams' ``max`` reduces.  Grids within 1e-5,
and the float stencils' reduces within 1e-6 (their deltas differ in the
last bits between the packages).  Covered: round, classic
and chained streams on the lane mesh (the reference's ``"jnp"`` against
``"torch"`` and the kernel backends), round and continuous streams on the
composed 2x4 mesh (``"pallas-sharded"`` against ``"cuda-sharded"``) at T =
1 and 4 with diagonal taps and env fields, uniform / bimodal / straggler
trip counts, a fault plan with retries, a NaN contained to its lane, kill
and resume on the same mesh and onto one device with the snapshot and
journal crossing between the packages both ways, ``local_slot`` and the
reference's ``ValueError``\\ s.
"""
import json
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import pattern as JP  # noqa: E402
from repro.core import streaming as JS  # noqa: E402
from repro.resilience import recovery as JRec  # noqa: E402
from repro_torch.core import pattern as TP  # noqa: E402
from repro_torch.core import streaming as TS  # noqa: E402
from repro_torch.core.reduce import Sentinel  # noqa: E402
from repro_torch.kernels import ref as TR  # noqa: E402
from repro_torch.resilience import (FaultPlan, PreemptionError,  # noqa: E402
                                    RecoveryConfig)
from repro_torch.sharding import (GridPartition, local_slot,  # noqa: E402
                                  make_mesh)

ROOT = Path(__file__).resolve().parents[1]
SHAPE = (32, 64)
LOPSIDED = [[0.0, 0.0, 0.3], [0.2, 0.25, 0.0], [0.0, 0.25, 0.0]]
SPREADS = {"uniform": [6] * 8,
           "bimodal": [1, 20, 1, 1, 20, 1, 1, 1, 1, 1, 1, 1],
           "straggler": [2, 2, 2, 20, 2, 2, 2, 2]}
SCALES = (1.0, 5.0, 0.1, 2.0, 0.5, 3.0, 0.25, 4.0)
LANE_FAULTS = dict(nan_events=((1, 2),), stall_events=((0, 3),))
RESUME_TRIPS = [3, 9, 5, 7, 4, 6]

# (key, deployment, stencil, items, mode, unroll, segment): "lane" is 8
# lanes over the (4,) mesh axis "data"; "comp" 4 lanes over "data" of a
# (2, 4) mesh, each frame split by rows over "model"
CASES = (
    [(f"lane-{s}-{m}", "lane", "count", s, m, 1, 3)
     for s in SPREADS for m in ("round", "classic", "chained")]
    + [("lane-lop-round-T4", "lane", "lop", "scaled", "round", 4, 3),
       ("lane-lop-chained-T4", "lane", "lop", "scaled", "chained", 4, 2),
       ("lane-faults-classic", "lane", "faults", "spread6", "classic", 1,
        3),
       ("lane-faults-chained", "lane", "faults", "spread6", "chained", 1,
        3)]
    + [(f"comp-{s}-{m}", "comp", "count", s, m, 1, 3)
       for s in SPREADS for m in ("round", "classic")]
    + [(f"comp-lop-{m}-T{T}", "comp", "lop", "scaled", m, T, 3)
       for T in (1, 4) for m in ("round", "classic")]
    + [("comp-restore-round-T1", "comp", "restore", "scaled", "round", 1,
        3),
       ("comp-restore-chained-T4", "comp", "restore", "scaled", "chained",
        4, 3),
       ("comp-nan-classic", "comp", "nan", "nan", "classic", 1, 4)])
CASE = {c[0]: c for c in CASES}
# the kill-and-resume streams (countdown, segment 2), killed where some
# results are journaled already (the chained drain lags a segment)
KILL_AT = {"kill-comp": 3, "kill-lane": 5}
CASE["kill-comp"] = ("kill-comp", "comp", "count", "", "classic", 1, 2)
CASE["kill-lane"] = ("kill-lane", "lane", "count", "", "chained", 1, 2)
# the port's backends for each case: the plain loop and the kernel one
PORT_CASES = (
    [(c[0], "torch") for c in CASES if c[1] == "lane"]
    + [(c[0], "cuda" if c[5] == 1 else "cuda-multistep")
       for c in CASES if c[1] == "lane"]
    + [(c[0], "cuda-sharded") for c in CASES if c[1] == "comp"])

JAX_MESH = textwrap.dedent("""
    import json, shutil, sys
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro.core import FarmEngine, GridPartition, LoopOfStencilReduce
    from repro.core.reduce import Sentinel
    from repro.kernels import ref as R
    from repro.resilience import FaultPlan, PreemptionError, RecoveryConfig
    from repro.sharding.specs import local_slot, make_mesh, shard_map

    out_path, spec = sys.argv[1], json.loads(sys.argv[2])
    SHAPE = tuple(spec["shape"])
    m4 = make_mesh((4,), ("data",))
    m24 = make_mesh((2, 4), ("data", "model"))
    part = GridPartition(mesh=m24, axis_names=("model",), array_axes=(0,))

    def countdown(get, *_):
        return get(0, 0) - 1.0

    def lopsided(get, *_):
        return (0.3 * get(-1, 1) + 0.25 * get(1, 0) + 0.2 * get(0, -1)
                + 0.25 * get(0, 0))

    def trip_items(trips):
        base = np.linspace(0.1, 0.9, SHAPE[0] * SHAPE[1],
                           dtype=np.float32).reshape(SHAPE)
        return [base + float(t) - 1.0 for t in trips]

    def items_of(name):
        if name == "scaled":
            u = np.random.default_rng(0).normal(size=SHAPE).astype(
                np.float32)
            return [u * s for s in spec["scales"]]
        if name == "spread6":
            return trip_items([3, 9, 5, 7, 4, 6, 2, 8])
        if name == "nan":
            items = trip_items([3, 9, 5, 7, 4, 6])
            items[1][20, 33] = np.nan
            return items
        return trip_items(spec["spreads"][name])

    def prep(item):
        return item, (item, (item > 1.0).astype(jnp.float32))

    def loop(fn, deploy, unroll):
        backend = ("jnp" if deploy == "lane" else "pallas-sharded")
        kw = dict(k=1, combine="max", boundary="zero", max_iters=24,
                  unroll=unroll, backend=backend, interpret=True,
                  block=(16, 128),
                  partition=part if deploy == "comp" else None)
        if fn in ("count", "faults", "nan"):
            kw["sentinel"] = Sentinel(nan=True) if fn != "count" else None
            return LoopOfStencilReduce(f=countdown,
                                       cond=lambda r: r < 0.5, **kw)
        if fn == "lop":
            return LoopOfStencilReduce(f=lopsided, delta=R.abs_delta,
                                       cond=lambda r: r < 2e-3, **kw)
        kw["boundary"] = "reflect"
        return LoopOfStencilReduce(f=R.restore_taps(2.0),
                                   delta=R.abs_delta,
                                   cond=lambda r: r < 1e-3, **kw)

    def engine(key, deploy, fn, mode, unroll, segment):
        lp = loop(fn, deploy, unroll)
        kw = dict(segment=segment, chained=mode == "chained")
        if fn == "faults":
            lp = FaultPlan(lanes=2, **spec["lane_faults"]).instrument(lp)
            kw["max_attempts"] = 2
        if fn == "nan":
            kw["check_finite"] = False
        if fn == "restore":
            kw["prep"] = prep
        if deploy == "lane":
            return FarmEngine(lp, lanes=8, mesh=m4, **kw)
        return FarmEngine(lp, lanes=4, mesh=m24, **kw)

    KEYS = ("lane_steps", "wasted_lane_steps", "segments", "refills",
            "retries", "rejected", "quarantined_slots",
            "quarantined_lane_steps")
    res, grids = {}, {}

    def record(key, eng, got, cont):
        if cont:
            seq = [[int(r.index), r.status, int(r.attempts),
                    int(r.iters)] for r in got]
            byi = {int(r.index): r for r in got}
        else:
            seq = [[i, "", 1, int(r.iters)] for i, r in enumerate(got)]
            byi = dict(enumerate(got))
        eng.lane_steps
        res[key] = {"seq": seq,
                    "stats": {k: int(eng.stats[k]) for k in KEYS},
                    "dead": sorted(int(r.index) for r in eng.dead_letter)}
        for i, r in byi.items():
            if r.a is not None:
                grids[f"{key}/a{i}"] = np.asarray(r.a)
                grids[f"{key}/r{i}"] = np.asarray(r.reduced)

    for key, deploy, fn, items, mode, unroll, segment in spec["cases"]:
        eng = engine(key, deploy, fn, mode, unroll, segment)
        got, cont = [], mode != "round"
        eng.run(items_of(items), got.append, continuous=cont)
        record(key, eng, got, cont)

    # kill and resume: the composed mesh (classic) and the lane mesh
    # (chained), killed at KILL_AT; the snapshot and journal stay for
    # the port, and the resumed run's sequence is recorded
    for key, deploy, mode in (("kill-comp", "comp", "classic"),
                              ("kill-lane", "lane", "chained")):
        items = trip_items(spec["resume_trips"])
        rec = RecoveryConfig(dir=spec["dirs"][key], snapshot_every=1,
                             fsync=False)
        first = []
        try:
            engine(key, deploy, "count", mode, 1, 2).run(
                items, first.append, continuous=True, recovery=rec,
                on_segment=FaultPlan(
                    lanes=1, preempt_at_segment=spec["kill_at"][key])
                .preempt_hook(mode="raise"))
            raise AssertionError("the preemption never fired")
        except PreemptionError:
            pass
        shutil.copytree(spec["dirs"][key], spec["dirs"][key] + "-port")
        eng = engine(key, deploy, "count", mode, 1, 2)
        got = []
        eng.run(items, got.append, continuous=True, recovery=rec,
                resume=True)
        record(key, eng, got, True)
        res[key]["first"] = [[int(r.index), r.status, int(r.attempts),
                              int(r.iters)] for r in first]

    # local_slot on each lane shard of the (4,) mesh
    f = shard_map(lambda i: jnp.stack(local_slot(i[0], 2, "data"))[None]
                  .astype(jnp.int32), mesh=m4, in_specs=(P(),),
                  out_specs=P("data"))
    res["local_slot"] = [np.asarray(f(jnp.asarray([i]))).tolist()
                         for i in range(8)]
    np.savez(out_path + ".npz", **grids)
    with open(out_path + ".json", "w") as fh:
        json.dump(res, fh)
""")


@pytest.fixture(scope="module")
def jax_mesh(tmp_path_factory):
    root = tmp_path_factory.mktemp("jax_mesh")
    out = root / "cases"
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    dirs = {k: str(root / k) for k in ("kill-comp", "kill-lane")}
    spec = json.dumps({"cases": CASES, "shape": SHAPE, "spreads": SPREADS,
                       "scales": SCALES, "lane_faults": LANE_FAULTS,
                       "resume_trips": RESUME_TRIPS, "dirs": dirs,
                       "kill_at": KILL_AT})
    run = subprocess.run([sys.executable, "-c", JAX_MESH, str(out), spec],
                         env=env, capture_output=True, text=True,
                         timeout=400)
    assert run.returncode == 0, run.stderr[-3000:]
    with open(str(out) + ".json") as fh:
        res = json.load(fh)
    return SimpleNamespace(res=res, grids=dict(np.load(str(out) + ".npz")),
                           dirs=dirs)


@pytest.fixture(autouse=True)
def plain_kernels(monkeypatch):
    """Let the kernel backends be built on the CPU, where every kernel
    wrapper runs its plain version (only the device checks of the loop
    and of the mesh's devices stop them)."""
    for mod in (TP, TS):
        monkeypatch.setattr(mod, "resolve_backend",
                            lambda b, d: b or "torch")


# ---------------------------------------------------------------------------
# the port's side of a case
# ---------------------------------------------------------------------------


def countdown(get, *_):
    return get(0, 0) - 1.0


def trip_items(trips):
    base = np.linspace(0.1, 0.9, SHAPE[0] * SHAPE[1],
                       dtype=np.float32).reshape(SHAPE)
    return [base + float(t) - 1.0 for t in trips]


def items_of(name):
    if name == "scaled":
        u = np.random.default_rng(0).normal(size=SHAPE).astype(np.float32)
        return [u * s for s in SCALES]
    if name == "spread6":
        return trip_items([3, 9, 5, 7, 4, 6, 2, 8])
    if name == "nan":
        items = trip_items([3, 9, 5, 7, 4, 6])
        items[1][20, 33] = np.nan
        return items
    return trip_items(SPREADS[name])


def tprep(item):
    return item, (item, (item > 1.0).to(torch.float32))


def meshes():
    m4 = make_mesh((4,), ("data",), devices=["cpu"] * 4)
    m24 = make_mesh((2, 4), ("data", "model"), devices=["cpu"] * 8)
    return m4, m24, GridPartition(m24, ("model",), (0,))


def tloop(fn, backend, unroll, part=None):
    kw = dict(k=1, combine="max", boundary="zero", max_iters=24,
              unroll=unroll, backend=backend, partition=part,
              device=None if part is not None else "cpu")
    if fn in ("count", "faults", "nan"):
        kw["sentinel"] = Sentinel(nan=True) if fn != "count" else None
        return TP.LoopOfStencilReduce(f=countdown, cond=lambda r: r < 0.5,
                                      **kw)
    if fn == "lop":
        return TP.LoopOfStencilReduce(f=TR.conv_taps(LOPSIDED),
                                      delta=TR.abs_delta,
                                      cond=lambda r: r < 2e-3, **kw)
    kw["boundary"] = "reflect"
    return TP.LoopOfStencilReduce(f=TR.restore_taps(2.0), delta=TR.abs_delta,
                                  cond=lambda r: r < 1e-3, **kw)


def tengine(key, backend, mesh=None, lanes=None, **extra):
    """The port's engine for case ``key`` on ``backend`` (the lane mesh or
    the composed one from the case, unless ``mesh`` is given)."""
    _, deploy, fn, _, mode, unroll, segment = CASE[key]
    m4, m24, part = meshes()
    lp = tloop(fn, backend, unroll,
               part if backend == "cuda-sharded" else None)
    kw = dict(segment=segment, chained=mode == "chained", device="cpu")
    if fn == "faults":
        lp = FaultPlan(lanes=2, **LANE_FAULTS).instrument(lp)
        kw["max_attempts"] = 2
    if fn == "nan":
        kw["check_finite"] = False
    if fn == "restore":
        kw["prep"] = tprep
    kw.update(extra)
    if mesh is None:
        mesh = m4 if deploy == "lane" else m24
    if lanes is None:
        lanes = 8 if deploy == "lane" else 4
    return TS.FarmEngine(lp, lanes=lanes, mesh=mesh, **kw)


def trun(eng, items, continuous, **kw):
    """Run a stream; every index exactly once."""
    got = []
    n = eng.run(items, got.append, continuous=continuous, **kw)
    assert n == len(got) == len(items)
    if continuous:
        assert sorted(int(r.index) for r in got) == list(range(len(items)))
    return got


def sequence(got, continuous=True):
    if not continuous:
        return [[i, "", 1, int(r.iters)] for i, r in enumerate(got)]
    return [[int(r.index), r.status, int(r.attempts), int(r.iters)]
            for r in got]


STAT_KEYS = ("lane_steps", "wasted_lane_steps", "segments", "refills",
             "retries", "rejected", "quarantined_slots",
             "quarantined_lane_steps")


def check_case(j, key, eng, got, continuous):
    """The port's stream against the reference's case ``key``."""
    want = j.res[key]
    assert sequence(got, continuous) == want["seq"]
    eng.lane_steps                                  # flush round mode
    assert {k: eng.stats[k] for k in STAT_KEYS} == want["stats"]
    assert sorted(int(r.index) for r in eng.dead_letter) == want["dead"]
    pairs = (((int(r.index), r) for r in got) if continuous
             else enumerate(got))
    for i, r in pairs:
        if r.a is None:
            assert f"{key}/a{i}" not in j.grids
            continue
        np.testing.assert_allclose(np.asarray(r.a), j.grids[f"{key}/a{i}"],
                                   atol=1e-5, rtol=0, equal_nan=True)
        # the countdown's values are exact in both packages, so its max
        # reduce is too; a float stencil's deltas differ in the last bits
        np.testing.assert_allclose(
            np.asarray(r.reduced), j.grids[f"{key}/r{i}"], rtol=0,
            atol=0 if CASE[key][2] in ("count", "faults", "nan") else 1e-6)


# ---------------------------------------------------------------------------
# the streams, case by case
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("key,backend", PORT_CASES)
def test_mesh_stream_matches_reference(jax_mesh, key, backend):
    _, deploy, fn, items, mode, unroll, _ = CASE[key]
    eng = tengine(key, backend)
    cont = mode != "round"
    got = trun(eng, items_of(items), cont)
    check_case(jax_mesh, key, eng, got, cont)
    if backend != "torch":
        # nothing was re-allocated across the stream
        assert eng.buffer_pointers() == eng.bound_pointers
    if deploy == "comp" and mode == "chained":
        # the composed farm takes the classic loop even when chained
        assert not eng._rings


def test_lane_shards_run_their_own_segments(jax_mesh):
    """On the lane mesh each shard exits its segment on its own (the
    per-shard step counts differ), so the stats are the sum of the
    shards' own barriers — not a global one, which would book more
    waste; the composed farm's global barrier books more still."""
    lane = jax_mesh.res["lane-bimodal-classic"]["stats"]
    comp = jax_mesh.res["comp-bimodal-classic"]["stats"]
    eng = tengine("lane-bimodal-classic", "cuda")
    segs = []
    real = eng._segment_body

    def spy(*a):
        out = real(*a)
        segs.append(list(out[-1]))
        return out
    eng._segment_body = spy
    trun(eng, items_of("bimodal"), True)
    assert len(segs) == lane["segments"]
    assert all(len(s) == 4 for s in segs)
    assert any(len(set(s)) > 1 for s in segs), segs
    assert eng.stats["wasted_lane_steps"] == lane["wasted_lane_steps"]
    # one global barrier over the 8 lanes would book max-steps for all
    global_waste = sum(max(s) for s in segs) * 8 - (
        lane["lane_steps"] - lane["wasted_lane_steps"])
    assert global_waste > lane["wasted_lane_steps"]
    assert comp["wasted_lane_steps"] / comp["lane_steps"] > \
        lane["wasted_lane_steps"] / lane["lane_steps"]


def test_composed_segments_run_fixed_steps_and_read_nothing(monkeypatch):
    """Composed continuous segments run exactly ``segment`` done-masked
    steps on every lane shard and read no exit flag (the reference's
    ``early_exit=False``), and one launch a spatial shard covers each lane
    shard's whole stack a step."""
    from repro_torch.kernels import stencil2d as TK
    calls = []
    real = TK.stencil2d_fused_framed

    def counted(frame, *a, **k):
        calls.append(tuple(frame.shape))
        return real(frame, *a, **k)
    monkeypatch.setattr(TK, "stencil2d_fused_framed", counted)
    eng = tengine("comp-straggler-classic", "cuda-sharded")
    got = trun(eng, items_of("straggler"), True)
    # the classic loop's four reads a segment and one an emission only
    assert eng.stats["host_reads"] == 4 * eng.stats["segments"] + len(got)
    assert eng.stats["lane_steps"] == eng.stats["segments"] * 3 * 4
    body_steps = eng.stats["segments"] * 3
    assert len(calls) == body_steps * 2 * 4       # 2 lane x 4 row shards
    assert set(calls) == {(2, 10, 66)}            # 2 lanes, 8x64 + ghosts


# ---------------------------------------------------------------------------
# faults: a NaN contained to its lane; kill and resume across packages
# ---------------------------------------------------------------------------


def test_nan_contained_to_its_lane(jax_mesh):
    """A NaN planted in one cell of one item of a composed stream spreads
    through that lane's exchange only: the item is quarantined as
    poisoned, every other item is bit-equal to a fault-free run."""
    got = {int(r.index): r for r in trun(
        tengine("comp-nan-classic", "cuda-sharded"), items_of("nan"),
        True)}
    clean = trip_items([3, 9, 5, 7, 4, 6])
    ref = {int(r.index): r for r in trun(
        tengine("comp-nan-classic", "cuda-sharded"), clean, True)}
    assert got[1].status == "poisoned" and int(got[1].iters) < 24
    for i, r in got.items():
        if i == 1:
            continue
        assert r.status == "ok"
        torch.testing.assert_close(r.a, ref[i].a, rtol=0, atol=0)
        assert bool(torch.isfinite(r.reduced))


def kill(eng, items, root, at):
    rec = RecoveryConfig(dir=str(root), snapshot_every=1, fsync=False)
    first = []
    with pytest.raises(PreemptionError):
        eng.run(items, first.append, continuous=True, recovery=rec,
                on_segment=FaultPlan(lanes=1, preempt_at_segment=at)
                .preempt_hook(mode="raise"))
    return first, rec


@pytest.mark.parametrize("key,backend", [("kill-comp", "cuda-sharded"),
                                         ("kill-lane", "cuda")])
def test_kill_and_resume_on_the_same_mesh(jax_mesh, tmp_path, key,
                                          backend):
    """Killed mid-stream and resumed on the same mesh: the first run and
    the resumed run emit the reference's sequences, every index once."""
    want = jax_mesh.res[key]
    items = trip_items(RESUME_TRIPS)
    first, rec = kill(tengine(key, backend), items, tmp_path, KILL_AT[key])
    assert sequence(first) == want["first"]
    eng = tengine(key, backend)
    got = trun(eng, items, True, recovery=rec, resume=True)
    assert sequence(got) == want["seq"]
    assert eng.stats["replayed_items"] == len(first)
    assert eng.stats["recovered_occupants"] > 0
    for r in got:
        np.testing.assert_array_equal(np.asarray(r.a),
                                      jax_mesh.grids[f"{key}/a{r.index}"])


@pytest.mark.parametrize("key", ["kill-comp", "kill-lane"])
def test_reference_mesh_snapshot_resumes_on_the_port(jax_mesh, key):
    """The reference's mesh snapshot and journal resume on the port: on
    its own kind of mesh and onto one device (elastic), exactly once,
    with the reference's results."""
    items = trip_items(RESUME_TRIPS)
    deploy = "comp" if key == "kill-comp" else "lane"
    for target in ("mesh", "one device"):
        src = jax_mesh.dirs[key] + "-port"
        root = f"{src}-{target.replace(' ', '-')}"
        shutil.copytree(src, root)
        rec = RecoveryConfig(dir=root, snapshot_every=1, fsync=False)
        if target == "mesh":
            eng = tengine(key, "cuda-sharded" if deploy == "comp"
                          else "cuda")
        else:
            eng = TS.FarmEngine(tloop("count", "cuda", 1), lanes=4,
                                segment=2, device="cpu")
        got = trun(eng, items, True, recovery=rec, resume=True)
        assert eng.stats["replayed_items"] > 0
        assert eng.stats["recovered_occupants"] > 0
        for r in got:
            assert (r.status, int(r.iters)) == ("ok", RESUME_TRIPS[r.index])
            np.testing.assert_array_equal(
                np.asarray(r.a), jax_mesh.grids[f"{key}/a{r.index}"])


def test_port_mesh_snapshot_resumes_on_the_reference(jax_mesh, tmp_path):
    """The other way: the port's composed farm killed mid-stream leaves a
    logical snapshot and journal that the reference's single-device
    engine resumes, exactly once, with the same results."""
    items = trip_items(RESUME_TRIPS)
    first, _ = kill(tengine("kill-comp", "cuda-sharded"), items, tmp_path,
                    KILL_AT["kill-comp"])
    jl = JP.LoopOfStencilReduce(f=countdown, k=1, combine="max",
                                cond=lambda r: r < 0.5, boundary="zero",
                                max_iters=24, backend="jnp")
    eng = JS.FarmEngine(jl, lanes=3, segment=2)
    got = []
    eng.run(items, got.append, continuous=True, resume=True,
            recovery=JRec.RecoveryConfig(dir=str(tmp_path),
                                         snapshot_every=1, fsync=False))
    assert sorted(int(r.index) for r in got) == list(range(len(items)))
    assert eng.stats["replayed_items"] == len(first) > 0
    assert eng.stats["recovered_occupants"] > 0
    for r in got:
        assert int(r.iters) == RESUME_TRIPS[r.index]
        np.testing.assert_array_equal(
            np.asarray(r.a), jax_mesh.grids[f"kill-comp/a{r.index}"])


# ---------------------------------------------------------------------------
# the mesh helpers and the reference's refusals
# ---------------------------------------------------------------------------


def test_local_slot_matches_reference(jax_mesh):
    for idx in range(8):
        assert [list(local_slot(idx, 2, s)) for s in range(4)] == \
            [[bool(o), li] for o, li in jax_mesh.res["local_slot"][idx]]


def _message(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    raise AssertionError("no ValueError")


def test_kernel_farm_on_a_cpu_mesh_raises(monkeypatch):
    """Nothing falls back quietly: a kernel backend's lanes on a mesh of
    CPU devices raise instead of running the plain versions there."""
    monkeypatch.undo()
    m4, _, _ = meshes()
    loop = tloop("count", "torch", 1)
    loop.backend = "cuda"
    with pytest.raises(ValueError, match="needs a CUDA device"):
        TS.FarmEngine(loop, lanes=4, mesh=m4, device="cpu")


def test_refusals_match_reference():
    """The reference's ValueErrors, message for message: a lane axis the
    mesh lacks, lanes that do not divide it, a partition axis that is the
    lane axis or is missing from the mesh, a composed farm without a
    mesh.  (The reference reads only ``axis_names`` and ``shape`` of the
    mesh there, so a stand-in serves it.)"""
    from repro.core import GridPartition as JG
    from repro.sharding.specs import make_mesh as j_make_mesh
    jm = j_make_mesh((1,), ("model",))
    jloop = JP.LoopOfStencilReduce(f=countdown, cond=lambda r: True,
                                   backend="pallas-sharded",
                                   partition=JG(mesh=jm,
                                                axis_names=("model",),
                                                array_axes=(0,)))
    jplain = JP.LoopOfStencilReduce(f=countdown, cond=lambda r: True,
                                    backend="jnp")
    m2 = make_mesh((2,), ("data",), devices=["cpu"] * 2)
    mm = make_mesh((1, 1), ("data", "model"), devices=["cpu"])
    tsh = tloop("count", "cuda-sharded", 1,
                GridPartition(mm, ("model",), (0,)))
    tplain = tloop("count", "torch", 1)
    fake = lambda names, shape: SimpleNamespace(axis_names=names,
                                                shape=dict(zip(names,
                                                               shape)))
    for jfn, tfn in [
            (lambda: JS.FarmEngine(jplain, lanes=2,
                                   mesh=fake(("data",), (2,)),
                                   lane_axis="rows"),
             lambda: TS.FarmEngine(tplain, lanes=2, mesh=m2,
                                   lane_axis="rows", device="cpu")),
            (lambda: JS.FarmEngine(jplain, lanes=3,
                                   mesh=fake(("data",), (2,))),
             lambda: TS.FarmEngine(tplain, lanes=3, mesh=m2,
                                   device="cpu")),
            (lambda: JS.FarmEngine(jloop, lanes=1,
                                   mesh=fake(("data", "model"), (1, 1)),
                                   lane_axis="model"),
             lambda: TS.FarmEngine(tsh, lanes=1, mesh=mm,
                                   lane_axis="model", device="cpu")),
            (lambda: JS.FarmEngine(jloop, lanes=2,
                                   mesh=fake(("data",), (2,))),
             lambda: TS.FarmEngine(tsh, lanes=2, mesh=m2, device="cpu")),
            (lambda: JS.FarmEngine(jloop, lanes=2),
             lambda: TS.FarmEngine(tsh, lanes=2, device="cpu"))]:
        assert _message(tfn) == _message(jfn).replace("pallas-", "cuda-")
    # a grid that does not divide the spatial axis fails at the first item
    m24 = make_mesh((2, 4), ("data", "model"), devices=["cpu"] * 8)
    eng = TS.FarmEngine(tloop("count", "cuda-sharded", 1,
                              GridPartition(m24, ("model",), (0,))),
                        lanes=2, mesh=m24, device="cpu")
    with pytest.raises(ValueError, match="divide evenly"):
        eng.run([np.zeros((30, 64), np.float32)], lambda r: None)


@pytest.mark.parametrize("T", [1, 4])
def test_sharded_engine_lane_half_equals_one_grid_a_lane(T):
    """The lane half of ``ShardedStencilEngine`` (what the composed farm
    runs a lane shard): a lane stack a shard, swept with one lane frozen,
    then one slot refilled, equals each lane's own sharded grid, the
    frozen lane unchanged; the per-lane fold equals each grid's fold."""
    from repro_torch.core.executor import ShardedStencilEngine
    from repro_torch.sharding import gather_grid, scatter_grid
    from repro_torch.sharding.specs import slice_partition
    _, _, part = meshes()
    part = slice_partition(part, "data", 1)        # 4 row shards
    kw = dict(f=TR.conv_taps(LOPSIDED), part=part, k=1, boundary="reflect",
              combine="max", delta=TR.abs_delta, unroll=T)
    rng = np.random.default_rng(3)
    stack = torch.as_tensor(rng.normal(size=(3, *SHAPE)).astype(np.float32))
    eng = ShardedStencilEngine(**kw)
    frames, env, sspec = eng.prepare_lanes(scatter_grid(stack, part, 1))
    live = torch.tensor([True, False, True])

    def lanes_of(frs):
        return gather_grid(eng.unframe(frs, sspec), part, batch=1)

    def one_grid(a):
        one = ShardedStencilEngine(**kw)
        fr, ef, sp = one.prepare(scatter_grid(a, part))
        fr, r = one.sweeps(fr, ef, sp)
        return gather_grid(one.unframe(fr, sp), part), r
    frames, r = eng.sweeps(frames, env, sspec, live)
    got = lanes_of(frames)
    for lane in range(3):
        if live[lane]:
            want, rw = one_grid(stack[lane])
            torch.testing.assert_close(got[lane], want, rtol=0, atol=0)
            torch.testing.assert_close(r[lane], rw, rtol=0, atol=0)
        else:
            torch.testing.assert_close(got[lane], stack[lane], rtol=0,
                                       atol=0)
    new = torch.as_tensor(rng.normal(size=SHAPE).astype(np.float32))
    eng.refill_slot(frames, env, 1, scatter_grid(new, part), [], sspec)
    frames, r = eng.sweeps(frames, env, sspec, torch.tensor([False, True,
                                                              False]))
    want, rw = one_grid(new)
    torch.testing.assert_close(lanes_of(frames)[1], want, rtol=0, atol=0)
    torch.testing.assert_close(r[1], rw, rtol=0, atol=0)
