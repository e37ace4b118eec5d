"""The port's CUDA kernels on the card, against their plain versions.

Every test here is marked ``cuda`` and skips without a CUDA device (the
kernels have no CPU mode); the module imports neither JAX nor the JAX
package, so the tests run on a machine with a card and PyTorch alone:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

``chip_smoke.py`` runs the full-size versions of these checks.  Tolerances:
float32 grids within 1e-5 (measured bit-identical), float sums rel 1e-5,
bf16 5e-2 (rtol and atol).  Attention: the kernel against its plain
version within atol 2e-5 in float32 and within one bf16 ulp in bf16
(rtol 1e-2, atol 1e-4: both round nearly the same float32 value once,
as in ``chip_smoke.py`` phase 11); the flash route against the einsum
route within atol 1e-4 on float32 logits (online against dense softmax,
TF32 off).  Decode attention: the kernel against its plain version within
one bf16 ulp (rtol 1e-2, atol 1e-4), as the SWA kernels in bf16.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import pattern as TP
from repro_torch.core.frames import (frame_env, frame_spec, make_frame,
                                     make_lane_frames, refresh_frame)
from repro_torch.kernels import multistep as TM
from repro_torch.kernels import ref as TR
from repro_torch.kernels import stencil2d as TK
from repro_torch.kernels import swa_attention as TS

BOUNDARIES = ["zero", "nan", "reflect", "wrap"]
# mirror-asymmetric weights: the reference test's `lopsided` stencil
LOPSIDED = [[0.0, 0.0, 0.3], [0.2, 0.25, 0.0], [0.0, 0.25, 0.0]]
PORT_FN = {"lopsided": TR.conv_taps(LOPSIDED)}
SCALES = (1.0, 5.0, 0.1, 2.0)


def field(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def mixed_batch(seed=0, n=4, shape=(40, 136)):
    """Stacked items with deliberately different convergence speeds."""
    u0 = field(seed, shape)
    return np.stack([u0 * SCALES[i % len(SCALES)] for i in range(n)])


# ---------------------------------------------------------------------------
# the multistep and single-step kernels
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("boundary", BOUNDARIES)
@pytest.mark.parametrize("name", ["heat", "lopsided", "helmholtz",
                                  "restore", "amf_repl2", "conv7"])
@pytest.mark.parametrize("T", [2, 3])
def test_cuda_multistep_matches_plain(cuda, name, boundary, T):
    w7 = field(14, (7, 7)) * 0.1
    f, n_env = {
        "heat": (TR.heat_taps(0.1), 0),
        "lopsided": (PORT_FN["lopsided"], 0),
        "helmholtz": (TR.helmholtz_jacobi_taps(0.5, 0.2), 1),
        "restore": (TR.restore_taps(2.0), 2),
        "amf_repl2": (TR.amf_detect_taps(2)[1], 0),
        "conv7": (TR.conv_taps(w7), 0)}[name]
    m, n = 100, 130
    spec = frame_spec(m, n, k=f.k, sweeps=T)
    frame = make_frame(torch.as_tensor(field(15, (m, n)), device=cuda),
                       spec, boundary)
    env = tuple(frame_env(torch.as_tensor(field(16 + i, (m, n)),
                                          device=cuda).abs(), spec, boundary,
                          halo=True) for i in range(n_env))
    kw = dict(T=T, env_framed=env, combine="max", measure=TR.abs_delta,
              boundary=boundary)
    before = TK.launch_counts["multistep_sweep"]
    got, red = TM.stencil2d_multistep_framed(frame, f, spec, **kw)
    assert TK.launch_counts["multistep_sweep"] == before + 1
    want, wred = TM.stencil2d_multistep_framed_ref(frame, f, spec, **kw)
    p = spec.pad
    torch.testing.assert_close(got[p:p + m, p:p + n], want[p:p + m, p:p + n],
                               rtol=0, atol=1e-5, equal_nan=True)
    assert torch.equal(red, wred) or (bool(torch.isnan(red))
                                      and bool(torch.isnan(wred)))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["stencil_sweep", "multistep_sweep"])
def test_cuda_lanes_with_a_frozen_lane(cuda, kernel):
    T = 3 if kernel == "multistep_sweep" else 1
    m, n, b = 100, 130, "reflect"
    spec = frame_spec(m, n, k=1, sweeps=T)
    stack = torch.as_tensor(np.stack([field(20 + i, (m, n))
                                      for i in range(3)]), device=cuda)
    frames = make_lane_frames(stack, spec, b)
    live = torch.tensor([True, False, True], device=cuda)
    f = TR.heat_taps(0.1)
    kw = dict(combine="sum", measure=TR.abs_delta, live=live)
    if kernel == "multistep_sweep":
        kw.update(T=T, boundary=b)
        run, ref = TM.stencil2d_multistep_framed, \
            TM.stencil2d_multistep_framed_ref
    else:
        run, ref = TK.stencil2d_fused_framed, TK.stencil2d_fused_framed_ref
    got, red = run(frames, f, spec, **kw)
    want, wred = ref(frames, f, spec, **kw)
    p = spec.pad
    torch.testing.assert_close(got[:, p:p + m, p:p + n],
                               want[:, p:p + m, p:p + n], rtol=0, atol=1e-5)
    assert torch.equal(got[1, p:p + m, p:p + n], frames[1, p:p + m, p:p + n])
    torch.testing.assert_close(red, wred, rtol=1e-5, atol=0)
    assert float(red[1]) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("boundary", BOUNDARIES)
def test_cuda_bf16_kernels_match_plain(cuda, boundary):
    m, n, T = 100, 130, 3
    a = torch.as_tensor(field(30, (m, n)), device=cuda).to(torch.bfloat16)
    e = torch.as_tensor(field(31, (m, n)), device=cuda).to(torch.bfloat16)
    f = TR.helmholtz_jacobi_taps(0.5, 0.2)
    kw = dict(combine="max", measure=TR.abs_delta)
    s1 = frame_spec(m, n, k=1)
    fr1 = make_frame(a, s1, boundary)
    e1 = (frame_env(e, s1, boundary),)
    g1, r1 = TK.stencil2d_fused_framed(fr1, f, s1, env_framed=e1, **kw)
    w1, q1 = TK.stencil2d_fused_framed_ref(fr1, f, s1, env_framed=e1, **kw)
    sT = frame_spec(m, n, k=1, sweeps=T)
    frT = make_frame(a, sT, boundary)
    eT = (frame_env(e, sT, boundary, halo=True),)
    gT, rT = TM.stencil2d_multistep_framed(frT, f, sT, T=T, env_framed=eT,
                                           boundary=boundary, **kw)
    wT, qT = TM.stencil2d_multistep_framed_ref(frT, f, sT, T=T,
                                               env_framed=eT,
                                               boundary=boundary, **kw)
    # the multistep kernel rounds every sweep as T single-step launches do
    cur, nxt = fr1.clone(), torch.empty_like(fr1)
    for _ in range(T):
        nxt, _ = TK.stencil2d_fused_framed(cur, f, s1, env_framed=e1,
                                           out=nxt, **kw)
        refresh_frame(nxt, s1, boundary)
        cur, nxt = nxt, cur
    q = sT.pad
    for got, want in ((g1[1:1 + m, 1:1 + n], w1[1:1 + m, 1:1 + n]),
                      (gT[q:q + m, q:q + n], wT[q:q + m, q:q + n])):
        assert got.dtype == torch.bfloat16
        torch.testing.assert_close(got.float(), want.float(), atol=5e-2,
                                   rtol=5e-2, equal_nan=True)
    torch.testing.assert_close(gT[q:q + m, q:q + n], cur[1:1 + m, 1:1 + n],
                               rtol=0, atol=0, equal_nan=True)
    for got, want in ((r1, q1), (rT, qT)):
        torch.testing.assert_close(got, want, atol=5e-2, rtol=5e-2,
                                   equal_nan=True)


# ---------------------------------------------------------------------------
# farm_run: against its solo runs, one launch for all lanes
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("backend,unroll,key", [
    ("cuda", 1, "stencil_sweep"), ("cuda", 2, "stencil_sweep"),
    ("cuda-multistep", 3, "multistep_sweep")])
def test_cuda_farm_run_matches_solo_runs(cuda, backend, unroll, key):
    batch = torch.as_tensor(mixed_batch(), device=cuda)
    loop = TP.LoopOfStencilReduce(
        f=TR.heat_taps(0.1), k=1, combine="max", cond=lambda r: r < 2e-3,
        delta=TR.abs_delta, boundary="reflect", max_iters=60, unroll=unroll,
        backend=backend, device=cuda)
    before = TK.launch_counts[key]
    got = loop.farm_run(batch)
    launched = TK.launch_counts[key] - before
    iters = got.iters.tolist()
    assert len(set(iters)) > 1
    checks = max(iters) // unroll
    assert launched == checks * (unroll if backend == "cuda" else 1)
    for i in range(len(batch)):
        solo = loop.run(batch[i])
        assert int(solo.iters) == iters[i]
        torch.testing.assert_close(got.a[i], solo.a, rtol=0, atol=1e-5)
    ref = TP.LoopOfStencilReduce(
        f=TR.heat_taps(0.1), k=1, combine="max", cond=lambda r: r < 2e-3,
        delta=TR.abs_delta, boundary="reflect", max_iters=60, unroll=unroll,
        backend="torch", device=cuda).farm_run(batch)
    assert ref.iters.tolist() == iters
    torch.testing.assert_close(got.a, ref.a, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# cuda-sharded: a mesh of the card (and of two cards) against one device
# ---------------------------------------------------------------------------

def sharded_against_single(devices, shape, boundary, T, fn="lopsided"):
    """Run the sharded loop on a 2-D mesh of ``devices`` and the
    single-device kernel loop on the first; assert equal iters, grids
    within 1e-5, equal reduces and one launch a shard a check."""
    from repro_torch.sharding import GridPartition, make_mesh
    rows, cols = (2, 2) if len(devices) == 4 else (len(devices), 1)
    part = GridPartition(make_mesh((rows, cols), ("data", "model"),
                                   devices=devices),
                         ("data", "model"), (0, 1))
    a = torch.as_tensor(field(7, shape), device=devices[0])
    kw = dict(f=PORT_FN[fn], k=1, combine="max", cond=lambda r: r < 1e-4,
              delta=TR.abs_delta, boundary=boundary, max_iters=40,
              unroll=T)
    key = "multistep_sweep" if T > 1 else "stencil_sweep"
    before = TK.launch_counts[key]
    got = TP.LoopOfStencilReduce(backend="cuda-sharded", partition=part,
                                 **kw).run(a)
    launched = TK.launch_counts[key] - before
    single = TP.LoopOfStencilReduce(
        backend="cuda-multistep" if T > 1 else "cuda", device=devices[0],
        **kw).run(a)
    assert int(got.iters) == int(single.iters)
    assert launched == len(devices) * int(got.iters) // T
    assert got.a.device == torch.device(devices[0])
    torch.testing.assert_close(got.a, single.a, rtol=0, atol=1e-5,
                               equal_nan=True)
    torch.testing.assert_close(got.reduced, single.reduced, rtol=0, atol=0,
                               equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("boundary", BOUNDARIES)
@pytest.mark.parametrize("T", [1, 4])
def test_cuda_sharded_mesh_of_one_card_matches_single_device(cuda,
                                                             boundary, T):
    sharded_against_single(["cuda:0"] * 4, (128, 256), boundary, T)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 4])
def test_cuda_sharded_across_two_cards(cuda, T):
    """Shards on two cards: the strips cross by peer copies ordered
    against both cards' streams (no synchronise in the loop)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    sharded_against_single(["cuda:0", "cuda:1"], (128, 256), "reflect", T)


@pytest.mark.cuda
@pytest.mark.parametrize("n,sweeps", [(1024, 200), (4096, 50)])
def test_cuda_stencil_dryrun_jacobi_matches_plain(cuda, n, sweeps):
    """``chip_smoke.py`` phase 22(b) at one pod device's 1024² block (200
    sweeps) and at a whole grid (4096² here, 16384² there; 50 sweeps):
    the dry run's Jacobi on "cuda", one launch a sweep, against the plain
    path on the card — equal iterations, grids within 1e-5."""
    from repro_torch.launch import stencil_dryrun as SD
    u0 = torch.as_tensor(field(40, (n, n)), device=cuda)
    before = TK.launch_counts["stencil_sweep"]
    got = SD.jacobi_loop(sweeps, backend="cuda", device=cuda).run(u0)
    assert TK.launch_counts["stencil_sweep"] - before == sweeps
    want = SD.jacobi_loop(sweeps, backend="torch", device=cuda).run(u0)
    assert int(got.iters) == int(want.iters) == sweeps
    assert float((got.a - want.a).abs().max()) <= 1e-5
    assert abs(float(got.reduced) - float(want.reduced)) <= 1e-5


# ---------------------------------------------------------------------------
# the streaming FarmEngine: chained = classic = solo runs, bit for bit; the
# slot buffers stay where they were allocated; one launch a body step
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("backend,unroll,key", [
    ("cuda", 1, "stencil_sweep"), ("cuda-multistep", 3, "multistep_sweep")])
def test_cuda_stream_chained_equals_classic_and_solo(cuda, backend, unroll,
                                                     key):
    from repro_torch.core.streaming import FarmEngine
    items = [np.abs(x) for x in mixed_batch(n=7)]
    loop = TP.LoopOfStencilReduce(
        f=TR.restore_taps(2.0), k=1, combine="max", cond=lambda r: r < 1e-3,
        delta=TR.abs_delta, boundary="reflect", max_iters=40, unroll=unroll,
        backend=backend, device=cuda)

    def prep(item):
        return item, (item, (item > 1.0).to(item.dtype))
    runs = {}
    for chained in (True, False):
        eng = FarmEngine(loop, lanes=3, prep=prep, segment=4,
                         chained=chained)
        got = []
        before = TK.launch_counts[key]
        assert eng.run(items, got.append, continuous=True) == len(items)
        launched = TK.launch_counts[key] - before
        assert sorted(r.index for r in got) == list(range(len(items)))
        assert eng.buffer_pointers() == eng.bound_pointers
        body_steps = eng.lane_steps // (3 * unroll)
        assert launched == body_steps * (unroll if backend == "cuda" else 1)
        runs[chained] = {r.index: r for r in got}
    assert len({int(r.iters) for r in runs[True].values()}) > 1
    for i, r in runs[True].items():
        s = runs[False][i]
        assert (r.status, int(r.iters)) == (s.status, int(s.iters))
        torch.testing.assert_close(r.a, s.a, rtol=0, atol=0)
        torch.testing.assert_close(r.reduced, s.reduced, rtol=0, atol=0)
        a0, envs = prep(torch.as_tensor(items[i], device=cuda))
        solo = loop.run(a0, env=envs)
        assert int(solo.iters) == int(r.iters)
        torch.testing.assert_close(r.a, solo.a.cpu(), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the streaming FarmEngine over a mesh: lanes over a mesh axis and the
# composed lanes x spatial farm, against single-device solo runs
# ---------------------------------------------------------------------------

def restore_stream(backend, unroll, device, partition=None):
    """The restoration loop, its prep and a stream of items whose trip
    counts differ."""
    items = [np.abs(x) for x in mixed_batch(n=7, shape=(64, 136))]
    loop = TP.LoopOfStencilReduce(
        f=TR.restore_taps(2.0), k=1, combine="max", cond=lambda r: r < 1e-3,
        delta=TR.abs_delta, boundary="reflect", max_iters=40, unroll=unroll,
        backend=backend, partition=partition, device=device)

    def prep(item):
        return item, (item, (item > 1.0).to(item.dtype))
    return loop, prep, items


def mesh_stream_against_solo(mesh, lanes, backend, unroll, continuous,
                             chained=True, partition=None):
    """A FarmEngine stream over ``mesh``: every index once, one launch a
    lane-shard step a spatial shard, and every item equal to its solo run
    on the mesh's first device (iters, and grids and reduces bit for
    bit)."""
    from repro_torch.core.streaming import FarmEngine
    dev = mesh.devices.flat[0]
    loop, prep, items = restore_stream(backend, unroll, dev, partition)
    key = "stencil_sweep" if unroll == 1 else "multistep_sweep"
    eng = FarmEngine(loop, lanes=lanes, prep=prep, segment=4, mesh=mesh,
                     chained=chained, device=dev)
    got, before = [], TK.launch_counts[key]
    assert eng.run(items, got.append, continuous=continuous) == len(items)
    launched = TK.launch_counts[key] - before
    if continuous:
        assert sorted(r.index for r in got) == list(range(len(items)))
        assert eng.buffer_pointers() == eng.bound_pointers
        spatial = partition.n_shards if partition is not None else 1
        shard_steps = eng.lane_steps // (lanes // eng._nshards * unroll)
        assert launched == shard_steps * spatial
    single = TP.LoopOfStencilReduce(
        f=loop.f, k=1, combine="max", cond=loop.cond, delta=loop.delta,
        boundary="reflect", max_iters=40, unroll=unroll,
        backend="cuda" if unroll == 1 else "cuda-multistep", device=dev)
    by_index = ({r.index: r for r in got} if continuous
                else dict(enumerate(got)))
    for i, r in by_index.items():
        a0, envs = prep(torch.as_tensor(items[i], device=dev))
        solo = single.run(a0, env=envs)
        assert int(solo.iters) == int(r.iters)
        torch.testing.assert_close(r.a, solo.a.cpu(), rtol=0, atol=0)
        torch.testing.assert_close(r.reduced.reshape(()),
                                   solo.reduced.cpu(), rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("backend,unroll,continuous,chained", [
    ("cuda", 1, False, True), ("cuda", 1, True, False),
    ("cuda", 1, True, True), ("cuda-multistep", 3, True, True)])
def test_cuda_lane_mesh_stream_equals_solo_runs(cuda, backend, unroll,
                                                continuous, chained):
    from repro_torch.sharding import make_mesh
    mesh = make_mesh((2,), ("data",), devices=["cuda:0"] * 2)
    mesh_stream_against_solo(mesh, 4, backend, unroll, continuous, chained)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 4])
@pytest.mark.parametrize("continuous", [False, True])
def test_cuda_composed_stream_equals_solo_runs(cuda, T, continuous):
    from repro_torch.sharding import GridPartition, make_mesh
    mesh = make_mesh((2, 2), ("data", "model"), devices=["cuda:0"] * 4)
    mesh_stream_against_solo(mesh, 4, "cuda-sharded", T, continuous,
                             partition=GridPartition(mesh, ("model",), (0,)))


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 4])
def test_cuda_composed_stream_across_two_cards(cuda, T):
    """Each lane shard's frame split over two cards: the strips cross by
    peer copies and the per-lane reduces meet on the lead card."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    from repro_torch.sharding import GridPartition, make_mesh
    mesh = make_mesh((2, 2), ("data", "model"),
                     devices=["cuda:0", "cuda:1"] * 2)
    mesh_stream_against_solo(mesh, 4, "cuda-sharded", T, True,
                             partition=GridPartition(mesh, ("model",), (0,)))


# ---------------------------------------------------------------------------
# the kernel's own CTA tile: tiles that do not divide the interior, rows that
# are not 16-byte aligned, the one-slot ring, lane stacks across tiles
# ---------------------------------------------------------------------------

def sweep_functor(name):
    """(elemental, env fields, binary input) of a registered functor."""
    w7 = field(14, (7, 7)) * 0.1
    return {
        "jacobi": (TR.jacobi_taps(0.25), 0, False),
        "helmholtz": (TR.helmholtz_jacobi_taps(0.5, 0.2), 1, False),
        "heat": (TR.heat_taps(0.1), 0, False),
        "sobel": (TR.sobel_taps(), 0, False),
        "gol": (TR.gol_taps(), 0, True),
        "median3": (TR.median3_taps(), 0, False),
        "restore": (TR.restore_taps(2.0), 2, False),
        "conv7": (TR.conv_taps(w7), 0, False),
        "amf_mask3": (TR.amf_detect_taps(3)[0], 0, False),
        "amf_repl3": (TR.amf_detect_taps(3)[1], 0, False),
    }[name]


def inputs(cuda, shape, n_env, binary=False, seed=40):
    a = field(seed, shape)
    a = (a > 0.5).astype(np.float32) if binary else a
    env = [np.abs(field(seed + 1 + i, shape)) for i in range(n_env)]
    if n_env == 2:                     # restore: noisy frame and 0/1 mask
        env[1] = (env[1] > 0.7).astype(np.float32)
    return (torch.as_tensor(a, device=cuda),
            [torch.as_tensor(e, device=cuda) for e in env])


def exact(got, want):
    return torch.equal(torch.nan_to_num(got, nan=7.0),
                       torch.nan_to_num(want, nan=7.0))


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [None, (64, 128), (8, 32, 1)])
@pytest.mark.parametrize("name", ["jacobi", "helmholtz", "heat", "sobel",
                                  "gol", "median3", "restore", "conv7",
                                  "amf_mask3", "amf_repl3"])
def test_cuda_stencil_sweep_on_any_tile_matches_plain(cuda, name, tile):
    # 100x300: the interior is 128x320, which a 64x128 tile does not divide
    # (nor does 32x128 below)
    f, n_env, binary = sweep_functor(name)
    m, n = 100, 300
    a, env = inputs(cuda, (m, n), n_env, binary)
    spec = frame_spec(m, n, k=f.k)
    frame = make_frame(a, spec, "reflect")
    env = tuple(frame_env(e, spec, "reflect") for e in env)
    kw = dict(env_framed=env, combine="sum", measure=TR.abs_delta)
    got, red = TK.stencil2d_fused_framed(frame, f, spec, tile=tile, **kw)
    info = TK.last_launch()
    again, red2 = TK.stencil2d_fused_framed(frame, f, spec, tile=tile, **kw)
    want, wred = TK.stencil2d_fused_framed_ref(frame, f, spec, **kw)
    p = spec.pad
    mi, ni = spec.interior
    assert exact(got[p:p + mi, p:p + ni], want[p:p + mi, p:p + ni])
    torch.testing.assert_close(red, wred, rtol=1e-5, atol=0)
    assert torch.equal(red, red2)                           # fixed order
    assert torch.equal(got[p:p + mi, p:p + ni], again[p:p + mi, p:p + ni])
    if tile is not None:
        assert (info["tm"], info["tn"], info["ring"]) == (tuple(tile)
                                                          + (2,))[:3]
    # do_reduce=False: the same sweep, no fold
    quiet, ident = TK.stencil2d_fused_framed(frame, f, spec, tile=tile,
                                             do_reduce=False, **kw)
    assert torch.equal(quiet[p:p + mi, p:p + ni], got[p:p + mi, p:p + ni])
    assert float(ident) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("boundary", BOUNDARIES)
@pytest.mark.parametrize("tile", [None, (32, 128), (8, 32, 1)])
@pytest.mark.parametrize("name", ["helmholtz", "lopsided", "sobel",
                                  "restore", "amf_repl3"])
def test_cuda_multistep_T4_on_any_tile_matches_plain(cuda, name, tile,
                                                     boundary):
    f, n_env, _ = (sweep_functor(name) if name != "lopsided"
                   else (PORT_FN["lopsided"], 0, False))
    T = 2 if name == "amf_repl3" else 4      # radius 3: kT = 6
    m, n = 100, 300
    a, env = inputs(cuda, (m, n), n_env)
    spec = frame_spec(m, n, k=f.k, sweeps=T)
    frame = make_frame(a, spec, boundary)
    env = tuple(frame_env(e, spec, boundary, halo=True) for e in env)
    kw = dict(T=T, env_framed=env, combine="max", measure=TR.abs_delta,
              boundary=boundary)
    got, red = TM.stencil2d_multistep_framed(frame, f, spec, tile=tile, **kw)
    want, wred = TM.stencil2d_multistep_framed_ref(frame, f, spec, **kw)
    p = spec.pad
    assert exact(got[p:p + m, p:p + n], want[p:p + m, p:p + n])
    assert torch.equal(red, wred) or (bool(torch.isnan(red))
                                      and bool(torch.isnan(wred)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,k,T", [("float32", 1, 3), ("float32", 3, 1),
                                       ("bfloat16", 1, 2),
                                       ("bfloat16", 1, 3)])
def test_cuda_rows_not_16_byte_aligned(cuda, dtype, k, T):
    # row strides of 320 + 2kT elements: 1304 bytes (f32, kT = 3), 648 and
    # 652 bytes (bf16, kT = 2 and 3), none a multiple of 16
    dt = getattr(torch, dtype)
    m, n = 100, 300
    f = TR.heat_taps(0.1) if k == 1 else TR.conv_taps(field(15, (7, 7)) * 0.1)
    a, _ = inputs(cuda, (m, n), 0)
    a = a.to(dt)
    spec = frame_spec(m, n, k=k, sweeps=T)
    frame = make_frame(a, spec, "wrap")
    kw = dict(T=T, combine="sum", measure=TR.abs_delta, boundary="wrap")
    got, red = TM.stencil2d_multistep_framed(frame, f, spec, **kw)
    want, wred = TM.stencil2d_multistep_framed_ref(frame, f, spec, **kw)
    p = spec.pad
    if dt == torch.float32:
        assert exact(got[p:p + m, p:p + n], want[p:p + m, p:p + n])
        torch.testing.assert_close(red, wred, rtol=1e-5, atol=0)
        return
    torch.testing.assert_close(got[p:p + m, p:p + n].float(),
                               want[p:p + m, p:p + n].float(), atol=5e-2,
                               rtol=5e-2)
    # T single-step launches of the bf16 kernel give the same bits
    s1 = frame_spec(m, n, k=k)
    cur = make_frame(a, s1, "wrap")
    nxt = torch.empty_like(cur)
    for _ in range(T):
        nxt, _ = TK.stencil2d_fused_framed(cur, f, s1, combine="sum",
                                           out=nxt)
        refresh_frame(nxt, s1, "wrap")
        cur, nxt = nxt, cur
    assert torch.equal(got[p:p + m, p:p + n], cur[k:k + m, k:k + n])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["helmholtz", "restore"])
@pytest.mark.parametrize("T", [1, 2])
def test_cuda_division_outside_the_fast_range_matches_plain(cuda, name, T):
    # zeros, subnormals, tiny and huge values, inf and nan send groups of
    # cells through the kernel's IEEE re-run (div_fast covers operands in
    # [2^-100, 2^100) only); every cell must still match bit for bit
    f, n_env, _ = sweep_functor(name)
    m, n = 64, 160
    rng = np.random.default_rng(60)
    vals = np.array([0.0, -0.0, 1e-39, -3e-41, 1e-31, 1e30, -3e38, np.inf,
                     np.nan, 0.5, -2.0], dtype=np.float32)
    a = torch.as_tensor(rng.choice(vals, size=(m, n)), device=cuda)
    env = [torch.as_tensor(rng.choice(vals, size=(m, n)), device=cuda)
           for _ in range(n_env)]
    if n_env == 2:
        env[1] = (env[1] > 0).float()
    spec = frame_spec(m, n, k=1, sweeps=T)
    frame = make_frame(a, spec, "zero")
    kw = dict(combine="max", measure=TR.abs_delta)
    if T == 1:
        env = tuple(frame_env(e, spec, "zero") for e in env)
        got, red = TK.stencil2d_fused_framed(frame, f, spec, env_framed=env,
                                             **kw)
        want, wred = TK.stencil2d_fused_framed_ref(frame, f, spec,
                                                   env_framed=env, **kw)
    else:
        env = tuple(frame_env(e, spec, "zero", halo=True) for e in env)
        kw.update(T=T, boundary="zero")
        got, red = TM.stencil2d_multistep_framed(frame, f, spec,
                                                 env_framed=env, **kw)
        want, wred = TM.stencil2d_multistep_framed_ref(frame, f, spec,
                                                       env_framed=env, **kw)
    p = spec.pad
    g, w = got[p:p + m, p:p + n], want[p:p + m, p:p + n]
    assert torch.equal(torch.isnan(g), torch.isnan(w))
    assert torch.equal(torch.nan_to_num(g, nan=7.0, posinf=8.0, neginf=9.0),
                       torch.nan_to_num(w, nan=7.0, posinf=8.0, neginf=9.0))
    assert torch.equal(red, wred) or (bool(torch.isnan(red))
                                      and bool(torch.isnan(wred)))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["stencil_sweep", "multistep_sweep"])
@pytest.mark.parametrize("tile", [(8, 32), (64, 128, 1)])
def test_cuda_lane_stack_across_tiles(cuda, kernel, tile):
    # five lanes, two frozen: a CTA's tiles cross lane boundaries
    T = 3 if kernel == "multistep_sweep" else 1
    m, n, b = 60, 200, "zero"
    spec = frame_spec(m, n, k=1, sweeps=T)
    stack = torch.as_tensor(np.stack([field(50 + i, (m, n))
                                      for i in range(5)]), device=cuda)
    frames = make_lane_frames(stack, spec, b)
    live = torch.tensor([True, False, True, True, False], device=cuda)
    f = TR.heat_taps(0.1)
    kw = dict(combine="sum", measure=TR.abs_delta, live=live)
    if kernel == "multistep_sweep":
        kw.update(T=T, boundary=b)
        run, ref = TM.stencil2d_multistep_framed, \
            TM.stencil2d_multistep_framed_ref
    else:
        run, ref = TK.stencil2d_fused_framed, TK.stencil2d_fused_framed_ref
    got, red = run(frames, f, spec, tile=tile, **kw)
    want, wred = ref(frames, f, spec, **kw)
    p = spec.pad
    assert exact(got[:, p:p + m, p:p + n], want[:, p:p + m, p:p + n])
    for lane in (1, 4):
        assert torch.equal(got[lane, p:p + m, p:p + n],
                           frames[lane, p:p + m, p:p + n])
    torch.testing.assert_close(red, wred, rtol=1e-5, atol=0)
    assert float(red[1]) == 0.0 == float(red[4])


# ---------------------------------------------------------------------------
# sliding-window attention and the LM forward
# ---------------------------------------------------------------------------

def swa_launches():
    return sum(TS.launch_counts.values())


@pytest.fixture
def cuda_f32(cuda, monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return cuda


SWA_CASES = [
    # (B·H, B·KH, S, hd, window, causal, softcap)
    (2, 2, 256, 64, 0, True, 0.0),
    (2, 2, 256, 64, 128, True, 0.0),
    (1, 1, 512, 128, 256, True, 0.0),
    (2, 2, 128, 64, 0, False, 0.0),
    (1, 1, 256, 64, 64, True, 0.0),
    (1, 1, 384, 64, 200, True, 0.0),
    (8, 4, 256, 64, 128, True, 0.0),         # GQA, B=2 H=4 KH=2
    (2, 2, 256, 64, 128, True, 50.0),
    (2, 2, 256, 16, 8, True, 50.0),
    (2, 1, 256, 32, 0, True, 0.0),
    (2, 1, 384, 256, 100, True, 50.0),
    (1, 1, 64, 64, 0, True, 0.0),             # S < 128 tiles by S
    # the wgmma route's edges (bf16 at hd 64/128/256)
    (2, 1, 64, 256, 0, True, 50.0),           # S = 64: half a 128-row q block
    (4, 2, 384, 128, 200, True, 0.0),         # q blocks straddle the band's edge
    (2, 2, 384, 64, 300, True, 50.0),         # windows 200, 300: not tile multiples
    (2, 1, 512, 256, 200, True, 50.0),
    (2, 1, 256, 256, 0, False, 50.0),         # causal = False
    (2, 2, 384, 128, 200, False, 0.0),        # band without the causal mask
    (8, 2, 256, 64, 0, True, 0.0),            # G = 4
    (8, 1, 256, 128, 128, True, 50.0),        # G = 8
    (2, 2, 256, 128, 0, True, 50.0),          # hd 128 with softcap
    # the CUDA-core kernel's structure: 64 rows a CTA (query heads of one
    # kv head x positions), 256-key tiles, a ring of k and v chunks
    (4, 4, 128, 256, 65, True, 50.0),         # G = 1, S = 128: one tile
    (8, 4, 64, 128, 63, True, 0.0),           # G = 2, S = 64
    (3, 1, 384, 64, 200, True, 50.0),         # G = 3: a head a CTA; S = 1.5 tiles
    (16, 1, 640, 32, 1, True, 0.0),           # G = 16: two CTAs of 8 heads
    (8, 1, 640, 256, 300, True, 50.0),        # G = 8: one CTA of 8 heads
    (4, 1, 384, 256, 300, False, 50.0),       # G = 4, band without causal
    (6, 2, 256, 96, 100, True, 50.0),         # hd 96 (bf16: wgmma, padded)
    # bf16 hd 96 on the wgmma route (the hd-128 layout, columns 96-127
    # zero-filled by TMA)
    (8, 2, 384, 96, 0, True, 0.0),            # G = 4
    (4, 1, 64, 96, 0, True, 50.0),            # S = 64: a q block past S
    (4, 4, 512, 96, 200, True, 50.0),         # window no multiple of 64
    (8, 2, 384, 96, 150, False, 0.0),         # G = 4, band without causal
] + [(4, 2, 256, hd, 200, True, cap)          # every head_dim, softcap on/off
     for hd in (16, 32, 64, 96, 128, 256) for cap in (0.0, 50.0)]
SWA_BF16_LIMIT = dict(rtol=1e-2, atol=1e-4)   # one bf16 ulp (phase 11's)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SWA_CASES)
def test_cuda_swa_attention_matches_plain(cuda_f32, case, dtype):
    bh, bkh, S, hd, window, causal, cap = case
    dt = getattr(torch, dtype)
    q, k, v = (torch.as_tensor(field(40 + i, (rows, S, hd)), device=cuda_f32)
               .to(dt) for i, rows in enumerate((bh, bkh, bkh)))
    before = swa_launches()
    got = TS.swa_attention(q, k, v, window=window, causal=causal,
                           softcap=cap)
    torch.cuda.synchronize()
    assert swa_launches() == before + 1
    want = TS.swa_attention_plain(q, k, v, window=window, causal=causal,
                                  softcap=cap)
    assert got.dtype == dt and got.shape == q.shape
    tol = dict(atol=2e-5, rtol=0) if dt == torch.float32 else SWA_BF16_LIMIT
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,hd,route", [
    ("bfloat16", 64, "wgmma"), ("bfloat16", 128, "wgmma"),
    ("bfloat16", 256, "wgmma"), ("bfloat16", 32, "cuda_core"),
    ("bfloat16", 96, "wgmma"), ("float32", 64, "cuda_core"),
    ("float32", 96, "cuda_core"), ("float32", 256, "cuda_core")])
def test_cuda_swa_attention_takes_its_route(cuda_f32, dtype, hd, route):
    dt = getattr(torch, dtype)
    q, k, v = (torch.as_tensor(field(60 + i, (2, 128, hd)), device=cuda_f32)
               .to(dt) for i in range(3))
    before = dict(TS.launch_counts)
    TS.swa_attention(q, k, v, window=64, softcap=50.0)
    torch.cuda.synchronize()
    assert {r: TS.launch_counts[r] - before[r] for r in before} == \
        {r: int(r == route) for r in before}


@pytest.mark.cuda
@pytest.mark.parametrize("group", [1, 2, 4, 8, 16])
def test_cuda_swa_core_launch_at_hd_256(cuda_f32, group):
    """16 warps resident an SM at hd 256; 64 rows a CTA, up to 8 query
    heads of one kv head (more split over CTAs)."""
    q = torch.as_tensor(field(70, (2 * group, 256, 256)), device=cuda_f32)
    k, v = (torch.as_tensor(field(71 + i, (2, 256, 256)), device=cuda_f32)
            for i in range(2))
    TS.swa_attention(q, k, v, window=100, softcap=50.0)
    torch.cuda.synchronize()
    info = TS.last_launch()
    heads = min(group, 8)
    assert info["head_dim"] == 256 and info["warps_per_sm"] >= 16
    assert (info["heads_per_cta"], info["bq"]) == (heads, 64 // heads)
    assert (info["grid_x"], info["grid_y"]) == (256 // (64 // heads),
                                                2 * group // heads)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_swa_refuses_operands_not_16_byte_aligned(cuda_f32, dtype):
    # both kernels copy rows by 16-byte pieces: a view one element in is
    # refused before any launch
    dt = getattr(torch, dtype)
    base = torch.zeros(2 * 128 * 32 + 1, device=cuda_f32, dtype=dt)
    q = base[1:].view(2, 128, 32)
    k, v = (torch.zeros((2, 128, 32), device=cuda_f32, dtype=dt)
            for _ in range(2))
    before = dict(TS.launch_counts)
    with pytest.raises(ValueError, match="16-byte aligned"):
        TS.swa_attention(q, k, v, window=64)
    assert TS.launch_counts == before


@pytest.mark.cuda
def test_cuda_swa_window_one_is_the_identity(cuda_f32):
    q, k, v = (torch.as_tensor(field(50 + i, (1, 128, 64)), device=cuda_f32)
               for i in range(3))
    torch.testing.assert_close(TS.swa_attention(q, k, v, window=1), v,
                               atol=1e-5, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 2])
def test_cuda_forward_routes_agree_and_count_launches(cuda_f32, batch):
    from repro_torch.configs import get_reduced
    from repro_torch.models import attention as TA
    from repro_torch.models import transformer as TT
    cfg = get_reduced("gemma2-9b")
    model = TT.init_params(cfg, seed=0, device=cuda_f32)
    tokens = torch.as_tensor(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (batch, 256)),
        device=cuda_f32)
    before = swa_launches()
    flash, _ = TT.forward(cfg, model, {"tokens": tokens})
    assert swa_launches() - before == cfg.num_layers
    TA.set_flash_swa(False)
    try:
        einsum, _ = TT.forward(cfg, model, {"tokens": tokens})
    finally:
        TA.set_flash_swa(None)
    assert swa_launches() - before == cfg.num_layers
    assert bool(torch.isfinite(flash).all())
    torch.testing.assert_close(flash, einsum, atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_cuda_greedy_equals_teacher_forced_argmax(cuda_f32):
    from repro_torch.configs import get_reduced
    from repro_torch.models import transformer as TT
    from repro_torch.serve import GenerateConfig, generate
    cfg = get_reduced("gemma2-9b")
    model = TT.init_params(cfg, seed=1, device=cuda_f32)
    prompt = np.random.default_rng(1).integers(2, cfg.vocab_size, (2, 120))
    out, lengths, iters = generate(cfg, model, prompt,
                                   GenerateConfig(max_new_tokens=8),
                                   cache_dtype=torch.float32)
    full = torch.cat([torch.as_tensor(prompt, device=cuda_f32),
                      out.long()], dim=1)
    before = swa_launches()
    logits, _ = TT.forward(cfg, model, {"tokens": full})   # 128: flash
    assert swa_launches() - before == cfg.num_layers
    exp = logits[:, 119:-1].argmax(dim=-1)
    for b in range(2):
        L = int(lengths[b])
        assert torch.equal(out[b, :L].long(), exp[b, :L])


# ---------------------------------------------------------------------------
# cached decode attention (csrc/decode_attention.cu): the kernel against its
# plain version, in place over strided pools, inside a CUDA graph, and
# counted by the engine on both its step runners
# ---------------------------------------------------------------------------

# one bf16 ulp: the kernel and the plain version both round one float32
# value (summed in another order) to bf16 once, as SWA_BF16_LIMIT
DECODE_LIMIT = dict(rtol=1e-2, atol=1e-4)
DECODE_CASES = [
    # (B, T, H, KH, hd, window, softcap)
    (4, 300, 2, 2, 64, 0, 0.0),
    (3, 520, 4, 2, 96, 0, 50.0),              # hd 96: 4 of 16 lanes idle
    (5, 256, 8, 2, 128, 100, 0.0),            # G = 4, one split
    (2, 700, 16, 2, 256, 0, 50.0),            # G = 8
    (4, 1000, 4, 1, 256, 300, 0.0),           # window across splits
    (2, 64, 2, 1, 128, 0, 0.0),               # T below a split
    (6, 777, 4, 4, 128, 513, 50.0),
]


def decode_inputs(B, T, H, KH, hd, seed, device):
    """bf16 q (B, 1, H, hd), a pool k, v (B, T, KH, hd) and ragged positions
    with both ends of the pool."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.as_tensor(rng.normal(size=s).astype(np.float32),
                               device=device).to(torch.bfloat16)
               for s in ((B, 1, H, hd), (B, T, KH, hd), (B, T, KH, hd)))
    pos = rng.integers(0, T, B)
    pos[:2] = [0, T - 1][:B]
    return q, k, v, torch.as_tensor(pos, device=device)


def decode_launches():
    from repro_torch.kernels import decode_attention as TD
    return TD.launch_counts["decode_attention"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", DECODE_CASES)
def test_cuda_decode_attention_matches_plain(cuda, case):
    from repro_torch.kernels import decode_attention as TD
    B, T, H, KH, hd, window, cap = case
    q, k, v, pos = decode_inputs(B, T, H, KH, hd, 90, cuda)
    before = decode_launches()
    got = TD.decode_attention(q, k, v, pos, window=window, softcap=cap)
    torch.cuda.synchronize()
    assert decode_launches() == before + 1
    want = TD.decode_attention_plain(q, k, v, pos, window=window,
                                     softcap=cap)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), **DECODE_LIMIT)


@pytest.mark.cuda
def test_cuda_decode_attention_at_deepseeks_shape(cuda):
    """The chat cell's shape: 32 slots over a 2304-row pool, 16/16 heads at
    hd 128, positions anywhere in the pool; and a planted fault (one key
    past each position) that the limit must catch."""
    from repro_torch.kernels import decode_attention as TD
    q, k, v, pos = decode_inputs(32, 2304, 16, 16, 128, 91, cuda)
    got = TD.decode_attention(q, k, v, pos)
    want = TD.decode_attention_plain(q, k, v, pos)
    torch.testing.assert_close(got.float(), want.float(), **DECODE_LIMIT)
    fault = TD.decode_attention_plain(q, k, v, pos + 1)
    with pytest.raises(AssertionError):
        torch.testing.assert_close(got.float(), fault.float(),
                                   **DECODE_LIMIT)


@pytest.mark.cuda
def test_cuda_decode_attention_reads_a_strided_pool_in_place(cuda):
    """Batch and row strides of a wider pool and a one-element position."""
    from repro_torch.kernels import decode_attention as TD
    q, k, v, _ = decode_inputs(3, 400, 4, 2, 128, 92, cuda)
    wide_k = torch.zeros(3, 416, 2, 128, dtype=torch.bfloat16, device=cuda)
    wide_v = torch.zeros_like(wide_k)
    wide_k[:, :400], wide_v[:, :400] = k, v
    sk, sv = wide_k[:, :400], wide_v[:, :400]
    assert not sk.is_contiguous()
    pos = torch.tensor(257, device=cuda)
    got = TD.decode_attention(q, sk, sv, pos, window=100)
    want = TD.decode_attention_plain(q, k, v, pos, window=100)
    torch.testing.assert_close(got.float(), want.float(), **DECODE_LIMIT)


@pytest.mark.cuda
def test_cuda_decode_attention_replays_in_a_cuda_graph(cuda):
    """Captured once on static buffers; each replay reads the positions and
    the pool as they are then."""
    from repro_torch.kernels import decode_attention as TD
    q, k, v, pos = decode_inputs(8, 600, 4, 2, 128, 93, cuda)
    TD.decode_attention(q, k, v, pos)             # built and warm
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = decode_launches()
    with torch.cuda.graph(graph):
        out = TD.decode_attention(q, k, v, pos, softcap=50.0)
    assert decode_launches() == before + 1
    for seed in (94, 95):
        q2, k2, v2, pos2 = decode_inputs(8, 600, 4, 2, 128, seed, cuda)
        for buf, new in ((q, q2), (k, k2), (v, v2), (pos, pos2)):
            buf.copy_(new)
        graph.replay()
        torch.cuda.synchronize()
        want = TD.decode_attention_plain(q2, k2, v2, pos2, softcap=50.0)
        torch.testing.assert_close(out.float(), want.float(),
                                   **DECODE_LIMIT)
    assert decode_launches() == before + 1


@pytest.mark.cuda
def test_cuda_engine_counts_the_kernel_on_both_step_runners(cuda):
    """A bf16 MoE stack at hd 64 served with the captured step and with the
    eager one: the same tokens, every decode attention call on the kernel,
    steps × layers of them (a replay repeats its capture's calls)."""
    import dataclasses
    from repro_torch.configs import get_reduced
    from repro_torch.models import transformer as TT
    from repro_torch.serve import ContinuousEngine, GenerateConfig, Request
    cfg = dataclasses.replace(get_reduced("deepseek-moe-16b"),
                              dtype="bfloat16", head_dim=64)
    model = TT.init_params(cfg, seed=3, device=cuda)
    rng = np.random.default_rng(36)
    reqs = [Request(rid=i, prompt=np.asarray(rng.integers(
        2, cfg.vocab_size, L), np.int32), max_new_tokens=b)
        for i, (L, b) in enumerate(zip([4, 12, 6, 9], [9, 7, 3, 9]))]
    layers = sum(s.kind == "attn" for s in TT.layer_specs(cfg))

    class Eager(ContinuousEngine):
        def _step_runner(self, step):
            return step

    runs = []
    for cls in (ContinuousEngine, Eager):
        got = {}
        eng = cls(cfg, model, GenerateConfig(max_new_tokens=9), slots=3,
                  cache_dtype=torch.bfloat16, segment=4)
        eng.run(reqs, lambda rid, t, s: got.__setitem__(rid, t.tolist()))
        runs.append((got, eng.stats["attn_decode_kernel"],
                     eng.stats["attn_decode_einsum"], eng.stats["segments"]))
        if cls is ContinuousEngine:
            assert eng._step.captures == 1 and eng._step.replays > 0
            steps = eng._step.calls
    assert runs[0] == runs[1]
    assert runs[0][1] == steps * layers and runs[0][2] == 0


# ---------------------------------------------------------------------------
# the MoE, SSM and hybrid families
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("H,KH", [(16, 16), (32, 8)],
                         ids=["deepseek-moe-16b", "jamba-v0.1-52b"])
def test_cuda_wgmma_at_the_family_head_layouts(cuda_f32, H, KH):
    """The wgmma kernel at deepseek's (16/16, G = 1) and jamba's (32/8)
    head layouts, hd 128, causal global, no softcap."""
    q, k, v = (torch.as_tensor(field(80 + i, (n, 512, 128)), device=cuda_f32)
               .to(torch.bfloat16) for i, n in enumerate((H, KH, KH)))
    before = dict(TS.launch_counts)
    got = TS.swa_attention(q, k, v, window=0, causal=True)
    torch.cuda.synchronize()
    assert TS.launch_counts["wgmma"] == before["wgmma"] + 1
    G = H // KH
    for g in range(KH):
        want = TS.swa_attention_plain(q[g * G:(g + 1) * G], k[g:g + 1],
                                      v[g:g + 1], window=0, causal=True)
        torch.testing.assert_close(got[g * G:(g + 1) * G].float(),
                                   want.float(), **SWA_BF16_LIMIT)


def family_model(arch, device, dtype="bfloat16", seed=0, **kw):
    import dataclasses
    from repro_torch.configs import get_reduced
    from repro_torch.models import transformer as TT
    cfg = dataclasses.replace(get_reduced(arch), dtype=dtype, **kw)
    return cfg, TT.init_params(cfg, seed=seed, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "jamba-v0.1-52b"])
def test_cuda_moe_forward_twice_is_bit_equal(cuda_f32, arch):
    """The combine has no atomics: two bf16 forwards, with capacity drops,
    give the same logits and aux bit for bit."""
    from repro_torch.models import transformer as TT
    cfg, model = family_model(arch, cuda_f32, moe_dropless=False,
                              moe_capacity_factor=0.75)
    tokens = torch.as_tensor(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 256)),
        device=cuda_f32)
    a, aux_a = TT.forward(cfg, model, {"tokens": tokens})
    b, aux_b = TT.forward(cfg, model, {"tokens": tokens})
    assert torch.equal(a, b)
    assert all(torch.equal(aux_a[k], aux_b[k]) for k in aux_a)
    assert float(aux_a["drop_frac"]) > 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,cf", [("float32", 0.5), ("float32", 1.25),
                                      ("bfloat16", 1.25)])
def test_cuda_moe_matches_the_cpu(cuda_f32, dtype, cf):
    """``moe`` on the card against the same function on the CPU: float32
    within 1e-5 (TF32 off), bfloat16 within 2e-2 (the products' roundings
    differ); drop_frac equal."""
    from repro_torch.models import layers as TL
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(0)
    m = TL.MoE(64, 8, 96, 1, 128, True, device="cpu", dtype=dt, generator=g)
    x = (torch.randn((3, 40, 64), generator=g) * 0.5).to(dt)
    want, waux = TL.moe(m, x, top_k=2, capacity_factor=cf)
    got, aux = TL.moe(m.to(cuda_f32), x.to(cuda_f32), top_k=2,
                      capacity_factor=cf)
    tol = 1e-5 if dt == torch.float32 else 2e-2
    torch.testing.assert_close(got.cpu().float(), want.float(), atol=tol,
                               rtol=tol)
    assert float(aux["drop_frac"]) == float(waux["drop_frac"])
    torch.testing.assert_close(aux["lb_loss"].cpu(), waux["lb_loss"],
                               rtol=1e-5, atol=0)


@pytest.mark.cuda
def test_cuda_expert_parallel_on_a_mesh_of_the_card(cuda_f32):
    """On ["cuda:0"] * 8 as (2, 4) at capacity factor 8.0 (no drops) the
    expert-parallel dispatch equals the dense one (float32)."""
    from repro_torch.models import layers as TL
    from repro_torch.models.moe_parallel import expert_parallel_moe
    from repro_torch.sharding import make_mesh
    g = torch.Generator().manual_seed(1)
    m = TL.MoE(64, 8, 96, 1, 128, True, device="cpu", dtype=torch.float32,
               generator=g).to(cuda_f32)
    x = (torch.randn((4, 32, 64), generator=g) * 0.5).to(cuda_f32)
    mesh = make_mesh((2, 4), ("data", "model"), devices=["cuda:0"] * 8)
    y, aux = expert_parallel_moe(m, x, top_k=2, act="silu",
                                 capacity_factor=8.0, mesh=mesh,
                                 dp_axes=("data",))
    want, _ = TL.moe(m, x, top_k=2, dropless=True)
    torch.testing.assert_close(y, want, atol=1e-5, rtol=0)
    assert float(aux["drop_frac"]) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("S", [128, 300])
def test_cuda_ssd_chunked_matches_ssd_ref(cuda_f32, S):
    from repro_torch.models import ssm as TSM
    g = torch.Generator().manual_seed(2)
    nh, hd, n = 8, 16, 32
    dims = dict(state=n, ngroups=1, nheads=nh, head_dim=hd)
    x, Bv, Cv = (torch.randn(shape, generator=g).to(cuda_f32) for shape in
                 ((2, S, nh, hd), (2, S, 1, n), (2, S, 1, n)))
    dt = (torch.rand((2, S, nh), generator=g) * 0.2 + 0.01).to(cuda_f32)
    A = torch.log(torch.linspace(1.0, 16.0, nh)).to(cuda_f32)
    D = torch.ones(nh, device=cuda_f32)
    h0 = torch.randn((2, nh, hd, n), generator=g).to(cuda_f32) * 0.1
    y, h = TSM.ssd_chunked(x, dt, A, Bv, Cv, D, dims=dims, h0=h0)
    yr, hr = TSM.ssd_ref(x, dt, A, Bv, Cv, D, dims=dims, h0=h0)
    torch.testing.assert_close(y, yr, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(h, hr, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "mamba2-130m",
                                  "jamba-v0.1-52b"])
def test_cuda_family_greedy_equals_dropless_teacher_forced(cuda_f32, arch):
    """float32 serving on the card: greedy tokens are the argmax of the
    dropless forward over prompt + tokens (128: the flash route)."""
    from repro_torch.models import transformer as TT
    from repro_torch.serve import GenerateConfig, generate
    cfg, model = family_model(arch, cuda_f32, dtype="float32", seed=1)
    prompt = np.random.default_rng(1).integers(2, cfg.vocab_size, (2, 120))
    out, lengths, _ = generate(cfg, model, prompt,
                               GenerateConfig(max_new_tokens=8),
                               cache_dtype=torch.float32)
    full = torch.cat([torch.as_tensor(prompt, device=cuda_f32),
                      out.long()], dim=1)
    logits, _ = TT.forward(cfg, model, {"tokens": full})
    exp = logits[:, 119:-1].argmax(dim=-1)
    for b in range(2):
        L = int(lengths[b])
        assert torch.equal(out[b, :L].long(), exp[b, :L])


# ---------------------------------------------------------------------------
# the encoder-decoder and vision-stub families; the gradient refusal
# ---------------------------------------------------------------------------


def family_extras(cfg, B, device, seed=0):
    """The frames (model dtype) or patch embeddings (float32) a reduced
    whisper or phi-3-vision forward takes."""
    g = torch.Generator(device=device).manual_seed(seed)
    if cfg.is_encoder_decoder:
        return {"frames": torch.randn((B, cfg.encoder_seq, cfg.d_model),
                                      generator=g, device=device)}
    return {"patch_embeds": torch.randn(
        (B, cfg.vision_patches, cfg.vision_embed_dim), generator=g,
        device=device)}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["whisper-base", "phi-3-vision-4.2b"])
def test_cuda_encdec_and_vlm_routes_agree(cuda_f32, arch):
    """float32 reduced forwards: the flash route (the decoder's
    self-attention only) against the einsum route, one launch a layer."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import attention as TA
    from repro_torch.models import transformer as TT
    cfg = get_reduced(arch)
    model = TT.init_params(cfg, seed=0, max_position=256, device=cuda_f32)
    S = 128 - (cfg.vision_patches or 0)
    batch = {"tokens": torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, S)), device=cuda_f32),
        **family_extras(cfg, 2, cuda_f32)}
    before = swa_launches()
    flash, _ = TT.forward(cfg, model, batch)
    assert swa_launches() - before == cfg.num_layers
    TA.set_flash_swa(False)
    try:
        einsum, _ = TT.forward(cfg, model, batch)
    finally:
        TA.set_flash_swa(None)
    assert swa_launches() - before == cfg.num_layers
    torch.testing.assert_close(flash, einsum, atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["whisper-base", "phi-3-vision-4.2b"])
def test_cuda_encdec_and_vlm_greedy_equals_teacher_forced(cuda_f32, arch):
    from repro_torch.configs import get_reduced
    from repro_torch.models import transformer as TT
    from repro_torch.serve import GenerateConfig, generate
    cfg = get_reduced(arch)
    model = TT.init_params(cfg, seed=1, device=cuda_f32)
    extras = family_extras(cfg, 2, cuda_f32, seed=1)
    kw = {}
    if cfg.is_encoder_decoder:
        enc = TT.encode(cfg, model, extras["frames"])
        kw = dict(enc_out=enc,
                  cross_caches=TT.prefill_cross_caches(cfg, model, enc))
    else:
        kw = dict(patch_embeds=extras["patch_embeds"])
    prompt = np.random.default_rng(1).integers(2, cfg.vocab_size, (2, 12))
    out, lengths, _ = generate(cfg, model, prompt,
                               GenerateConfig(max_new_tokens=8),
                               cache_dtype=torch.float32, **kw)
    full = torch.cat([torch.as_tensor(prompt, device=cuda_f32),
                      out.long()], dim=1)
    logits, _ = TT.forward(cfg, model, {"tokens": full, **extras})
    P = cfg.vision_patches or 0
    exp = logits[:, P + 11:-1].argmax(dim=-1)
    for b in range(2):
        L = int(lengths[b])
        assert torch.equal(out[b, :L].long(), exp[b, :L])


@pytest.mark.cuda
def test_cuda_kernel_route_refuses_gradients(cuda_f32):
    """The flash route has no backward: a forward under grad with a
    parameter that requires grad raises on the card, and the einsum route
    back-propagates to it."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import attention as TA
    from repro_torch.models import transformer as TT
    cfg = get_reduced("whisper-base")
    model = TT.init_params(cfg, seed=0, max_position=256, device=cuda_f32)
    batch = {"tokens": torch.zeros((1, 128), dtype=torch.long,
                                   device=cuda_f32),
             **family_extras(cfg, 1, cuda_f32)}
    wq = model.layers[0].attn.wq
    wq.requires_grad_(True)
    before = swa_launches()
    with pytest.raises(RuntimeError, match="no backward"):
        TT.forward(cfg, model, batch)
    assert swa_launches() == before
    with torch.no_grad():
        TT.forward(cfg, model, batch)
    assert swa_launches() == before + cfg.num_layers
    TA.set_flash_swa(False)
    try:
        logits, _ = TT.forward(cfg, model, batch)
    finally:
        TA.set_flash_swa(None)
    logits.logsumexp(dim=-1).mean().backward()
    assert wq.grad is not None and float(wq.grad.abs().max()) > 0


# ---------------------------------------------------------------------------
# the serve tier: per-sequence cache writes and the int8 cache on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("S_new,lens", [(1, None), (5, [5, 3, 1]),
                                        (13, [13, 9, 4])])
def test_cuda_per_sequence_ring_write_matches_the_cpu(cuda, S_new, lens):
    """A ring write on the card (per-sequence decode, or a ragged prefill
    under ``kv_len``, ``S_new`` past the window too) writes what it writes
    on the CPU, exactly."""
    from repro_torch.models import attention as TA
    rng = np.random.default_rng(30)
    B, W = 3, 8
    cache = {"k": rng.normal(size=(B, W, 2, 4)).astype(np.float32),
             "v": rng.normal(size=(B, W, 2, 4)).astype(np.float32),
             "pos": rng.integers(-1, 40, (B, W)).astype(np.int32)}
    k = rng.normal(size=(B, S_new, 2, 4)).astype(np.float32)
    v = rng.normal(size=(B, S_new, 2, 4)).astype(np.float32)
    if lens is None:
        positions, kw = np.asarray([[3], [17], [8]]), dict(ragged=True)
    else:
        positions = np.broadcast_to(np.arange(S_new), (B, S_new))
        kw = dict(kv_len=np.asarray(lens, np.int32))
    out = []
    for dev in ("cpu", cuda):
        def on(a):
            return torch.as_tensor(np.array(a), device=dev)
        got = TA._ring_write({key: on(val) for key, val in cache.items()},
                             on(k), on(v), on(positions),
                             **{key: (on(val) if key == "kv_len" else val)
                                for key, val in kw.items()})
        out.append({key: val.cpu() for key, val in got.items()})
    for key in out[0]:
        assert torch.equal(out[0][key], out[1][key]), key


@pytest.mark.cuda
@pytest.mark.parametrize("pos", [[[2], [0], [9], [-4]], [[5]]])
def test_cuda_per_row_scatter_matches_the_cpu(cuda, pos):
    from repro_torch.models import attention as TA
    rng = np.random.default_rng(31)
    cache = rng.normal(size=(4, 10, 2, 3)).astype(np.float32)
    new = rng.normal(size=(4, 3, 2, 3)).astype(np.float32)
    got = [TA._scatter_cache(torch.as_tensor(cache, device=dev),
                             torch.as_tensor(new, device=dev),
                             torch.tensor(pos, device=dev)).cpu()
           for dev in ("cpu", cuda)]
    assert torch.equal(got[0], got[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_int8_round_trip_matches_the_cpu(cuda, dtype):
    """Quantise and dequantise on the card: the CPU's scales within one
    float32 rounding and its int8 values but at rounding ties, where a
    scale one bit apart moves a value by one step (the card divides by the
    host constant 127 as a multiply by its reciprocal); the round trip
    within half a quantisation step."""
    from repro_torch.models import attention as TA
    x = torch.as_tensor(np.random.default_rng(32).normal(
        size=(2, 64, 8, 256)).astype(np.float32) * 3).to(dtype)
    qc, sc = TA._quantize_kv(x)
    qg, sg = TA._quantize_kv(x.to(cuda))
    torch.testing.assert_close(sg.cpu(), sc, rtol=2e-7, atol=0)
    dq = (qg.cpu().int() - qc.int()).abs()
    assert int(dq.max()) <= 1 and float((dq > 0).float().mean()) < 1e-3
    back = TA._dequantize_kv(qg, sg, torch.float32)
    assert float((back.cpu() - x.float()).abs().max()
                 / x.float().abs().max()) < 0.01


@pytest.mark.cuda
def test_cuda_divides_by_a_host_constant_as_by_its_reciprocal(cuda):
    """Why the card's int8 scales may sit one bit from the CPU's: PyTorch on
    the card divides a float32 tensor by a host constant as a multiply by
    its reciprocal, the CPU divides.  Prints the share that differs."""
    a = torch.as_tensor(np.random.default_rng(34).normal(
        size=1 << 20).astype(np.float32)).abs() * 5
    card = (a.to(cuda) / 127.0).cpu()
    differ = int((card != a / 127.0).sum())
    print(f"card / 127 differs from the CPU's on {differ} of {a.numel()}")
    assert torch.equal(card, a * (1.0 / 127.0)) and differ > 0


@pytest.mark.cuda
def test_cuda_continuous_engine_matches_solo_generate(cuda_f32):
    """Ragged requests through a ContinuousEngine on the card (reduced
    gemma2-9b, float32: rings wrap): each equals its solo greedy
    ``generate``, and a sampled run repeats exactly."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import transformer as TT
    from repro_torch.serve import (ContinuousEngine, GenerateConfig, Request,
                                   generate)
    cfg = get_reduced("gemma2-9b")
    model = TT.init_params(cfg, seed=0, device=cuda_f32)
    rng = np.random.default_rng(33)
    reqs = [Request(rid=i, prompt=np.asarray(rng.integers(
        2, cfg.vocab_size, L), np.int32), max_new_tokens=b)
        for i, (L, b) in enumerate(zip([3, 12, 5, 9, 14], [2, 7, 3, 7, 4]))]

    def serve(temperature):
        got = {}
        eng = ContinuousEngine(cfg, model, GenerateConfig(
            max_new_tokens=7, temperature=temperature), slots=2,
            cache_dtype=torch.float32, segment=3)
        eng.run(reqs, lambda rid, t, s: got.__setitem__(rid, t.tolist()))
        return got

    got = serve(0.0)
    for r in reqs:
        solo, L, _ = generate(cfg, model, r.prompt[None], GenerateConfig(
            max_new_tokens=r.max_new_tokens), cache_dtype=torch.float32)
        assert got[r.rid] == solo[0, :int(L[0])].tolist()
    assert serve(0.7) == serve(0.7)


# ---------------------------------------------------------------------------
# compiled decode: a captured decode step, replayed
# ---------------------------------------------------------------------------


def serve_extras(cfg, model, B, device):
    """The keywords a reduced family's generate call takes on the card."""
    from repro_torch.models import transformer as TT
    extras = family_extras(cfg, B, device, seed=2)
    if cfg.is_encoder_decoder:
        enc = TT.encode(cfg, model, extras["frames"])
        return dict(enc_out=enc,
                    cross_caches=TT.prefill_cross_caches(cfg, model, enc))
    return extras if cfg.vision_patches else {}


@pytest.mark.cuda
@pytest.mark.parametrize("arch,quant", [
    ("gemma2-9b", False), ("gemma2-9b", True), ("deepseek-moe-16b", False),
    ("mamba2-130m", False), ("jamba-v0.1-52b", False),
    ("whisper-base", False), ("phi-3-vision-4.2b", False)])
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_cuda_generate_jit_equals_generate(cuda_f32, arch, quant,
                                           temperature):
    """The graphed ``generate_jit`` against the eager ``generate`` on the
    card (float32, reduced widths; gemma2 also on the int8 cache): tokens,
    lengths and iters equal, over two calls of one captured graph with
    other budgets."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import transformer as TT
    from repro_torch.serve import GenerateConfig, generate, generate_jit
    cfg = get_reduced(arch)
    model = TT.init_params(cfg, seed=1, device=cuda_f32)
    kw = serve_extras(cfg, model, 3, cuda_f32)
    g = GenerateConfig(max_new_tokens=19, temperature=temperature, seed=3)
    run = generate_jit(cfg, g, cache_dtype=torch.float32, quant=quant)
    rng = np.random.default_rng(4)
    for budgets in (None, [19, 5, 11]):
        prompt = rng.integers(2, cfg.vocab_size, (3, 10))
        want = generate(cfg, model, prompt, g, cache_dtype=torch.float32,
                        budgets=budgets, quant=quant, **kw)
        got = run(model, prompt, budgets=budgets, **kw)
        for w, x in zip(want, got):
            assert torch.equal(w, x)
    assert run.stats["captures"] == 1 and run.stats["replays"] > 0
    assert len(run.compiled) == 1


@pytest.mark.cuda
def test_cuda_graphed_continuous_engine_equals_generate(cuda_f32):
    """The graphed ``ContinuousEngine`` (sync and chained) on the card: each
    request's tokens equal its solo eager ``generate``, as sets per rid;
    the body step was captured once and replayed."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import transformer as TT
    from repro_torch.serve import (ContinuousEngine, GenerateConfig, Request,
                                   generate)
    cfg = get_reduced("gemma2-9b")
    model = TT.init_params(cfg, seed=2, device=cuda_f32)
    rng = np.random.default_rng(35)
    reqs = [Request(rid=i, prompt=np.asarray(rng.integers(
        2, cfg.vocab_size, L), np.int32), max_new_tokens=b)
        for i, (L, b) in enumerate(zip([4, 12, 6, 9, 14, 3],
                                       [9, 7, 3, 9, 4, 6]))]
    want = {}
    for r in reqs:
        solo, L, _ = generate(cfg, model, r.prompt[None], GenerateConfig(
            max_new_tokens=r.max_new_tokens), cache_dtype=torch.float32)
        want[r.rid] = solo[0, :int(L[0])].tolist()
    for chained in (False, True):
        got = {}
        eng = ContinuousEngine(cfg, model, GenerateConfig(max_new_tokens=9),
                               slots=3, cache_dtype=torch.float32, segment=4)
        eng.run(reqs, lambda rid, t, s: got.__setitem__(rid, t.tolist()),
                chained=chained)
        assert got == want
        assert eng._step.captures == 1 and eng._step.replays > 0


@pytest.mark.cuda
def test_cuda_a_host_sync_in_the_step_makes_the_capture_raise(cuda_f32,
                                                              monkeypatch):
    """A decode step that reads a value back to the host cannot be
    captured: ``generate_jit`` raises RuntimeError, with no eager
    fallback."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import transformer as TT
    from repro_torch.serve import GenerateConfig, generate_jit
    cfg = get_reduced("gemma2-9b")
    model = TT.init_params(cfg, seed=1, device=cuda_f32)
    real = TT.decode_step

    def syncing(*a, **kw):
        logits, caches = real(*a, **kw)
        if float(logits.sum()) != float(logits.sum()):   # a host read
            raise AssertionError("non-finite logits")
        return logits, caches
    monkeypatch.setattr(TT, "decode_step", syncing)
    run = generate_jit(cfg, GenerateConfig(max_new_tokens=6),
                       cache_dtype=torch.float32)
    prompt = np.random.default_rng(5).integers(2, cfg.vocab_size, (2, 8))
    with pytest.raises(RuntimeError, match="decode step"):
        run(model, prompt)
    assert run.stats["replays"] == 0


# ---------------------------------------------------------------------------
# training: AdamW and int8 compression on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_adamw_update_matches_the_cpu(cuda, dtype):
    """Three AdamW updates on the card against the same on the CPU: the
    masters within 1e-7 (a step moves a weight by lr = 1e-3; the card's
    sqrt and divisions may round one ulp apart), the parameters the
    masters cast to their dtype exactly, the steps equal."""
    from repro_torch.optim import AdamW, cosine_with_warmup
    rng = np.random.default_rng(50)
    shapes = {"w": (64, 48), "b": (48,), "emb": (100, 16)}
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32) * 3
              for k, s in shapes.items()} for _ in range(3)]
    opt = AdamW(lr=cosine_with_warmup(1e-3, 1, 3), weight_decay=0.01)
    out = {}
    for dev in ("cpu", cuda):
        params = {k: torch.tensor(v).to(dev, dtype) for k, v in p0.items()}
        state = opt.init(params)
        for g in grads:
            opt.update({k: torch.tensor(v).to(dev, dtype)
                        for k, v in g.items()}, state, params)
        out[str(dev)] = (params, state)
    (pc, sc), (pg, sg) = out["cpu"], out[str(cuda)]
    assert int(sg.step) == int(sc.step) == 3
    for k in shapes:
        torch.testing.assert_close(sg.master[k].cpu(), sc.master[k],
                                   rtol=0, atol=1e-7)
        assert pg[k].dtype == dtype
        assert torch.equal(pg[k].cpu(), sg.master[k].cpu().to(dtype))
        assert sg.master[k].data_ptr() != pg[k].data_ptr()


@pytest.mark.cuda
@pytest.mark.parametrize("peers", [1, 2, 3, 4])
def test_cuda_int8_payloads_equal_the_cpu(cuda, peers):
    """``quantize_int8`` and the error-feedback payloads on the card give
    the CPU's int8 values and scales exactly (the scale divides by a
    tensor, not by a host constant); the summed gradient too."""
    from repro_torch.train.compression import (ef_int8_payloads,
                                               ef_int8_psum, quantize_int8)
    rng = np.random.default_rng(51 + peers)
    x = torch.tensor(rng.normal(size=(1 << 16,)).astype(np.float32) * 7)
    qc, sc = quantize_int8(x, peers)
    qg, sg = quantize_int8(x.to(cuda), peers)
    assert torch.equal(qg.cpu(), qc) and torch.equal(sg.cpu(), sc)
    gs = [torch.tensor(rng.normal(size=(4096,)).astype(np.float32))
          for _ in range(peers)]
    es = [torch.tensor(rng.normal(size=(4096,)).astype(np.float32) * 1e-3)
          for _ in range(peers)]
    qsc, scc, _ = ef_int8_payloads(gs, es)
    qsg, scg, _ = ef_int8_payloads([g.to(cuda) for g in gs],
                                   [e.to(cuda) for e in es])
    assert torch.equal(scg.cpu(), scc)
    for a, b in zip(qsg, qsc):
        assert torch.equal(a.cpu(), b)
    total_c, _ = ef_int8_psum(gs, es)
    total_g, _ = ef_int8_psum([g.to(cuda) for g in gs],
                              [e.to(cuda) for e in es])
    assert torch.equal(total_g.cpu(), total_c)


@pytest.mark.cuda
def test_cuda_training_step_takes_the_einsum_route(cuda_f32):
    """A reduced gemma2-9b train step on the card (sliding windows and
    S = 128: the forward alone would take the kernel) launches no
    attention kernel, leaves the flash flag as it was, and gives the
    CPU's loss and grad norm (rtol 1e-5, TF32 off) and masters (atol
    1e-7, the step moving a weight by lr = 1e-3, on all but 1e-3 of
    them: an H100 read 39 of 222,272 apart)."""
    from repro_torch.configs import get_reduced
    from repro_torch.data import SyntheticLM
    from repro_torch.models import attention as TA
    from repro_torch.models import transformer as TT
    from repro_torch.optim import AdamW
    from repro_torch.train import TrainConfig, Trainer
    cfg = get_reduced("gemma2-9b")
    batch = SyntheticLM(cfg.vocab_size, 128, 4, seed=3).batch_at(0)
    out = {}
    for dev in ("cpu", cuda_f32):
        model = TT.init_params(cfg, seed=0, device="cpu").to(dev)
        opt = AdamW(lr=1e-3)
        tr = Trainer(cfg, TrainConfig(accum=2), opt, device=dev)
        before = swa_launches()
        _, state, m = tr.train_step(model, opt.init(model), batch)
        assert swa_launches() == before and TA.USE_FLASH_SWA is None
        out[str(dev)] = (state, m)
    (sc, mc), (sg, mg) = out["cpu"], out[str(cuda_f32)]
    for key in ("total_loss", "grad_norm"):
        torch.testing.assert_close(mg[key].cpu(), mc[key], rtol=1e-5, atol=0)
    # Adam's first step moves each weight by about lr·sign(g): a gradient
    # entry within rounding of zero may take either sign on either device
    off = sum(int(((sg.master[k].cpu() - sc.master[k]).abs() > 1e-7).sum())
              for k in sc.master)
    assert off <= 1e-3 * sum(t.numel() for t in sc.master.values()), off
