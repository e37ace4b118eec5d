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
TF32 off).
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
    (6, 2, 256, 96, 100, True, 50.0),         # hd 96 (bf16: CUDA cores)
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
    ("bfloat16", 96, "cuda_core"), ("float32", 64, "cuda_core"),
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
