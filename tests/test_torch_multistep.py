"""Port parity: temporal blocking (``repro_torch.kernels.multistep`` and the
``"cuda-multistep"`` backend) against the JAX package.

On the CPU the multistep wrapper runs its plain version, which is held
against the JAX Pallas kernel ``stencil2d_multistep`` in interpret mode
(domain and reduce within atol 2e-5: the reference contracts multiply-adds
inside its jitted kernel, the port does not).  A torch emulation of the CUDA
kernel's tile-by-tile algorithm (window, shrinking region, boundary passes)
is held against the plain version's whole-frame realisation, cell for cell,
so the kernel's index arithmetic is tested here too.  The CUDA kernel itself
is held against the plain version by ``tests/test_torch_cuda.py`` (skipped
without a card) and by ``chip_smoke.py``.
"""
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import frames as JF  # noqa: E402
from repro.core import pattern as JP  # noqa: E402
from repro.core.executor import auto_unroll as j_auto_unroll  # noqa: E402
from repro.kernels import multistep as JM  # noqa: E402
from repro.kernels import ops as JO  # noqa: E402
from repro.kernels import ref as JR  # noqa: E402
from repro.kernels.stencil2d import stencil2d_fused as j_fused  # noqa: E402
from repro_torch.core import executor as TE  # noqa: E402
from repro_torch.core import pattern as TP  # noqa: E402
from repro_torch.core.frames import (frame_env, frame_spec,  # noqa: E402
                                     make_frame, make_lane_frames,
                                     lane_env_frames)
from repro_torch.core.semantics import Boundary  # noqa: E402
from repro_torch.kernels import multistep as TM  # noqa: E402
from repro_torch.kernels import ops as TO  # noqa: E402
from repro_torch.kernels import ref as TR  # noqa: E402
from repro_torch.kernels import stencil2d as TK  # noqa: E402

CSRC = Path(TK.__file__).resolve().parent / "csrc"
BOUNDARIES = ["zero", "nan", "reflect", "wrap"]
# mirror-asymmetric weights: the reference test's `lopsided` stencil
LOPSIDED = [[0.0, 0.0, 0.3], [0.2, 0.25, 0.0], [0.0, 0.25, 0.0]]


def field(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def j_heat(get, *_):
    lap = (get(-1, 0) + get(1, 0) + get(0, -1) + get(0, 1)
           - 4.0 * get(0, 0))
    return get(0, 0) + 0.1 * lap


def j_lopsided(get, *_):
    return (0.3 * get(-1, 1) + 0.25 * get(1, 0) + 0.2 * get(0, -1)
            + 0.25 * get(0, 0))


PORT_FN = {"heat": TR.heat_taps(0.1), "lopsided": TR.conv_taps(LOPSIDED)}
JAX_FN = {"heat": j_heat, "lopsided": j_lopsided}


def with_env(fn):
    return lambda get, e: fn(get) + 0.05 * e


@pytest.fixture
def plain_kernels(monkeypatch):
    """Let the kernel backends run on CPU tensors, where every kernel
    wrapper runs its plain version (only the device check stops them)."""
    for mod in (TP, TE):
        monkeypatch.setattr(mod, "resolve_backend",
                            lambda b, d: b or "torch")


def assert_domain(t, j, atol=2e-5):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), atol=atol,
                               rtol=0, equal_nan=True)


# ---------------------------------------------------------------------------
# (a) the plain version against the JAX kernel (interpret mode: few cases)
# ---------------------------------------------------------------------------

# every boundary with both stencils; T cycles through 1, 2, 4, 8 so that
# each stencil meets every T and reflect meets the asymmetric one at T=8
CASES = [(b, fn, (1, 2, 4, 8)[(3 - i + 2 * j) % 4])
         for i, b in enumerate(BOUNDARIES)
         for j, fn in enumerate(("heat", "lopsided"))]


@pytest.mark.parametrize("boundary,fn,T", CASES)
def test_plain_multistep_matches_pallas_interpret(boundary, fn, T):
    a, e = field(0, (48, 160)), field(1, (48, 160))
    jn, jr = JM.stencil2d_multistep(
        jnp.asarray(a), with_env(JAX_FN[fn]), env=(jnp.asarray(e),), k=1,
        T=T, combine="max", identity=-jnp.inf, measure=JR.abs_delta,
        boundary=boundary, block=(16, 128), interpret=True)
    tn, tr = TM.stencil2d_multistep(
        torch.as_tensor(a), with_env(PORT_FN[fn]), env=(torch.as_tensor(e),),
        k=1, T=T, combine="max", measure=TR.abs_delta, boundary=boundary)
    assert_domain(tn, jn)
    np.testing.assert_allclose(float(tr), float(jr), atol=2e-5,
                               equal_nan=True)


def test_plain_multistep_domain_bounds_match_pallas_interpret():
    """Sentinel column bounds (an interior shard's sides): columns evolve
    freely, rows are reflected."""
    a, e = field(2, (48, 160)), field(3, (48, 160))
    f_j, f_t = with_env(j_lopsided), with_env(PORT_FN["lopsided"])
    T, s = 3, TM.SENTINEL
    jspec = JF.frame_spec(48, 160, k=1, block=(16, 128), sweeps=T)
    p = jspec.pad
    jout, jred = JM.stencil2d_multistep_framed(
        JF.make_frame(jnp.asarray(a), jspec, "reflect"), f_j, jspec, T=T,
        env_framed=(JF.frame_env(jnp.asarray(e), jspec, "reflect",
                                 halo=True),),
        combine="max", identity=-jnp.inf, measure=JR.abs_delta,
        boundary="reflect",
        domain_bounds=jnp.asarray([[p, p + 48, -s, s]], jnp.int32),
        interpret=True)
    spec = frame_spec(48, 160, k=1, sweeps=T)
    assert spec.pad == p
    out, red = TM.stencil2d_multistep_framed(
        make_frame(torch.as_tensor(a), spec, "reflect"), f_t, spec, T=T,
        env_framed=(frame_env(torch.as_tensor(e), spec, "reflect",
                              halo=True),),
        combine="max", measure=TR.abs_delta, boundary="reflect",
        domain_bounds=(p, p + 48, -s, s))
    assert_domain(out[p:p + 48, p:p + 160],
                  np.asarray(jout)[p:p + 48, p:p + 160])
    np.testing.assert_allclose(float(red), float(jred), atol=2e-5)


@pytest.mark.parametrize("boundary", BOUNDARIES)
def test_plain_multistep_equals_T_single_sweeps(boundary):
    """T fused sweeps ≡ T single sweeps of the port's own plain path."""
    a = torch.as_tensor(field(4, (40, 70)))
    f = PORT_FN["lopsided"]
    got, red = TM.stencil2d_multistep(a, f, k=1, T=4, combine="max",
                                      measure=TR.abs_delta,
                                      boundary=boundary, block=(8, 32))
    want = a
    for _ in range(4):
        prev, want = want, TR.stencil2d_fused_ref(want, f, k=1,
                                                  boundary=boundary)[0]
    assert_domain(got, want, atol=1e-6)
    if boundary != "nan":
        assert float(red) == pytest.approx(float((want - prev).abs().max()),
                                           abs=1e-6)


# ---------------------------------------------------------------------------
# the CUDA kernel's tile-by-tile algorithm, emulated in torch
# ---------------------------------------------------------------------------

def _mirror(g, lo, hi):
    s = 2 * lo - g if g < lo else 2 * (hi - 1) - g if g >= hi else None
    return s if s is not None and lo <= s < hi else None


def emulate_kernel(frame, f, spec, T, env, boundary, bounds, tile=None):
    """What ``window_kernel`` in csrc/window.cuh does, tile by tile: stage
    the (tm+2kT, tn+2kT) window (zeros past the frame's end), sweep T times
    over a region that shrinks by k a side (window coordinates), re-assert
    ⊥ after every sweep (zero/nan fill; reflect rows, then columns, each
    cell taking its mirror only where that lies in the domain and in the
    region), and write the tile's final values inside the block-rounded
    interior.  ``tile`` is the kernel's CTA tile (the frame's block when
    None)."""
    k, pad = spec.k, spec.pad
    bm, bn = tile or (spec.bm, spec.bn)
    mi, ni = spec.interior
    wm, wn = bm + 2 * pad, bn + 2 * pad
    rlo, rhi, clo, chi = bounds
    b = Boundary(boundary)
    out = torch.zeros_like(frame)

    def staged(x):                       # the frame, zero-filled past its end
        z = torch.zeros((-(-mi // bm) * bm + 2 * pad,
                         -(-ni // bn) * bn + 2 * pad), dtype=x.dtype)
        z[:x.shape[0], :x.shape[1]] = x
        return z
    frame_z, env_z = staged(frame), [staged(e) for e in env]
    for i in range(-(-mi // bm)):
        for j in range(-(-ni // bn)):
            r0, c0 = i * bm, j * bn
            cur = frame_z[r0:r0 + wm, c0:c0 + wn].clone()
            ew = [e[r0:r0 + wm, c0:c0 + wn] for e in env_z]
            for s in range(T):
                lo = k * (s + 1)
                R, C = wm - 2 * lo, wn - 2 * lo
                nxt = cur.clone()
                v = f(lambda di, dj: cur[lo + di:lo + di + R,
                                         lo + dj:lo + dj + C],
                      *[x[lo:lo + R, lo:lo + C] for x in ew])
                if b in (Boundary.ZERO, Boundary.NAN):
                    rows = torch.arange(r0 + lo, r0 + lo + R)
                    cols = torch.arange(c0 + lo, c0 + lo + C)
                    inside = (((rows >= rlo) & (rows < rhi))[:, None]
                              & ((cols >= clo) & (cols < chi))[None, :])
                    fill = 0.0 if b is Boundary.ZERO else float("nan")
                    v = torch.where(inside, v, torch.tensor(fill))
                nxt[lo:lo + R, lo:lo + C] = v
                if b is Boundary.REFLECT:
                    for r in range(lo, lo + R):
                        src = _mirror(r0 + r, rlo, rhi)
                        if src is not None and lo <= src - r0 < lo + R:
                            nxt[r, lo:lo + C] = nxt[src - r0, lo:lo + C]
                    for c in range(lo, lo + C):
                        src = _mirror(c0 + c, clo, chi)
                        if src is not None and lo <= src - c0 < lo + C:
                            nxt[lo:lo + R, c] = nxt[lo:lo + R, src - c0]
                cur = nxt
            rows, cols = min(bm, mi - r0), min(bn, ni - c0)
            out[pad + r0:pad + r0 + rows, pad + c0:pad + c0 + cols] = \
                cur[pad:pad + rows, pad:pad + cols]
    return out


@pytest.mark.parametrize("boundary,T,block,sentinel", [
    ("reflect", 3, (8, 32), None),
    ("reflect", 8, (8, 32), None),         # pad = bm: ghosts span 2 tiles
    ("zero", 4, (16, 32), None),
    ("nan", 2, (8, 32), None),
    ("wrap", 5, (8, 32), None),
    ("reflect", 3, (8, 32), "rows"),
    ("zero", 3, (16, 32), "cols"),
])
def test_tiled_kernel_algorithm_equals_whole_frame(boundary, T, block,
                                                   sentinel):
    m, n = 37, 70                        # block round-up on both axes
    a = torch.as_tensor(field(5, (m, n)))
    e = torch.as_tensor(field(6, (m, n)))
    f = with_env(PORT_FN["lopsided"])
    spec = frame_spec(m, n, k=1, block=block, sweeps=T)
    p = spec.pad
    bounds = [p, p + m, p, p + n]
    if sentinel == "rows":
        bounds[:2] = [-TM.SENTINEL, TM.SENTINEL]
    elif sentinel == "cols":
        bounds[2:] = [-TM.SENTINEL, TM.SENTINEL]
    frame = make_frame(a, spec, boundary)
    env = (frame_env(e, spec, boundary, halo=True),)
    got = emulate_kernel(frame, f, spec, T, env, boundary, bounds)
    want, _ = TM.stencil2d_multistep_framed_ref(
        frame, f, spec, T=T, env_framed=env, boundary=boundary,
        domain_bounds=bounds)
    torch.testing.assert_close(got[p:p + m, p:p + n], want[p:p + m, p:p + n],
                               rtol=0, atol=0, equal_nan=True)


# ---------------------------------------------------------------------------
# the wrapper on the CPU, lanes, the sources
# ---------------------------------------------------------------------------

def test_framed_wrapper_on_cpu_is_the_plain_version_with_lanes():
    T, b = 3, "reflect"
    spec = frame_spec(40, 70, k=1, sweeps=T)
    stack = torch.as_tensor(np.stack([field(7 + i, (40, 70))
                                      for i in range(3)]))
    env = (lane_env_frames(torch.as_tensor(
        np.stack([field(10 + i, (40, 70)) for i in range(3)])), spec, b,
        halo=True),)
    frames = make_lane_frames(stack, spec, b)
    live = torch.tensor([True, False, True])
    f = TR.helmholtz_jacobi_taps(0.5, 0.2)
    before = dict(TK.launch_counts)
    out, red = TM.stencil2d_multistep_framed(
        frames, f, spec, T=T, env_framed=env, combine="max",
        measure=TR.abs_delta, boundary=b, live=live)
    assert TK.launch_counts == before           # no launch on the CPU
    p = spec.pad
    for lane in (0, 2):
        one, r1 = TM.stencil2d_multistep_framed_ref(
            frames[lane], f, spec, T=T, env_framed=(env[0][lane],),
            combine="max", measure=TR.abs_delta, boundary=b)
        torch.testing.assert_close(out[lane, p:p + 40, p:p + 70],
                                   one[p:p + 40, p:p + 70], rtol=0, atol=0)
        assert float(red[lane]) == float(r1)
    torch.testing.assert_close(out[1], frames[1], rtol=0, atol=0)
    assert red.shape == (3,) and float(red[1]) == -np.inf
    with pytest.raises(ValueError, match="pad k\\*T"):
        TM.stencil2d_multistep_framed(frames, f, spec, T=2, env_framed=env)


def test_window_bytes_and_source_ids():
    spec = frame_spec(1000, 1000, k=3, sweeps=8)        # pad 24
    # the kernel's CTA tile sets the window, not the frame's block: two
    # slots of (frame, env fields) and the sweeps' work buffer
    assert TM.window_bytes(spec, 0, (32, 32)) == 3 * 80 * 80 * 4
    assert TM.window_bytes(spec, 2, (32, 32)) == 7 * 80 * 80 * 4
    assert TM.window_bytes(spec, 2, (32, 32), ring=1) == 4 * 80 * 80 * 4
    assert TM.window_bytes(spec, 0, (8, 32), itemsize=2) == 3 * 56 * 80 * 2
    assert TM.window_bytes(frame_spec(1000, 1000, k=3, sweeps=40), 2,
                           (8, 32)) > TM.SMEM_BYTES
    import re
    cu = (CSRC / "window.cuh").read_text()
    body = re.search(r"enum\s+BoundaryId\s*:\s*int\s*\{(.*?)\}", cu,
                     re.S).group(1)
    ids = {k[2:].lower(): int(v)
           for k, v in re.findall(r"(\w+)\s*=\s*(\d+)", body)}
    assert ids == TM.BOUNDARY_IDS
    from repro_torch.kernels import _build
    assert "multistep.cu" in _build.SOURCES
    assert {"fold.cuh", "dispatch.cuh", "window.cuh"} <= set(_build.HEADERS)


@pytest.mark.parametrize("boundary,T,tile,sentinel", [
    ("reflect", 3, (16, 64), None),      # tiles past the interior's end
    ("zero", 4, (8, 96), None),
    ("nan", 2, (24, 32), "cols"),
    ("wrap", 5, (40, 64), None),         # one tile row, past both ends
])
def test_kernel_tile_past_interior_equals_whole_frame(boundary, T, tile,
                                                      sentinel):
    m, n = 37, 70                        # interior 40 x 96 at block 8 x 32
    a = torch.as_tensor(field(7, (m, n)))
    e = torch.as_tensor(field(8, (m, n)))
    f = with_env(PORT_FN["lopsided"])
    spec = frame_spec(m, n, k=1, block=(8, 32), sweeps=T)
    p = spec.pad
    bounds = [p, p + m, p, p + n]
    if sentinel == "cols":
        bounds[2:] = [-TM.SENTINEL, TM.SENTINEL]
    frame = make_frame(a, spec, boundary)
    env = (frame_env(e, spec, boundary, halo=True),)
    got = emulate_kernel(frame, f, spec, T, env, boundary, bounds, tile)
    want, _ = TM.stencil2d_multistep_framed_ref(
        frame, f, spec, T=T, env_framed=env, boundary=boundary,
        domain_bounds=bounds)
    torch.testing.assert_close(got[p:p + m, p:p + n], want[p:p + m, p:p + n],
                               rtol=0, atol=0, equal_nan=True)


# ---------------------------------------------------------------------------
# the kernel's CTA tile for T sweeps (stencil2d.cta_tile through the
# multistep wrapper's arguments), pinned on the CPU
# ---------------------------------------------------------------------------

def ms_tile(spec, n_env, itemsize=4, boundary="zero"):
    """The tile the multistep wrapper asks for on ``spec``."""
    T = spec.pad // spec.k
    mi, ni = spec.interior
    return TK.cta_tile(mi, ni, pad=spec.pad, T=T, n_env=n_env,
                       itemsize=itemsize, env_halo=True,
                       work=T > 1 or boundary == "reflect")


@pytest.mark.parametrize("k,T,n_env", [(3, 3, 0), (3, 3, 2), (1, 8, 1),
                                       (1, 8, 2), (2, 6, 1)])
@pytest.mark.parametrize("itemsize", [4, 2])
def test_cta_tile_fits_radius3_T3_and_helmholtz_T8(k, T, n_env, itemsize):
    spec = frame_spec(8192, 8192, k=k, sweeps=T)
    for boundary in ("zero", "reflect"):
        tm, tn, ring = ms_tile(spec, n_env, itemsize, boundary)
        assert tm % 8 == 0 and tn % 32 == 0 and ring in (1, 2)
        assert TM.window_bytes(spec, n_env, (tm, tn), itemsize, boundary,
                               ring) <= TM.SMEM_BYTES


def test_cta_tile_shrinks_where_the_block_kernel_ran():
    # The kernel before the tile was its own ran a 32x32 block whenever
    # (2 + n_env) float windows of (32 + 2kT)^2 fit 230,400 bytes; the CTA
    # tile must shrink to fit there, never raise.
    for k in (1, 2, 3):
        for T in range(1, 14):
            for n_env in (0, 1, 2):
                old = (2 + n_env) * (32 + 2 * k * T) ** 2 * 4
                if old > 232448 - 2048:
                    continue
                spec = frame_spec(1000, 1312, k=k, sweeps=T)
                for itemsize in (4, 2):
                    tm, tn, ring = ms_tile(spec, n_env, itemsize, "reflect")
                    assert TM.window_bytes(spec, n_env, (tm, tn), itemsize,
                                           "reflect", ring) \
                        <= TM.SMEM_BYTES, (k, T, n_env)
    with pytest.raises(ValueError, match="no CTA tile"):
        ms_tile(frame_spec(1000, 1312, k=3, sweeps=40), 2)


def test_cta_tile_at_the_main_paths_shapes():
    # the Helmholtz 8192^2 launches of chip_smoke.py phase 9 and the
    # 8-lane restoration farm at T = 3 (phase 10)
    got = {T: ms_tile(frame_spec(8192, 8192, k=1, sweeps=T), 1)
           for T in (2, 4, 8)}
    assert got == {2: (32, 128, 1), 4: (32, 128, 1), 8: (32, 128, 1)}
    spec = frame_spec(1080, 1920, k=1, sweeps=3)
    mi, ni = spec.interior
    assert TK.cta_tile(mi, ni, lanes=8, pad=3, T=3, n_env=2, env_halo=True,
                       work=True) == (16, 128, 1)
    # two slots where they leave three CTAs an SM, and the measured cost
    # of fewer CTAs: lane-cells a useful cell, weighed
    assert TK.sweep_cells((32, 128), 2, 2) == (34 * 160 + 32 * 128) / 8192
    assert TK.sweep_cells((32, 128), 1, 1) == 1.0


# ---------------------------------------------------------------------------
# (b), (c) the "cuda-multistep" loop, on the plain path, against JAX
# ---------------------------------------------------------------------------

def _jloop(backend, boundary, unroll):
    return JP.LoopOfStencilReduce(
        f=j_heat, k=1, combine="max", cond=lambda r: r < 2e-3,
        delta=JR.abs_delta, boundary=boundary, max_iters=60, unroll=unroll,
        backend=backend, interpret=True, block=(32, 128))


# "pallas-multistep" runs the JAX kernel in interpret mode (slow): two
# cases; "jnp" at the same unroll covers the rest
@pytest.mark.parametrize("boundary,T,jbackend", [
    ("reflect", 3, "pallas-multistep"), ("zero", 2, "pallas-multistep"),
    ("nan", 2, "jnp"), ("wrap", 3, "jnp"), ("reflect", 2, "jnp"),
    ("zero", 4, "jnp")])
def test_multistep_loop_matches_reference(plain_kernels, boundary, T,
                                          jbackend):
    a = field(8, (40, 136))
    want = _jloop(jbackend, boundary, T).run(jnp.asarray(a))
    got = TP.LoopOfStencilReduce(
        f=TR.heat_taps(0.1), k=1, combine="max", cond=lambda r: r < 2e-3,
        delta=TR.abs_delta, boundary=boundary, max_iters=60, unroll=T,
        backend="cuda-multistep", device="cpu").run(a)
    assert int(got.iters) == int(want.iters)
    assert int(got.health) == int(want.health)
    inner = (slice(2, -2), slice(2, -2)) if boundary == "nan" \
        else (slice(None), slice(None))
    np.testing.assert_allclose(np.asarray(got.a)[inner],
                               np.asarray(want.a)[inner], atol=1e-5)
    if boundary != "nan":
        np.testing.assert_allclose(float(got.reduced), float(want.reduced),
                                   atol=1e-6)


def test_jacobi_solve_unroll_overshoots_by_less_than_T(plain_kernels):
    rng = np.random.default_rng(9)
    u0 = np.zeros((24, 40), np.float32)
    fxy = rng.normal(size=(24, 40)).astype(np.float32)
    kw = dict(alpha=2.0, dx=0.2, tol=1e-5, max_iters=400)
    ur, _, ir = JO.jacobi_solve(jnp.asarray(u0), jnp.asarray(fxy),
                                backend="jnp", **kw)
    _, _, ir3 = JO.jacobi_solve(jnp.asarray(u0), jnp.asarray(fxy),
                                backend="jnp", unroll=3, **kw)
    um, _, im = TO.jacobi_solve(u0, fxy, backend="cuda-multistep", unroll=3,
                                device="cpu", **kw)
    assert int(ir) <= int(im) < int(ir) + 3
    assert int(im) == int(ir3)
    np.testing.assert_allclose(np.asarray(um), np.asarray(ur), atol=1e-5)
    # the app wrappers take the backend too
    rng = np.random.default_rng(12)
    frame = rng.uniform(size=(24, 40)).astype(np.float32)
    mask = (rng.uniform(size=(24, 40)) < 0.3).astype(np.float32)
    jr, jd, ji = JO.restore(jnp.asarray(frame), jnp.asarray(mask),
                            backend="jnp", unroll=2)
    tr, td, ti = TO.restore(frame, mask, backend="cuda-multistep", unroll=2,
                            device="cpu")
    assert int(ti) == int(ji)
    np.testing.assert_allclose(np.asarray(tr), np.asarray(jr), atol=1e-5)
    assert float(td) == pytest.approx(float(jd), rel=1e-5, abs=1e-7)
    img = torch.as_tensor(field(10, (24, 40)))
    new, red = TO.fused_sweep(img, TR.heat_taps(0.1), backend="cuda-multistep",
                              unroll=3, combine="max", device="cpu")
    want = img
    for _ in range(3):
        want = TR.stencil2d_fused_ref(want, TR.heat_taps(0.1))[0]
    torch.testing.assert_close(new, want, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# (f) unroll="auto": the same arithmetic as the reference
# ---------------------------------------------------------------------------

SHAPES = [(64, 128), (16, 128), (40, 40), (1000, 1300), (8192, 8192),
          (3, 300)]


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("block", [(32, 32), (256, 256), (8, 128)])
def test_auto_unroll_equals_reference(k, block):
    for m, n in SHAPES:
        for segment in (None, 4, 16):
            kw = dict(k=k, block=block, segment=segment)
            try:
                want = j_auto_unroll(m, n, **kw)
            except ValueError as err:
                with pytest.raises(ValueError) as got:
                    TE.auto_unroll(m, n, **kw)
                assert str(got.value) == str(err)
                continue
            assert TE.auto_unroll(m, n, **kw) == want, (m, n, kw)


AUTO_SHAPES = [(64, 64), (100, 300), (256, 256), (1080, 1920), (8192, 8192)]


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("shape", AUTO_SHAPES)
def test_auto_resolves_to_the_reference_T(plain_kernels, shape, k):
    """``unroll="auto"`` with default arguments resolves to the reference's
    T (its default block), whatever the port's frame layout block."""
    want = JP.LoopOfStencilReduce(
        f=j_heat, k=k, cond=lambda r: True, unroll="auto",
        backend="pallas-multistep")._resolve_unroll(shape)
    loop = TP.LoopOfStencilReduce(
        f=TR.heat_taps(), k=k, cond=lambda r: True, unroll="auto",
        backend="cuda-multistep", device="cpu")
    assert loop._resolve_unroll(shape).unroll == want.unroll
    # a block the caller gives is the one T is counted on, as there
    want = dataclass_replace(want, unroll="auto", block=(32, 32))
    assert dataclass_replace(loop, block=(32, 32))._resolve_unroll(
        shape).unroll == want._resolve_unroll(shape).unroll
    single = dataclass_replace(loop, backend="cuda")
    assert single._resolve_unroll(shape).unroll == 1
    with pytest.raises(ValueError, match="unroll=30 is infeasible"):
        dataclass_replace(loop, unroll=30)._resolve_unroll((24, 24))


def test_auto_jacobi_solve_ends_with_the_reference_iters(plain_kernels):
    """64x64 Helmholtz to tol 1e-5 with ``unroll="auto"``: the reference's
    multistep kernel (interpret mode) and the port's backend pick the same
    T, so they stop at the same check with the same max|du| (within the
    multiply-add contraction of the reference's jitted loop)."""
    rng = np.random.default_rng(16)
    u0 = np.zeros((64, 64), np.float32)
    fxy = rng.normal(size=(64, 64)).astype(np.float32)
    kw = dict(alpha=2.0, dx=0.2, tol=1e-5, max_iters=1000, unroll="auto")
    ju, jd, ji = JO.jacobi_solve(jnp.asarray(u0), jnp.asarray(fxy),
                                 backend="pallas-multistep", **kw)
    tu, td, ti = TO.jacobi_solve(u0, fxy, backend="cuda-multistep",
                                 device="cpu", **kw)
    assert int(ti) == int(ji)
    assert abs(float(td) - float(jd)) <= 1e-7
    np.testing.assert_allclose(np.asarray(tu), np.asarray(ju), atol=1e-5)


def dataclass_replace(loop, **kw):
    import dataclasses
    return dataclasses.replace(loop, **kw)


# ---------------------------------------------------------------------------
# (g) bf16 frames: the plain sweep against the JAX kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("combine", ["sum", "max"])
def test_bf16_plain_sweep_matches_reference(combine):
    """bf16 frames, tolerance 5e-2 (rtol and atol) as the reference's own
    test: the JAX kernel (interpret mode, one case) and oracle round at
    other places than the port's torch ops."""
    a = field(11, (96, 160))
    ja = jnp.asarray(a, jnp.bfloat16)
    if combine == "max":
        jn, jr = j_fused(ja, JR.sobel_taps(), k=1, combine=combine,
                         boundary="reflect", block=(32, 128), interpret=True)
    else:
        jn, jr = JR.stencil2d_fused_ref(ja, JR.sobel_taps(), k=1,
                                        combine=combine, boundary="reflect")
    tn, tr = TK.stencil2d_fused(torch.as_tensor(a).to(torch.bfloat16),
                                TR.sobel_taps(), k=1, combine=combine,
                                boundary="reflect")
    assert tn.dtype == torch.bfloat16 and tr.dtype == torch.float32
    np.testing.assert_allclose(tn.float().numpy(),
                               np.asarray(jn, np.float32), atol=5e-2,
                               rtol=5e-2)
    np.testing.assert_allclose(float(tr), float(jr), atol=5e-2, rtol=5e-2)


def test_bf16_plain_multistep_tracks_float32():
    """The multistep plain version on bf16 frames and env stays within
    5e-2 of the float32 result after T=4 sweeps."""
    a, e = field(12, (40, 70)), field(13, (40, 70))
    f = TR.helmholtz_jacobi_taps(0.5, 0.2)
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        out[dt] = TM.stencil2d_multistep(
            torch.as_tensor(a).to(dt), f, env=(torch.as_tensor(e).to(dt),),
            T=4, combine="max", measure=TR.abs_delta, boundary="reflect")
    assert out[torch.bfloat16][0].dtype == torch.bfloat16
    torch.testing.assert_close(out[torch.bfloat16][0].float(),
                               out[torch.float32][0], atol=5e-2, rtol=5e-2)
    torch.testing.assert_close(out[torch.bfloat16][1],
                               out[torch.float32][1], atol=5e-2, rtol=5e-2)
