"""Port parity: the sharded 1:n deployment (``backend="cuda-sharded"``,
``repro_torch.sharding``, the sharded frames and engine, the fold of the
partial reduces) against the port's and the JAX package's single-device
loops and against the JAX ``"pallas-sharded"`` loop.

On the CPU a mesh repeats the CPU device (``["cpu"] * 8``, as 8x1 and
4x2) and the kernel wrappers run their plain versions (the device check is
bypassed by the ``plain_kernels`` fixture).  The JAX single-device loops run
in process; the JAX sharded loop needs eight XLA devices, so ONE
module-scoped fixture runs one subprocess with
``--xla_force_host_platform_device_count=8`` that computes every JAX
sharded case (meshes from ``repro.sharding.specs.make_mesh``) and writes
them to an ``.npz``.  Tolerances: grids within 1e-5 with equal NaN regions,
iteration counts equal, max/min/any reduces equal and sum reduces within
rel 1e-5 (per-shard partials folded in mesh order differ from one fold in
the last bits).
"""
import functools
import json
import os
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
from repro.core.executor import auto_unroll as j_auto_unroll  # noqa: E402
from repro.core.executor import \
    check_unroll_feasible as j_check_unroll  # noqa: E402
from repro.kernels import ops as JO  # noqa: E402
from repro.kernels import ref as JR  # noqa: E402
from repro_torch.core import executor as TE  # noqa: E402
from repro_torch.core import frames as TF  # noqa: E402
from repro_torch.core import pattern as TP  # noqa: E402
from repro_torch.core import reduce as TRd  # noqa: E402
from repro_torch.kernels import multistep as TM  # noqa: E402
from repro_torch.kernels import ops as TO  # noqa: E402
from repro_torch.kernels import ref as TR  # noqa: E402
from repro_torch.sharding import (GridPartition, gather_grid,  # noqa: E402
                                  make_mesh, scatter_grid)

ROOT = Path(__file__).resolve().parents[1]
BOUNDARIES = ["zero", "nan", "reflect", "wrap"]
LOPSIDED = [[0.0, 0.0, 0.3], [0.2, 0.25, 0.0], [0.0, 0.25, 0.0]]
SHAPE = (64, 64)
BLOCK = (16, 128)          # the reference tests' block


def j_heat(get, *_):
    lap = (get(-1, 0) + get(1, 0) + get(0, -1) + get(0, 1)
           - 4.0 * get(0, 0))
    return get(0, 0) + 0.1 * lap


def j_lopsided(get, *_):
    return (0.3 * get(-1, 1) + 0.25 * get(1, 0) + 0.2 * get(0, -1)
            + 0.25 * get(0, 0))


PORT_FN = {"heat": TR.heat_taps(0.1), "lopsided": TR.conv_taps(LOPSIDED)}
JAX_FN = {"heat": j_heat, "lopsided": j_lopsided}
# (combine, cond, port delta, jax delta); the "any" measure is a plain
# function, so it runs on the CPU only (the kernels fold registered
# measures)
MONOIDS = {
    "max": ("max", lambda r: r < 2e-3, TR.abs_delta, JR.abs_delta),
    "sum": ("sum", lambda r: r < 1.0, TR.abs_delta, JR.abs_delta),
    "any": ("any", lambda r: ~r,
            lambda n, o: torch.abs(n - o) > 1e-3,
            lambda n, o: jnp.abs(n - o) > 1e-3),
}


def grid(seed=0, shape=SHAPE):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def cpu_mesh(kind):
    if kind == "8x1":
        mesh = make_mesh((8,), ("data",), devices=["cpu"] * 8)
        return GridPartition(mesh, ("data",), (0,))
    if kind == "4x2":
        mesh = make_mesh((4, 2), ("data", "model"), devices=["cpu"] * 8)
        return GridPartition(mesh, ("data", "model"), (0, 1))
    if kind == "8x1x1":     # a 2-D split whose column axis has one shard
        mesh = make_mesh((8, 1), ("data", "model"), devices=["cpu"] * 8)
        return GridPartition(mesh, ("data", "model"), (0, 1))
    raise ValueError(kind)


@pytest.fixture
def plain_kernels(monkeypatch):
    """Let the kernel backends run on CPU tensors, where every kernel
    wrapper runs its plain version (only the device check stops them)."""
    for mod in (TP, TE):
        monkeypatch.setattr(mod, "resolve_backend",
                            lambda b, d: b or "torch")


def tloop(backend, boundary="zero", unroll=1, part=None, fn="heat",
          monoid="max", max_iters=12, cond=None):
    comb, c, delta, _ = MONOIDS[monoid]
    return TP.LoopOfStencilReduce(
        f=PORT_FN[fn], k=1, combine=comb, cond=cond or c, delta=delta,
        boundary=boundary, max_iters=max_iters, unroll=unroll,
        backend=backend, partition=part,
        device=None if part is not None else "cpu")


def jloop(backend, boundary="zero", unroll=1, fn="heat", monoid="max",
          max_iters=12, cond=None):
    comb, c, _, delta = MONOIDS[monoid]
    return JP.LoopOfStencilReduce(
        f=JAX_FN[fn], k=1, combine=comb, cond=cond or c, delta=delta,
        boundary=boundary, max_iters=max_iters, unroll=unroll,
        backend=backend, interpret=True, block=BLOCK)


@functools.lru_cache(maxsize=None)
def jax_single(backend, boundary, unroll, fn="heat", monoid="max",
               max_iters=12, cond_key=None, seed=0):
    cond = COND[cond_key] if cond_key else None
    r = jloop(backend, boundary, unroll, fn, monoid, max_iters,
              cond).run(jnp.asarray(grid(seed)))
    return np.asarray(r.a), np.asarray(r.reduced), int(r.iters)


COND = {"terminate": lambda r: r < 2e-2}


def check(got, want_a, want_r, want_it, monoid="max", atol=1e-5):
    """Iteration counts equal, grids within ``atol`` with equal NaN
    regions, reduces equal (sum: rel 1e-5)."""
    assert int(got.iters) == int(want_it)
    ga, wa = np.asarray(got.a), np.asarray(want_a)
    np.testing.assert_array_equal(np.isnan(ga), np.isnan(wa))
    np.testing.assert_allclose(ga, wa, atol=atol, rtol=0, equal_nan=True)
    gr, wr = np.asarray(got.reduced), np.asarray(want_r)
    if monoid == "sum":
        np.testing.assert_allclose(gr, wr, rtol=1e-5, atol=1e-7)
    elif gr.dtype == bool or wr.dtype == bool:
        assert bool(gr) == bool(wr)
    else:
        np.testing.assert_allclose(gr, wr, rtol=0, atol=1e-7,
                                   equal_nan=True)


# ---------------------------------------------------------------------------
# the JAX sharded cases, in one subprocess with eight XLA host devices
# ---------------------------------------------------------------------------

# (mesh, boundary, T, stencil, monoid): interpret mode takes ~4 s a case
PS_CASES = [("8x1", "reflect", 1, "heat", "max"),
            ("8x1", "wrap", 4, "heat", "max"),
            ("4x2", "zero", 4, "heat", "max"),
            ("4x2", "nan", 1, "heat", "max"),
            ("4x2", "reflect", 4, "lopsided", "max"),
            ("4x2", "zero", 1, "heat", "sum")]
# per-shard partials for the collective (NaN in shard 3 of the second row)
PARTIALS = [[0.5, -1.0, 2.0, 0.25, 3.0, -2.0, 1.5, 0.0],
            [0.5, -1.0, 2.0, float("nan"), 3.0, -2.0, 1.5, 0.0]]

JAX_SHARDED = textwrap.dedent("""
    import json, sys
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro.core import GridPartition, LoopOfStencilReduce
    from repro.core.reduce import MONOIDS, collective_combine
    from repro.kernels import ref as R
    from repro.sharding.specs import make_mesh, shard_map

    out_path, spec = sys.argv[1], json.loads(sys.argv[2])
    a = jnp.asarray(np.random.default_rng(0).normal(size=(64, 64))
                    .astype(np.float32))

    def heat(get, *_):
        lap = get(-1,0)+get(1,0)+get(0,-1)+get(0,1)-4.0*get(0,0)
        return get(0,0)+0.1*lap

    def lopsided(get, *_):
        return (0.3 * get(-1, 1) + 0.25 * get(1, 0) + 0.2 * get(0, -1)
                + 0.25 * get(0, 0))

    m8 = make_mesh((8,), ("data",))
    m42 = make_mesh((4, 2), ("data", "model"))
    parts = {"8x1": GridPartition(mesh=m8, axis_names=("data",),
                                  array_axes=(0,)),
             "4x2": GridPartition(mesh=m42, axis_names=("data", "model"),
                                  array_axes=(0, 1))}
    conds = {"max": lambda r: r < 2e-3, "sum": lambda r: r < 1.0}
    res = {}
    for i, (mesh, b, T, fn, comb) in enumerate(spec["cases"]):
        r = LoopOfStencilReduce(
            f={"heat": heat, "lopsided": lopsided}[fn], k=1, combine=comb,
            cond=conds[comb], delta=R.abs_delta, boundary=b, max_iters=12,
            unroll=T, backend="pallas-sharded", partition=parts[mesh],
            interpret=True, block=(16, 128)).run(a)
        res[f"case{i}_a"] = np.asarray(r.a)
        res[f"case{i}_r"] = np.asarray(r.reduced)
        res[f"case{i}_it"] = np.asarray(r.iters)
    # the collective over eight shards: one partial a shard
    for j, row in enumerate(spec["partials"]):
        x = jnp.asarray(row, jnp.float32)
        for name in ("sum", "max", "min"):
            op = MONOIDS[name][0]
            f = shard_map(lambda v, op=op: collective_combine(op, v[0],
                                                              ("data",)),
                          mesh=m8, in_specs=(P("data"),), out_specs=P())
            res[f"coll{j}_{name}"] = np.asarray(f(x))
        for name in ("any", "all"):
            op = MONOIDS[name][0]
            f = shard_map(lambda v, op=op: collective_combine(op, v[0],
                                                              ("data",)),
                          mesh=m8, in_specs=(P("data"),), out_specs=P())
            res[f"coll{j}_{name}"] = np.asarray(f(x > 0.0))
    np.savez(out_path, **res)
""")


@pytest.fixture(scope="module")
def jax_sharded(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_sharded") / "cases.npz"
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    spec = json.dumps({"cases": PS_CASES, "partials": PARTIALS})
    run = subprocess.run([sys.executable, "-c", JAX_SHARDED, str(out), spec],
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    return dict(np.load(out))


# ---------------------------------------------------------------------------
# mesh, partition, scatter and gather
# ---------------------------------------------------------------------------


def test_mesh_and_partition():
    mesh = make_mesh((4, 2), ("data", "model"), devices=["cpu"] * 8)
    assert mesh.shape == {"data": 4, "model": 2}
    assert mesh == make_mesh((4, 2), ("data", "model"),
                             devices=["cpu"] * 8)
    part = GridPartition(mesh, ["data", "model"], [0, 1])
    assert part.axis_names == ("data", "model")
    assert part.shards == (4, 2) and part.n_shards == 8
    assert part.axis_size("model") == 2
    assert part.stride("data") == 2 and part.stride("model") == 1
    assert part.coords(5) == (2, 1)
    assert part.lead == torch.device("cpu")
    assert len({part, GridPartition(mesh, ("data", "model"), (0, 1))}) == 1
    with pytest.raises(dataclasses_frozen_error()):
        part.axis_names = ("x",)
    # a partition over one axis of a 2-D mesh: one copy on the other
    # axis's first device (shard_map would replicate it there)
    mixed = make_mesh((2, 2), ("data", "model"),
                      devices=["cpu", "meta", "cpu", "meta"])
    rows = GridPartition(mixed, ("data",), (0,))
    assert [d.type for d in rows.devices] == ["cpu", "cpu"]
    with pytest.raises(ValueError, match="no axis"):
        GridPartition(mesh, ("pod",), (0,))
    with pytest.raises(ValueError, match="holds 8 devices"):
        make_mesh((4, 2), ("data", "model"), devices=["cpu"] * 4)


def dataclasses_frozen_error():
    import dataclasses
    return dataclasses.FrozenInstanceError


def test_make_mesh_takes_the_cards_and_raises_without_enough(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="0 CUDA cards are visible"):
        make_mesh((2, 2), ("data", "model"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="needs 4 devices"):
        make_mesh((4,), ("data",))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    mesh = make_mesh((2, 2), ("data", "model"))
    assert [str(d) for d in mesh.devices.flat] == [
        "cuda:0", "cuda:1", "cuda:2", "cuda:3"]


@pytest.mark.parametrize("kind,shape", [("8x1", (64,)), ("8x1", (64, 24)),
                                        ("4x2", (64, 24))])
def test_scatter_gather_roundtrip(kind, shape):
    """"Evenly for 1D array and by rows for 2D matrix": blocks are the
    even split in mesh order, and gather restores the grid."""
    part = cpu_mesh(kind)
    a = torch.as_tensor(grid(3, shape))
    blocks = scatter_grid(a, part)
    if kind == "8x1":
        want = np.split(a.numpy(), 8, axis=0)
    else:
        want = [c for r in np.split(a.numpy(), 4, axis=0)
                for c in np.split(r, 2, axis=1)]
    for b, w in zip(blocks, want):
        np.testing.assert_array_equal(b.numpy(), w)
    assert torch.equal(gather_grid(blocks, part), a)


# ---------------------------------------------------------------------------
# cuda-sharded against the single-device loops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["8x1", "4x2"])
@pytest.mark.parametrize("boundary", BOUNDARIES)
@pytest.mark.parametrize("T", [1, 4])
def test_cuda_sharded_matches_single_device(plain_kernels, kind, boundary,
                                            T):
    """Every boundary, both meshes, T = 1 and 4: the sharded loop against
    the port's single-device kernel loop and the JAX ``"jnp"`` loop."""
    a = grid()
    got = tloop("cuda-sharded", boundary, T, cpu_mesh(kind)).run(a)
    single = tloop("cuda-multistep" if T > 1 else "cuda", boundary,
                   T).run(a)
    check(got, single.a, single.reduced, single.iters)
    check(got, *jax_single("jnp", boundary, T))


@pytest.mark.parametrize("i", range(len(PS_CASES)))
def test_cuda_sharded_matches_jax_pallas_sharded(plain_kernels, jax_sharded,
                                                 i):
    kind, boundary, T, fn, monoid = PS_CASES[i]
    got = tloop("cuda-sharded", boundary, T, cpu_mesh(kind), fn,
                monoid).run(grid())
    check(got, jax_sharded[f"case{i}_a"], jax_sharded[f"case{i}_r"],
          jax_sharded[f"case{i}_it"], monoid)


@pytest.mark.parametrize("boundary,T", [("reflect", 4), ("nan", 1)])
def test_cuda_sharded_matches_jax_pallas_interpret(plain_kernels, boundary,
                                                   T):
    got = tloop("cuda-sharded", boundary, T, cpu_mesh("4x2")).run(grid())
    check(got, *jax_single("pallas", boundary, T))


@pytest.mark.parametrize("monoid", ["sum", "max", "any"])
@pytest.mark.parametrize("T", [1, 4])
def test_monoids(plain_kernels, monoid, T):
    got = tloop("cuda-sharded", "zero", T, cpu_mesh("4x2"),
                monoid=monoid).run(grid())
    single = tloop("cuda-multistep" if T > 1 else "cuda", "zero", T,
                   monoid=monoid).run(grid())
    check(got, single.a, single.reduced, single.iters, monoid)
    check(got, *jax_single("jnp", "zero", T, monoid=monoid), monoid)


@pytest.mark.parametrize("kind", ["8x1", "4x2"])
@pytest.mark.parametrize("T", [1, 4])
def test_terminating_loop_has_equal_iters(plain_kernels, kind, T):
    """A tolerance the loop reaches mid-run: the iteration counts equal
    the single-device loops' (the condition is read from the fold)."""
    got = tloop("cuda-sharded", "reflect", T, cpu_mesh(kind), max_iters=400,
                cond=COND["terminate"]).run(grid())
    want = jax_single("jnp", "reflect", T, max_iters=400,
                      cond_key="terminate")
    assert int(got.iters) < 400
    check(got, *want)


@pytest.mark.parametrize("boundary", BOUNDARIES)
@pytest.mark.parametrize("T", [1, 4])
def test_diagonal_taps_on_a_2d_mesh(plain_kernels, boundary, T):
    """The corner case: a stencil with a diagonal tap on the 4x2 mesh,
    whose corner ghosts come from the diagonal neighbour (axis 0 before
    axis 1).  Heat has no diagonal tap and would not show the fault."""
    got = tloop("cuda-sharded", boundary, T, cpu_mesh("4x2"),
                "lopsided").run(grid(1))
    single = tloop("cuda-multistep" if T > 1 else "cuda", boundary, T,
                   fn="lopsided").run(grid(1))
    check(got, single.a, single.reduced, single.iters)
    check(got, *jax_single("jnp", boundary, T, "lopsided", seed=1))


@pytest.mark.parametrize("T", [1, 4])
def test_wrap_on_a_mesh_axis_of_size_one(plain_kernels, T):
    """WRAP on a mesh axis of one shard exchanges with itself: the same as
    the local wrap, and as the 1-D split."""
    a = grid(2)
    got = tloop("cuda-sharded", "wrap", T, cpu_mesh("8x1x1"),
                "lopsided").run(a)
    one_d = tloop("cuda-sharded", "wrap", T, cpu_mesh("8x1"),
                  "lopsided").run(a)
    single = tloop("cuda-multistep" if T > 1 else "cuda", "wrap", T,
                   fn="lopsided").run(a)
    check(got, single.a, single.reduced, single.iters)
    np.testing.assert_array_equal(got.a.numpy(), one_d.a.numpy())


def test_exchange_on_one_shard_is_the_local_refresh():
    """A 1x1 mesh: the sharded exchange equals refresh_frame on the domain
    and its ghost ring, corners included, for every boundary (cells past
    the ring, which no domain cell reads, may differ)."""
    part = GridPartition(make_mesh((1, 1), ("data", "model"),
                                   devices=["cpu"]), ("data", "model"),
                         (0, 1))
    a = torch.as_tensor(grid(4, (24, 40)))
    for b in BOUNDARIES:
        sspec = TF.sharded_frame_spec(24, 40, part, k=1, sweeps=3)
        ring = (slice(0, 24 + 6), slice(0, 40 + 6))
        got = TF.make_frames_sharded([a], sspec, b)[0][ring]
        want = TF.make_frame(a, sspec.local, b)[ring]
        assert torch.equal(torch.nan_to_num(got, nan=7.0),
                           torch.nan_to_num(want, nan=7.0)), b


@pytest.mark.parametrize("T", [1, 4])
def test_env_fields(plain_kernels, T):
    """Helmholtz with its right-hand side as an env field: interior layout
    at T = 1, halo layout with the neighbours' env at T = 4."""
    u0, fx = np.zeros(SHAPE, np.float32), grid(5)
    kw = dict(f=TR.helmholtz_jacobi_taps(2.0, 0.2), k=1, combine="max",
              cond=lambda r: r < 1e-4, delta=TR.abs_delta, max_iters=200,
              unroll=T)
    got = TP.LoopOfStencilReduce(backend="cuda-sharded",
                                 partition=cpu_mesh("4x2"), **kw).run(
        u0, env=(fx,))
    single = TP.LoopOfStencilReduce(
        backend="cuda-multistep" if T > 1 else "cuda", device="cpu",
        **kw).run(u0, env=(fx,))
    check(got, single.a, single.reduced, single.iters)
    assert int(got.iters) < 200


def test_ops_apps_with_part(plain_kernels):
    """``jacobi_solve`` and ``restore`` with ``part=``: the same iters as
    the single-device apps of both packages, grids within 1e-5."""
    u0, fx = np.zeros(SHAPE, np.float32), grid(6)
    kw = dict(alpha=2.0, dx=0.2, tol=1e-4, max_iters=200)
    ju, jd, ji = JO.jacobi_solve(jnp.asarray(u0), jnp.asarray(fx),
                                 backend="jnp", **kw)
    for kind, T in (("8x1", 1), ("4x2", 4)):
        tu, td, ti = TO.jacobi_solve(u0, fx, part=cpu_mesh(kind), unroll=T,
                                     **kw)
        su, sd, si = TO.jacobi_solve(u0, fx, device="cpu", unroll=T, **kw)
        assert int(ti) == int(si) and tu.device.type == "cpu"
        np.testing.assert_allclose(tu.numpy(), su.numpy(), atol=1e-5)
        assert float(td) == float(sd)
        if T == 1:
            assert int(ti) == int(ji)
            np.testing.assert_allclose(tu.numpy(), np.asarray(ju),
                                       atol=1e-5)
    rng = np.random.default_rng(7)
    frame = rng.uniform(size=SHAPE).astype(np.float32)
    mask = (rng.uniform(size=SHAPE) < 0.3).astype(np.float32)
    jr, jdd, jit = JO.restore(jnp.asarray(frame), jnp.asarray(mask),
                              backend="jnp", tol=1e-4)
    sr, sdd, sit = TO.restore(frame, mask, device="cpu", tol=1e-4)
    for kind in ("8x1", "4x2"):
        tr, tdd, tit = TO.restore(frame, mask, part=cpu_mesh(kind),
                                  tol=1e-4)
        assert int(tit) == int(sit) == int(jit)
        np.testing.assert_allclose(tr.numpy(), sr.numpy(), atol=1e-5)
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-5)
        assert float(tdd) == pytest.approx(float(sdd), rel=1e-5)
        # against the reference, as tests/test_torch_ops.py holds restore:
        # the converged mean |Δ| is a difference of iterates that agree to
        # a few ulps (XLA contracts multiply-adds), an absolute error
        assert float(tdd) == pytest.approx(float(jdd), rel=1e-5, abs=1e-7)


# ---------------------------------------------------------------------------
# the fold of the partial reduces, bounds, auto T, messages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("row", [0, 1])
def test_collective_combine_matches_the_reference(jax_sharded, row):
    vals = [torch.tensor(v) for v in PARTIALS[row]]
    for name in ("sum", "max", "min"):
        op = TRd.MONOIDS[name][0]
        got = TRd.collective_combine(op, vals)
        want = jax_sharded[f"coll{row}_{name}"]
        assert got.shape == ()
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                   equal_nan=True)
    for name in ("any", "all"):
        op = TRd.MONOIDS[name][0]
        got = TRd.collective_combine(op, [v > 0.0 for v in vals])
        assert bool(got) == bool(jax_sharded[f"coll{row}_{name}"])
    if row == 1:
        assert torch.isnan(TRd.collective_combine(torch.maximum, vals))


def test_max_fold_propagates_nan_without_the_explicit_rule():
    """``torch.maximum``/``minimum`` already propagate NaN in either
    position (the rule the reference adds to its all-reduce), and prod
    folds with ⊕ (the reference's psum would sum it)."""
    for a, b in ((float("nan"), 1.0), (1.0, float("nan"))):
        assert torch.isnan(torch.maximum(torch.tensor(a), torch.tensor(b)))
        assert torch.isnan(torch.minimum(torch.tensor(a), torch.tensor(b)))
    vals = [torch.tensor(v) for v in (2.0, 3.0, 0.5)]
    assert float(TRd.collective_combine(TRd.MONOIDS["prod"][0], vals)) \
        == 3.0


def test_shard_domain_bounds_are_host_ints_with_sentinels():
    part = cpu_mesh("4x2")
    sspec = TF.sharded_frame_spec(16, 32, part, k=1, sweeps=4)
    big, p = 1 << 30, 4
    assert TF.shard_domain_bounds(sspec, 0) == (p, big, p, big)
    assert TF.shard_domain_bounds(sspec, 3) == (-big, big, -big, p + 32)
    assert TF.shard_domain_bounds(sspec, 7) == (-big, p + 16, -big, p + 32)
    assert all(type(v) is int for v in TF.shard_domain_bounds(sspec, 5))
    assert TM._bounds(sspec.local, (1, 2, 3, 4)) == (1, 2, 3, 4)
    assert TM.SENTINEL == big


@pytest.mark.parametrize("m,n,kind,k", [(64, 64, "8x1", 1),
                                        (64, 64, "4x2", 1),
                                        (512, 512, "4x2", 1),
                                        (2048, 1024, "8x1", 2),
                                        (4096, 4096, "4x2", 3)])
def test_auto_unroll_counts_on_the_local_extents(plain_kernels, m, n, kind,
                                                k):
    part = cpu_mesh(kind)
    duck = SimpleNamespace(mesh=SimpleNamespace(shape=part.mesh.shape),
                           axis_names=part.axis_names,
                           array_axes=part.array_axes, shards=part.shards)
    assert TE.auto_unroll(m, n, k=k, part=part) == \
        j_auto_unroll(m, n, k=k, part=duck)
    loop = TP.LoopOfStencilReduce(
        f=TR.heat_taps(0.1), k=k, cond=bool, unroll="auto",
        backend="torch", device="cpu")
    loop.backend, loop.partition = "cuda-sharded", part
    assert loop._resolve_unroll((m, n)).unroll == \
        j_auto_unroll(m, n, k=k, part=duck)


def test_error_messages(plain_kernels):
    part = cpu_mesh("8x1")
    duck = SimpleNamespace(mesh=SimpleNamespace(shape=part.mesh.shape),
                           axis_names=part.axis_names,
                           array_axes=part.array_axes, shards=part.shards)
    with pytest.raises(ValueError) as got:
        TE.check_unroll_feasible(64, 64, 8, k=1, part=part)
    with pytest.raises(ValueError) as want:
        j_check_unroll(64, 64, 8, k=1, part=duck)
    assert str(got.value) == str(want.value)
    assert "each of the (8,) shards holds a local 8x64 block" in \
        str(got.value)
    with pytest.raises(ValueError, match="infeasible"):
        tloop("cuda-sharded", unroll=8, part=part).run(grid())
    with pytest.raises(ValueError, match="needs a partition="):
        TP.LoopOfStencilReduce(f=TR.heat_taps(0.1), cond=bool,
                               backend="cuda-sharded", device="cpu")
    with pytest.raises(ValueError, match="must divide evenly over mesh "
                                         "axis 'data' \\(size 8\\)"):
        tloop("cuda-sharded", part=part).run(np.zeros((60, 64), np.float32))
    with pytest.raises(ValueError, match="-s variant"):
        TP.LoopOfStencilReduce(
            f=TR.heat_taps(0.1), cond=lambda r, s: True,
            state_init=lambda: torch.zeros(()),
            state_update=lambda s, a, it: s, backend="cuda-sharded",
            partition=part).run(grid())
    with pytest.raises(ValueError, match="FarmEngine"):
        tloop("cuda-sharded", part=part).farm_run(
            np.zeros((2, 64, 64), np.float32))
    with pytest.raises(ValueError, match="lead device"):
        TP.LoopOfStencilReduce(f=TR.heat_taps(0.1), cond=bool,
                               backend="cuda-sharded", partition=part,
                               device="meta")
    with pytest.raises(ValueError, match="conflicts"):
        TO.jacobi_solve(grid(), grid(), part=part, backend="cuda")
    with pytest.raises(ValueError, match="sweep_once"):
        TE.sweep_once(grid(), TR.heat_taps(0.1), backend="cuda-sharded",
                      device="cpu")


def test_kernel_backend_refuses_a_cpu_mesh():
    """Without the bypass, a mesh of CPU devices is refused by the kernel
    backend (no plain fallback), as on the single-device backends."""
    with pytest.raises(ValueError, match="needs a CUDA device"):
        tloop("cuda-sharded", part=cpu_mesh("8x1"))
