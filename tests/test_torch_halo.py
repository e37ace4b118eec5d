"""Port parity: the halo exchange and the distributed loop
(``repro_torch.core.halo``) against ``repro.core.halo``, and the generic
sharded farm against ``repro.core.streaming.sharded_farm``.

The JAX side needs eight XLA devices, so ONE module-scoped fixture runs one
subprocess with ``--xla_force_host_platform_device_count=8`` (meshes from
``repro.sharding.specs.make_mesh``) that computes every JAX case and writes
them to an ``.npz``; the port runs on meshes of the CPU device repeated
(8x1, 4x2, and 8x1 whose column axis has one shard).  The kernel route
(``"cuda-sharded"``) runs the kernel wrappers' plain versions (the
``plain_kernels`` fixture).  Tolerances: grown blocks exact; grids within
1e-5 with equal NaN regions (XLA contracts multiply-adds in the jitted
loop, the port does not), iteration counts and max reduces equal, sum
reduces within rel 1e-5.
"""
import json
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
from repro.kernels import ref as JR  # noqa: E402
from repro_torch.core import executor as TE  # noqa: E402
from repro_torch.core import pattern as TP  # noqa: E402
from repro_torch.core import streaming as TS  # noqa: E402
from repro_torch.core.halo import (distributed_loop_of_stencil_reduce,  # noqa: E402,E501
                                   exchange_halo)
from repro_torch.core.stencil import stencil_taps  # noqa: E402
from repro_torch.kernels import ref as TR  # noqa: E402
from repro_torch.sharding import (GridPartition, gather_grid,  # noqa: E402
                                  make_mesh, scatter_grid)

ROOT = Path(__file__).resolve().parents[1]
BOUNDARIES = ["zero", "nan", "reflect", "wrap"]
MESHES = ["8x1", "4x2"]
DIST_CASES = [(kind, b, T) for kind in MESHES for b in BOUNDARIES
              for T in (1, 4)]
# a tolerance the loop reaches mid-run, on each mesh and T
STOP_CASES = [(kind, T) for kind in MESHES for T in (1, 4)]
MONOID_CASES = [("sum", 1), ("sum", 4), ("any", 1)]


def heat(get, *_):
    lap = (get(-1, 0) + get(1, 0) + get(0, -1) + get(0, 1)
           - 4.0 * get(0, 0))
    return get(0, 0) + 0.1 * lap


def blur(get, *_):
    """k = 2 with diagonal (corner) taps."""
    return sum(get(i, j) for i in (-2, -1, 0, 1, 2)
               for j in (-2, -1, 0, 1, 2)) / 25.0


def grid(seed=0, shape=(64, 64)):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def cpu_mesh(kind):
    if kind == "8x1":
        return GridPartition(make_mesh((8,), ("data",), devices=["cpu"] * 8),
                             ("data",), (0,))
    shape = (4, 2) if kind == "4x2" else (8, 1)
    return GridPartition(make_mesh(shape, ("data", "model"),
                                   devices=["cpu"] * 8),
                         ("data", "model"), (0, 1))


@pytest.fixture
def plain_kernels(monkeypatch):
    """Let the kernel backends run on CPU tensors, where every kernel
    wrapper runs its plain version (only the device check stops them)."""
    for mod in (TP, TE):
        monkeypatch.setattr(mod, "resolve_backend",
                            lambda b, d: b or "torch")


JAX_HALO = textwrap.dedent("""
    import json, sys
    import numpy as np, jax, jax.numpy as jnp
    from repro.core import GridPartition, distributed_loop_of_stencil_reduce
    from repro.core.halo import exchange_halo
    from repro.core.stencil import stencil_taps
    from repro.core.streaming import sharded_farm
    from repro.kernels import ref as R
    from repro.sharding.specs import make_mesh, shard_map

    out_path, spec = sys.argv[1], json.loads(sys.argv[2])
    rng = lambda s: np.random.default_rng(s)
    a = jnp.asarray(rng(0).normal(size=(64, 64)).astype(np.float32))

    def heat(get, *_):
        lap = get(-1,0)+get(1,0)+get(0,-1)+get(0,1)-4.0*get(0,0)
        return get(0,0)+0.1*lap

    def blur(get, *_):
        return sum(get(i, j) for i in (-2,-1,0,1,2)
                   for j in (-2,-1,0,1,2)) / 25.0

    parts = {
        "8x1": GridPartition(mesh=make_mesh((8,), ("data",)),
                             axis_names=("data",), array_axes=(0,)),
        "4x2": GridPartition(mesh=make_mesh((4, 2), ("data", "model")),
                             axis_names=("data", "model"),
                             array_axes=(0, 1)),
        "8x1x1": GridPartition(mesh=make_mesh((8, 1), ("data", "model")),
                               axis_names=("data", "model"),
                               array_axes=(0, 1)),
    }
    res = {}
    for kind in ("8x1", "4x2", "8x1x1"):
        part = parts[kind]
        for b in ("zero", "nan", "reflect", "wrap"):
            def grow(x, b=b, part=part):
                for name, ax in zip(part.axis_names, part.array_axes):
                    x = exchange_halo(x, 2, ax, name, b)
                return x
            f = shard_map(grow, mesh=part.mesh, in_specs=(part.pspec,),
                          out_specs=part.pspec)
            res[f"ex_{kind}_{b}"] = np.asarray(f(a))

    def dist(kind, **kw):
        r = distributed_loop_of_stencil_reduce(
            heat, kw.pop("combine", "max"), kw.pop("cond"), a, k=1,
            part=parts[kind], **kw)
        return np.asarray(r.a), np.asarray(r.reduced), np.asarray(r.iters)

    for kind, b, T in spec["dist"]:
        res.update(zip([f"d_{kind}_{b}_{T}_{x}" for x in "ari"], dist(
            kind, cond=lambda r: r < 2e-3, delta=R.abs_delta, max_iters=12,
            boundary=b, unroll=T)))
    for kind, T in spec["stop"]:
        res.update(zip([f"s_{kind}_{T}_{x}" for x in "ari"], dist(
            kind, cond=lambda r: r < 2e-2, delta=R.abs_delta, max_iters=400,
            boundary="reflect", unroll=T)))
    for comb, T in spec["monoids"]:
        cond, delta = ((lambda r: r < 1.0, R.abs_delta) if comb == "sum"
                       else (lambda r: ~r,
                             lambda n, o: jnp.abs(n - o) > 1e-3))
        res.update(zip([f"m_{comb}_{T}_{x}" for x in "ari"], dist(
            "4x2", combine=comb, cond=cond, delta=delta, max_iters=12,
            unroll=T)))
    r = distributed_loop_of_stencil_reduce(
        blur, "max", lambda r: False, a, k=2, part=parts["4x2"],
        identity=-jnp.inf, boundary="reflect", max_iters=5)
    res["blur_a"], res["blur_it"] = np.asarray(r.a), np.asarray(r.iters)
    r = distributed_loop_of_stencil_reduce(
        heat, "max", lambda r: False, a, k=1, part=parts["8x1x1"],
        boundary="wrap", max_iters=3)
    res["wrap1_a"] = np.asarray(r.a)
    items = jnp.asarray(rng(1).normal(size=(16, 8, 8)).astype(np.float32))
    worker = lambda x: stencil_taps(heat, x, 1, "reflect") * 2.0 + 1.0
    res["farm"] = np.asarray(sharded_farm(worker, parts["8x1"].mesh)(items))
    np.savez(out_path, **res)
""")


@pytest.fixture(scope="module")
def jax_halo(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_halo") / "cases.npz"
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    spec = json.dumps({"dist": DIST_CASES, "stop": STOP_CASES,
                       "monoids": MONOID_CASES})
    run = subprocess.run([sys.executable, "-c", JAX_HALO, str(out), spec],
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    return dict(np.load(out))


def check(got, want_a, want_r, want_it, monoid="max"):
    assert int(got.iters) == int(want_it)
    ga, wa = np.asarray(got.a), np.asarray(want_a)
    np.testing.assert_array_equal(np.isnan(ga), np.isnan(wa))
    np.testing.assert_allclose(ga, wa, atol=1e-5, rtol=0, equal_nan=True)
    gr, wr = np.asarray(got.reduced), np.asarray(want_r)
    if monoid == "sum":
        np.testing.assert_allclose(gr, wr, rtol=1e-5, atol=1e-7)
    elif monoid == "any":
        assert bool(gr) == bool(wr)
    else:
        np.testing.assert_allclose(gr, wr, rtol=0, atol=1e-7,
                                   equal_nan=True)


def dist(kind, backend="torch", f=heat, **kw):
    kw.setdefault("combine", "max")
    kw.setdefault("cond", lambda r: r < 2e-3)
    kw.setdefault("delta", TR.abs_delta)
    kw.setdefault("max_iters", 12)
    return distributed_loop_of_stencil_reduce(
        f, kw.pop("combine"), kw.pop("cond"), grid(), k=kw.pop("k", 1),
        part=cpu_mesh(kind), backend=backend, **kw)


# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["8x1", "4x2", "8x1x1"])
@pytest.mark.parametrize("boundary", BOUNDARIES)
def test_exchange_halo_matches_the_reference(jax_halo, kind, boundary):
    """Blocks grown by 2k = 4 along every decomposed axis, axis 0 first
    (on 4x2 the corners come from the diagonal neighbour), cell for
    cell."""
    part = cpu_mesh(kind)
    blocks = scatter_grid(torch.as_tensor(grid()), part)
    for ax in part.array_axes:
        blocks = exchange_halo(blocks, 2, ax, part, boundary)
    got = gather_grid(blocks, part).numpy()
    want = jax_halo[f"ex_{kind}_{boundary}"]
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind,boundary,T", DIST_CASES)
def test_torch_route_matches_the_reference(jax_halo, kind, boundary, T):
    got = dist(kind, boundary=boundary, unroll=T)
    check(got, *(jax_halo[f"d_{kind}_{boundary}_{T}_{x}"] for x in "ari"))


@pytest.mark.parametrize("kind,boundary,T", DIST_CASES)
def test_cuda_sharded_route_matches_the_reference(plain_kernels, jax_halo,
                                                  kind, boundary, T):
    got = dist(kind, "cuda-sharded", TR.heat_taps(0.1), boundary=boundary,
               unroll=T)
    check(got, *(jax_halo[f"d_{kind}_{boundary}_{T}_{x}"] for x in "ari"))


@pytest.mark.parametrize("kind,T", STOP_CASES)
def test_terminating_routes_have_the_reference_iters(plain_kernels, jax_halo,
                                                     kind, T):
    want = [jax_halo[f"s_{kind}_{T}_{x}"] for x in "ari"]
    assert int(want[2]) < 400
    kw = dict(cond=lambda r: r < 2e-2, max_iters=400, boundary="reflect",
              unroll=T)
    check(dist(kind, **kw), *want)
    check(dist(kind, "cuda-sharded", TR.heat_taps(0.1), **kw), *want)


@pytest.mark.parametrize("comb,T", MONOID_CASES)
def test_monoids_on_the_torch_route(jax_halo, comb, T):
    cond, delta = ((lambda r: r < 1.0, TR.abs_delta) if comb == "sum"
                   else (lambda r: ~r,
                         lambda n, o: torch.abs(n - o) > 1e-3))
    got = dist("4x2", combine=comb, cond=cond, delta=delta, unroll=T)
    check(got, *(jax_halo[f"m_{comb}_{T}_{x}"] for x in "ari"), comb)


def test_corners_with_a_k2_stencil(plain_kernels, jax_halo):
    """k = 2 with diagonal taps on the 2-D mesh: the torch route and the
    kernel route against the reference's distributed loop."""
    kw = dict(cond=lambda r: False, boundary="reflect", max_iters=5,
              identity=float("-inf"), delta=None, k=2)
    got = dist("4x2", f=blur, **kw)
    assert int(got.iters) == int(jax_halo["blur_it"]) == 5
    np.testing.assert_allclose(got.a.numpy(), jax_halo["blur_a"], atol=1e-5)
    kern = dist("4x2", "cuda-sharded", TR.conv_taps(np.full((5, 5), 0.04)),
                **kw)
    np.testing.assert_allclose(kern.a.numpy(), jax_halo["blur_a"],
                               atol=1e-5)


def test_wrap_on_a_mesh_axis_of_size_one(jax_halo):
    kw = dict(cond=lambda r: False, boundary="wrap", max_iters=3)
    got = dist("8x1x1", **kw)
    np.testing.assert_allclose(got.a.numpy(), jax_halo["wrap1_a"],
                               atol=1e-6)
    a = torch.as_tensor(grid())
    for _ in range(3):
        a = stencil_taps(heat, a, 1, "wrap")
    np.testing.assert_allclose(got.a.numpy(), a.numpy(), atol=1e-6)


def test_one_d_array_splits_evenly():
    """"Evenly for 1D array": a 1-D grid on eight shards against the JAX
    single-device loop."""
    x = np.random.default_rng(3).normal(size=(64,)).astype(np.float32)

    def lap1(get, *_):
        return get(0) + 0.2 * (get(-1) + get(1) - 2.0 * get(0))

    want = JP.LoopOfStencilReduce(
        f=lap1, k=1, combine="max", cond=lambda r: r < 1e-3,
        delta=JR.abs_delta, boundary="reflect", max_iters=300,
        backend="jnp").run(jnp.asarray(x))
    got = distributed_loop_of_stencil_reduce(
        lap1, "max", lambda r: r < 1e-3, x, k=1, part=cpu_mesh("8x1"),
        delta=TR.abs_delta, boundary="reflect", max_iters=300)
    assert int(got.iters) == int(want.iters) < 300
    np.testing.assert_allclose(got.a.numpy(), np.asarray(want.a), atol=1e-5)


def test_front_end_routes_agree(plain_kernels):
    """``backend="cuda-sharded"`` delegates to the pattern's sharded loop
    and matches the torch route; unknown backends are refused."""
    kw = dict(boundary="reflect", max_iters=12)
    t = dist("8x1", **kw)
    c = dist("8x1", "cuda-sharded", TR.heat_taps(0.1), **kw)
    assert int(t.iters) == int(c.iters)
    np.testing.assert_allclose(c.a.numpy(), t.a.numpy(), atol=1e-6)
    with pytest.raises(ValueError, match="unknown distributed backend"):
        dist("8x1", "jnp")


def test_sharded_farm_matches_the_reference(jax_halo):
    items = np.random.default_rng(1).normal(size=(16, 8, 8)).astype(
        np.float32)
    worker = lambda x: stencil_taps(heat, x, 1, "reflect") * 2.0 + 1.0
    mesh = cpu_mesh("8x1").mesh
    got = TS.sharded_farm(worker, mesh)(items)
    np.testing.assert_allclose(got.numpy(), jax_halo["farm"], atol=1e-6)
    with pytest.raises(ValueError, match="divide evenly"):
        TS.sharded_farm(worker, mesh)(items[:12])
    with pytest.raises(ValueError, match="no axis"):
        TS.sharded_farm(worker, mesh, axis="model")
