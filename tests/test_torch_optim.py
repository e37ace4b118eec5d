"""The port's AdamW and LR schedules against the JAX package on the CPU.

Inputs are drawn with numpy from a seed and handed to both packages.
Tolerances (float32): schedules within 1e-7 relative; the masters and
parameters after each ``update`` within atol 1e-7 (a step moves a weight
by ~lr, 1e-3 here, so this is 1e-4 of a step); the moments within rtol
1e-5 and atol 1e-8 (the clip scale rounds apart in float32, and a
moment near zero is a difference of two terms); the stats within 1e-6
relative.  The bf16 cast-back is held exactly against the port's own
masters, and against the reference's bf16 parameters.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import AdamW as JaxAdamW
from repro.optim import constant as jax_constant
from repro.optim import cosine_with_warmup as jax_cosine
from repro.optim import global_norm as jax_global_norm
from repro_torch.optim import AdamW, constant, cosine_with_warmup, \
    global_norm

SHAPES = {"w": (6, 5), "b": (5,), "emb": (7, 3)}


def tree(rng, scale=1.0):
    return {k: (rng.normal(size=s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def close(got, want, atol=1e-7, rtol=0.0):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("peak, warmup, total, floor", [
    (3e-3, 10, 100, 0.1), (1e-3, 0, 50, 0.0), (5e-4, 30, 30, 0.2)])
def test_cosine_with_warmup_matches(peak, warmup, total, floor):
    ref = jax_cosine(peak, warmup, total, floor)
    port = cosine_with_warmup(peak, warmup, total, floor)
    for s in (0, 1, warmup // 2, warmup, warmup + 1, total // 2, total,
              total + 7):
        got = port(torch.tensor(s, dtype=torch.int32))
        want = float(ref(jnp.asarray(s, jnp.int32)))
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(float(got), want, rtol=1e-7, atol=0)


def test_constant_schedule():
    got = constant(2e-4)(torch.tensor(5, dtype=torch.int32))
    assert got.dtype == torch.float32
    assert float(got) == float(jax_constant(2e-4)(jnp.asarray(5)))


def test_global_norm_matches(rng):
    g = tree(rng)
    np.testing.assert_allclose(
        float(global_norm({k: torch.tensor(v) for k, v in g.items()})),
        float(jax_global_norm(g)), rtol=1e-6)


@pytest.mark.parametrize("clip, wd, lr", [
    (1.0, 0.0, 1e-3), (0.0, 0.01, 1e-3), (0.05, 0.1, "cosine")])
def test_updates_match_the_reference(rng, clip, wd, lr):
    """Three updates: masters, moments, parameters, step and stats."""
    p0, grads = tree(rng, 0.5), [tree(rng, 3.0) for _ in range(3)]
    sched = (lambda mod: mod(1e-3, 2, 10)) if lr == "cosine" else None
    jopt = JaxAdamW(lr=sched(jax_cosine) if sched else lr, weight_decay=wd,
                    grad_clip=clip)
    opt = AdamW(lr=sched(cosine_with_warmup) if sched else lr,
                weight_decay=wd, grad_clip=clip)
    jp, js = p0, jopt.init(p0)
    params = {k: torch.tensor(v) for k, v in p0.items()}
    state = opt.init(params)
    for g in grads:
        jp, js, jstats = jopt.update(g, js, jp)
        out, state, stats = opt.update(
            {k: torch.tensor(v) for k, v in g.items()}, state, params)
        assert out is params
        for k in SHAPES:
            close(params[k], jp[k])
            close(state.master[k], js.master[k])
            close(state.m[k], js.m[k], atol=1e-8, rtol=1e-5)
            close(state.v[k], js.v[k], atol=1e-8, rtol=1e-5)
        assert int(state.step) == int(js.step)
        for key in ("grad_norm", "lr", "clip_scale"):
            np.testing.assert_allclose(float(stats[key]), float(jstats[key]),
                                       rtol=1e-6)
    assert float(stats["clip_scale"]) < 1.0 if clip else \
        float(stats["clip_scale"]) == 1.0


def test_bf16_parameters_take_the_cast_masters(rng):
    p0, g = tree(rng, 0.5), tree(rng)
    jp, js, _ = JaxAdamW(lr=1e-2).update(
        {k: jnp.asarray(v, jnp.bfloat16) for k, v in g.items()},
        JaxAdamW(lr=1e-2).init({k: jnp.asarray(v, jnp.bfloat16)
                                for k, v in p0.items()}),
        {k: jnp.asarray(v, jnp.bfloat16) for k, v in p0.items()})
    params = {k: torch.tensor(v).bfloat16() for k, v in p0.items()}
    opt = AdamW(lr=1e-2)
    state = opt.init(params)
    assert all(state.master[k].dtype == torch.float32 for k in SHAPES)
    opt.update({k: torch.tensor(v).bfloat16() for k, v in g.items()},
               state, params)
    for k in SHAPES:
        assert params[k].dtype == torch.bfloat16
        assert torch.equal(params[k], state.master[k].bfloat16())
        close(state.master[k], js.master[k])
        # the reference's bf16 parameters: its masters cast the same way
        np.testing.assert_array_equal(
            params[k].float().numpy(),
            np.asarray(jnp.asarray(jp[k], jnp.float32)))


def test_float32_masters_never_alias_the_parameters(rng):
    """``.float()`` of a float32 tensor is the tensor itself: a master that
    shared its storage would be written by every cast-back (and a write
    to the parameters would move the master)."""
    p0, g = tree(rng, 0.5), tree(rng)
    params = {k: torch.tensor(v) for k, v in p0.items()}
    opt = AdamW(lr=1e-2)
    state = opt.init(params)
    for k in SHAPES:
        assert state.master[k].data_ptr() != params[k].data_ptr()
    opt.update({k: torch.tensor(v) for k, v in g.items()}, state, params)
    before = {k: state.master[k].clone() for k in SHAPES}
    for p in params.values():
        p.add_(1.0)
    for k in SHAPES:
        assert torch.equal(state.master[k], before[k])


def test_matches_torch_adamw_without_decay_or_clip(rng):
    """With no weight decay and no clipping, the update is Adam's, which
    ``torch.optim.AdamW`` (an independent oracle) computes too."""
    p0, grads = tree(rng), [tree(rng) for _ in range(4)]
    params = {k: torch.tensor(v) for k, v in p0.items()}
    opt = AdamW(lr=1e-3, b1=0.9, b2=0.95, eps=1e-8, grad_clip=0.0)
    state = opt.init(params)
    oracle = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in p0.items()}
    topt = torch.optim.AdamW(oracle.values(), lr=1e-3, betas=(0.9, 0.95),
                             eps=1e-8, weight_decay=0.0)
    for g in grads:
        opt.update({k: torch.tensor(v) for k, v in g.items()}, state, params)
        for k, p in oracle.items():
            p.grad = torch.tensor(g[k])
        topt.step()
    for k in SHAPES:
        close(params[k], oracle[k].detach(), atol=1e-6)
