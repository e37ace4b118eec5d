"""The port's MoE family against the JAX package on the CPU.

``moe`` (capacity drops, dropless, shared expert, B = 1, a router of
ties), ``expert_parallel_moe`` on the port's (2, 4) mesh of the CPU, the
expert-parallel hook, and reduced deepseek-moe-16b / qwen3-moe-30b-a3b /
jamba-v0.1-52b forwards, losses and greedy serving.  Weights come from the
reference's ``init_moe`` / ``init_params``; inputs are drawn with numpy
from a seed.  The JAX ``expert_parallel_moe`` needs eight XLA devices, so
ONE module-scoped fixture computes its cases in a subprocess with
``--xla_force_host_platform_device_count=8`` on meshes from
``repro.sharding.specs.make_mesh``.  Tolerances: float32 outputs and
logits within atol 1e-5 (summation order), ``lb_loss`` / ``router_z`` /
the loss within 1e-6 relative, ``drop_frac`` and integer results exact.
"""
import contextlib
import dataclasses
import functools
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as JA
from repro.configs import get_reduced
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.serve import GenerateConfig as JGenerateConfig
from repro.serve import generate as jax_generate
from repro.train.objective import lm_loss as jax_lm_loss
import repro_torch.models.attention as TA
from repro_torch import interop
from repro_torch.configs import get_reduced as port_reduced
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models.moe_parallel import (data_axes,
                                             expert_parallel_moe)
from repro_torch.serve import GenerateConfig, generate
from repro_torch.sharding import make_mesh
from repro_torch.train.objective import lm_loss

ROOT = Path(__file__).resolve().parents[1]
D, E, F, K = 32, 8, 64, 2          # the reference test's MoE widths


def t(a):
    return torch.as_tensor(np.array(a))


def port_moe(p: dict) -> TL.MoE:
    """The port's MoE module holding the reference's ``init_moe`` leaves."""
    shared = p.get("shared")
    m = TL.MoE(D, E, F, int(shared is not None),
               shared["up"].shape[1] if shared else 0, True, device="cpu",
               dtype=torch.float32)
    for name, prm in m.named_parameters():
        leaf = p
        for key in name.split("."):
            leaf = leaf[key]
        prm.data.copy_(t(leaf))
    return m


def ref_moe(shared: bool, seed=0):
    return JL.init_moe(jax.random.PRNGKey(seed), D, E, F, int(shared), 48,
                       True, jnp.float32)


def moe_x(B, S=16, seed=0):
    return (np.random.default_rng(seed).normal(size=(B, S, D)) * 0.3) \
        .astype(np.float32)


# (B, capacity factor, dropless, shared expert)
MOE_CASES = {
    "drops": (4, 0.5, False, True),
    "capacity_1.25": (4, 1.25, False, False),
    "dropless": (4, 1.25, True, True),
    "dropless_no_shared": (2, 1.25, True, False),
    "batch_one": (1, 1.25, False, True),
}


def moe_gap(case):
    """(max |y - y_ref|, port aux, reference aux) for a MOE_CASES case."""
    B, cf, dropless, shared = MOE_CASES[case]
    p = ref_moe(shared)
    x = moe_x(B)
    want, waux = JL.moe(p, jnp.asarray(x), top_k=K, capacity_factor=cf,
                        dropless=dropless)
    got, aux = TL.moe(port_moe(p), t(x), top_k=K, capacity_factor=cf,
                      dropless=dropless)
    assert got.shape == x.shape and got.dtype == torch.float32
    return (float(np.abs(got.numpy() - np.asarray(want)).max()),
            {k: float(v) for k, v in aux.items()},
            {k: float(v) for k, v in waux.items()})


def assert_aux(aux, waux, n_assign=None):
    """The aux terms; ``drop_frac`` exactly for one MoE call.  A stack's
    sum over layers (``n_assign`` assignments a layer) is held as a count
    of drops, exactly, and as a float within 1e-6 relative (atol 1e-7):
    the reference's scanned layers compute ``1 - sum/n`` with a fused
    multiply-add (2^-26 off at n = 160) where its eager call is exact."""
    if n_assign is None:
        assert aux["drop_frac"] == waux["drop_frac"]
    else:
        assert round(aux["drop_frac"] * n_assign) \
            == round(waux["drop_frac"] * n_assign)
        np.testing.assert_allclose(aux["drop_frac"], waux["drop_frac"],
                                   rtol=1e-6, atol=1e-7)
    for k in ("lb_loss", "router_z"):
        np.testing.assert_allclose(aux[k], waux[k], rtol=1e-6)


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_matches_reference(case):
    err, aux, waux = moe_gap(case)
    assert err <= 1e-5, err
    assert_aux(aux, waux)
    if case == "drops":
        assert aux["drop_frac"] > 0.2
    if MOE_CASES[case][2]:
        assert aux["drop_frac"] == 0.0


def test_router_of_ties_picks_the_lowest_expert_ids():
    """A router of zeros gives every expert the same probability; both
    packages must take experts 0..k-1 (lax.top_k's lower-index-first)."""
    p = dict(ref_moe(True), router=jnp.zeros((D, E), jnp.float32))
    m = port_moe(p)
    x = moe_x(2)
    _, _, top_p, top_i = TL.route(m.router, t(x).reshape(-1, D), K)
    assert (top_i == torch.arange(K)).all()
    assert torch.equal(top_p, torch.full_like(top_p, 1.0 / K))
    for cf in (0.5, 1.25):
        want, waux = JL.moe(p, jnp.asarray(x), top_k=K, capacity_factor=cf)
        got, aux = TL.moe(m, t(x), top_k=K, capacity_factor=cf)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
        assert_aux({k: float(v) for k, v in aux.items()},
                   {k: float(v) for k, v in waux.items()})


def later_tokens_win(top_i, top_p):
    """A planted fault: the same assignments with the LATER token first
    within each expert (an unstable or reversed sort)."""
    T, k = top_i.shape
    n = T * k
    eid_s, rev = torch.sort(top_i.reshape(-1).flip(0), stable=True)
    order = n - 1 - rev
    first = torch.searchsorted(eid_s, eid_s, side="left")
    return TL.Assignments(order, eid_s,
                          torch.div(order, k, rounding_mode="floor"),
                          top_p.reshape(-1)[order], torch.arange(n) - first)


def in_range_clamp(keep, le, pos, e_loc):
    """A planted fault: dropped assignments clamped into slot (e, 0)."""
    return le.clamp(0, e_loc - 1), torch.where(keep, pos, 0)


@pytest.mark.parametrize("fault", [later_tokens_win, in_range_clamp])
def test_drop_test_catches_a_planted_fault(fault, monkeypatch):
    """With drops (capacity factor 0.5) the drop test must fail when later
    tokens win a full expert, or when drops overwrite slot (e, 0); the drop
    count itself is the same, so ``y`` is what catches them."""
    name = {later_tokens_win: "sort_assignments",
            in_range_clamp: "dispatch_index"}[fault]
    monkeypatch.setattr(TL, name, fault)
    err, aux, waux = moe_gap("drops")
    assert err > 1e-2, err
    assert aux["drop_frac"] == waux["drop_frac"]
    # dropless, nothing is dropped: the faults change nothing
    err, _, _ = moe_gap("dropless")
    assert err <= 1e-5


def test_capacity_follows_the_reference():
    assert TL.capacity(64, 2, 8, 1.25, False) == int(np.ceil(64 * 2 / 8
                                                            * 1.25))
    assert TL.capacity(1, 2, 8, 0.5, False) == 1
    assert TL.capacity(37, 6, 64, 1.25, True) == 37


def test_combine_sums_each_token_in_ascending_expert_order():
    """The combine adds a token's k rows in the model dtype in ascending
    expert order, starting from zeros, as the reference's scatter-add
    applies them: checked on bfloat16 against that sum written out."""
    p = ref_moe(False)
    m = port_moe(p).to(torch.bfloat16)
    m.router.data = m.router.data.float()
    x = t(moe_x(2)).to(torch.bfloat16)
    got, _ = TL.moe(m, x, top_k=3, dropless=True)
    xt = x.reshape(-1, D)
    _, _, top_p, top_i = TL.route(m.router, xt, 3)
    want = torch.zeros_like(xt)
    for tok in range(xt.shape[0]):
        for c in top_i[tok].argsort():
            e = int(top_i[tok, c])
            h = torch.nn.functional.silu(xt[tok] @ m.w_gate[e]) \
                * (xt[tok] @ m.w_up[e])
            want[tok] = want[tok] + (h @ m.w_down[e]) \
                * top_p[tok, c].to(torch.bfloat16)
    assert torch.equal(got.reshape(-1, D), want)


# ---------------------------------------------------------------------------
# expert parallel: the JAX side in one subprocess with eight XLA devices
# ---------------------------------------------------------------------------

# name: (B, capacity factor, shared expert)
EP_CASES = {"b4_cf1.25": (4, 1.25, True), "b4_cf8": (4, 8.0, True),
            "b1_cf8": (1, 8.0, True), "b1_cf1.25": (1, 1.25, False),
            "b3_cf1.25": (3, 1.25, True)}
HOOK_ARCH = "deepseek-moe-16b"
HOOK_TOKENS = dict(B=2, S=24, seed=5)

JAX_EP = textwrap.dedent("""
    import dataclasses, functools, json, sys
    import numpy as np, jax, jax.numpy as jnp
    from repro.configs import get_reduced
    from repro.models import transformer as JT
    from repro.models.layers import init_moe
    from repro.models.moe_parallel import expert_parallel_moe
    from repro.sharding.specs import make_mesh

    out_path, spec = sys.argv[1], json.loads(sys.argv[2])
    mesh = make_mesh((2, 4), ("data", "model"))
    res = {}
    for name, (B, cf, shared) in spec["cases"].items():
        p = init_moe(jax.random.PRNGKey(0), 32, 8, 64, int(shared), 48,
                     True, jnp.float32)
        x = jnp.asarray((np.random.default_rng(0).normal(size=(B, 16, 32))
                         * 0.3).astype(np.float32))
        with mesh:
            y, aux = jax.jit(lambda p, x, cf=cf: expert_parallel_moe(
                p, x, top_k=2, act="silu", capacity_factor=cf, mesh=mesh,
                dp_axes=("data",)))(p, x)
        res[name + "_y"] = np.asarray(y)
        for k, v in aux.items():
            res[f"{name}_{k}"] = np.asarray(v)
    # the hook: a reduced MoE forward with drops, experts over "model"
    h = spec["hook"]
    cfg = get_reduced(h["arch"])
    cfg = dataclasses.replace(cfg, moe_dropless=False)
    params = JT.init_params(cfg, jax.random.PRNGKey(0))
    tok = np.random.default_rng(h["seed"]).integers(
        0, cfg.vocab_size, (h["B"], h["S"]))
    JT.set_moe_parallel(functools.partial(
        expert_parallel_moe, mesh=mesh, dp_axes=("data",)))
    with mesh:
        logits, aux = jax.jit(lambda p, t: JT.forward(
            cfg, p, {"tokens": t}))(params, jnp.asarray(tok))
    res["hook_logits"] = np.asarray(logits)
    for k, v in aux.items():
        res["hook_" + k] = np.asarray(v)
    np.savez(out_path, **res)
""")


@pytest.fixture(scope="module")
def jax_ep(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_ep") / "cases.npz"
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    spec = json.dumps({"cases": EP_CASES,
                       "hook": dict(arch=HOOK_ARCH, **HOOK_TOKENS)})
    run = subprocess.run([sys.executable, "-c", JAX_EP, str(out), spec],
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    return dict(np.load(out))


@pytest.fixture
def cpu_mesh():
    return make_mesh((2, 4), ("data", "model"), devices=["cpu"] * 8)


@pytest.mark.parametrize("case", list(EP_CASES))
def test_expert_parallel_matches_jax(case, jax_ep, cpu_mesh):
    B, cf, shared = EP_CASES[case]
    m = port_moe(ref_moe(shared))
    y, aux = expert_parallel_moe(m, t(moe_x(B)), top_k=K, act="silu",
                                 capacity_factor=cf, mesh=cpu_mesh,
                                 dp_axes=("data",))
    np.testing.assert_allclose(y.numpy(), jax_ep[case + "_y"], atol=1e-5)
    for k in ("lb_loss", "router_z", "drop_frac"):
        np.testing.assert_allclose(float(aux[k]), float(jax_ep[f"{case}_{k}"]),
                                   rtol=1e-6, atol=1e-7)
    if cf == 8.0:          # no drops: the dense dispatch's output
        dense, daux = TL.moe(m, t(moe_x(B)), top_k=K, dropless=True)
        torch.testing.assert_close(y, dense, rtol=0, atol=1e-5)
        assert float(aux["drop_frac"]) == 0.0


def test_data_axes_take_only_axes_that_divide_the_batch(cpu_mesh):
    assert data_axes(cpu_mesh, ("data",), 4) == ("data",)
    assert data_axes(cpu_mesh, ("data",), 3) == ()
    assert data_axes(cpu_mesh, ("data",), 1) == ()
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"),
                     devices=["cpu"] * 8)
    assert data_axes(mesh, ("pod", "data"), 2) == ("pod",)
    assert data_axes(mesh, ("pod", "data"), 4) == ("pod", "data")


@pytest.fixture
def moe_hook(cpu_mesh):
    TT.set_moe_parallel(functools.partial(expert_parallel_moe,
                                          mesh=cpu_mesh, dp_axes=("data",)))
    try:
        yield
    finally:
        TT.set_moe_parallel(None)


def test_moe_parallel_hook_matches_jax(jax_ep, moe_hook):
    cfg = dataclasses.replace(get_reduced(HOOK_ARCH), moe_dropless=False)
    pcfg = dataclasses.replace(port_reduced(HOOK_ARCH), moe_dropless=False)
    params = jax.tree.map(np.asarray,
                          JT.init_params(cfg, jax.random.PRNGKey(0)))
    model = interop.params_from_reference(pcfg, params, device="cpu")
    h = HOOK_TOKENS
    tok = np.random.default_rng(h["seed"]).integers(0, cfg.vocab_size,
                                                    (h["B"], h["S"]))
    logits, aux = TT.forward(pcfg, model, {"tokens": tok}, device="cpu")
    np.testing.assert_allclose(logits.numpy(), jax_ep["hook_logits"],
                               atol=1e-5)
    assert_aux({k: float(v) for k, v in aux.items()},
               {k: float(jax_ep["hook_" + k]) for k in aux},
               n_assign=h["S"] * cfg.top_k)
    assert float(aux["drop_frac"]) > 0.0
    # a dropless config never takes the hook, as in the reference
    want, _ = TT.forward(port_reduced(HOOK_ARCH), model, {"tokens": tok},
                         device="cpu")
    TT.set_moe_parallel(lambda *a, **k: pytest.fail("hook taken"))
    got, _ = TT.forward(port_reduced(HOOK_ARCH), model, {"tokens": tok},
                        device="cpu")
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# reduced MoE models: forward, loss, serving
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def flash(enabled):
    j, p = JA.USE_FLASH_SWA, TA.USE_FLASH_SWA
    JA.set_flash_swa(enabled)
    TA.set_flash_swa(enabled)
    try:
        yield
    finally:
        JA.set_flash_swa(j)
        TA.set_flash_swa(p)


@functools.lru_cache(maxsize=None)
def reference_params(arch):
    return JT.init_params(get_reduced(arch), jax.random.PRNGKey(0))


def models(arch, dropless=True, cf=1.25):
    kw = dict(moe_dropless=dropless, moe_capacity_factor=cf)
    cfg = dataclasses.replace(get_reduced(arch), **kw)
    pcfg = dataclasses.replace(port_reduced(arch), **kw)
    params = reference_params(arch)
    return cfg, pcfg, params, interop.params_from_reference(
        pcfg, jax.tree.map(np.asarray, params), device="cpu")


@pytest.mark.parametrize("arch,dropless,cf,S,use_flash", [
    ("deepseek-moe-16b", True, 1.25, 40, False),
    ("deepseek-moe-16b", False, 1.25, 40, False),
    ("deepseek-moe-16b", True, 1.25, 128, True),
    ("qwen3-moe-30b-a3b", True, 1.25, 40, False),
    ("qwen3-moe-30b-a3b", False, 1.25, 40, False),
    ("jamba-v0.1-52b", False, 0.75, 40, False)])
def test_forward_logits_aux_and_loss(arch, dropless, cf, S, use_flash):
    cfg, pcfg, params, model = models(arch, dropless, cf)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (2, S))
    labels = rng.integers(0, cfg.vocab_size, (2, S))
    batch = {"tokens": tokens, "labels": labels}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    with flash(use_flash):
        want, waux = JT.forward(cfg, params, jbatch)
        jloss, jmet = jax_lm_loss(cfg, params, jbatch)
        got, aux = TT.forward(pcfg, model, batch, device="cpu")
        loss, met = lm_loss(pcfg, model, batch, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert_aux({k: float(v) for k, v in aux.items()},
               {k: float(v) for k, v in waux.items()},
               n_assign=2 * S * cfg.top_k)
    assert (float(aux["drop_frac"]) > 0.0) == (not dropless)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                               rtol=1e-6)
    # the loss carries the aux terms, the metric is the CE alone
    assert float(loss) == pytest.approx(
        float(met["loss"]) + 0.01 * float(aux["lb_loss"])
        + 1e-4 * float(aux["router_z"]), rel=1e-6)
    assert float(loss) > float(met["loss"])


def test_flash_route_takes_the_kernel_on_every_moe_layer(monkeypatch):
    """deepseek has no QK-norm: every layer takes the flash route."""
    from repro_torch.kernels import swa_attention as TS
    calls = []
    real = TS.swa_attention
    monkeypatch.setattr(TS, "swa_attention",
                        lambda *a, **k: calls.append(k) or real(*a, **k))
    _, pcfg, _, model = models("deepseek-moe-16b")
    with flash(True):
        TT.forward(pcfg, model, {"tokens": np.ones((1, 128), np.int64)},
                   device="cpu")
        TT.forward(port_reduced("qwen3-moe-30b-a3b"),
                   models("qwen3-moe-30b-a3b")[3],
                   {"tokens": np.ones((1, 128), np.int64)}, device="cpu")
    assert len(calls) == pcfg.num_layers
    assert all(c["window"] == 0 for c in calls)


def test_params_from_reference_carries_moe_leaves():
    cfg, pcfg, params, model = models("deepseek-moe-16b")
    params = jax.tree.map(np.asarray, params)
    layers = interop.reference_layers(cfg, params)
    assert "mlp" in layers[0] and "moe" in layers[1]
    for i in (1, 2):
        m = model.layers[i].moe
        assert m.router.dtype == torch.float32
        np.testing.assert_array_equal(m.w_down.numpy(),
                                      layers[i]["moe"]["w_down"])
        np.testing.assert_array_equal(m.shared.gate.numpy(),
                                      layers[i]["moe"]["shared"]["gate"])
    np.testing.assert_array_equal(model.layers[2].moe.w_up.numpy(),
                                  params["unit"][0]["moe"]["w_up"][1])


def test_init_params_moe_shapes_dtypes_and_seed():
    import repro_torch.configs as C
    cfg = dataclasses.replace(C.get_reduced("deepseek-moe-16b"),
                              dtype="bfloat16")
    a = TT.init_params(cfg, seed=3, device="cpu")
    b = TT.init_params(cfg, seed=3, device="cpu")
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
    m = a.layers[1].moe
    assert m.router.dtype == torch.float32
    assert m.w_up.dtype == torch.bfloat16
    assert tuple(m.w_up.shape) == (cfg.n_experts, cfg.d_model,
                                   cfg.expert_d_ff)
    assert tuple(m.w_down.shape) == (cfg.n_experts, cfg.expert_d_ff,
                                     cfg.d_model)
    assert tuple(m.shared.up.shape) == (cfg.d_model, cfg.shared_d_ff)
    np.testing.assert_allclose(float(m.router.std()),
                               cfg.d_model ** -0.5, rtol=0.2)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "qwen3-moe-30b-a3b"])
def test_greedy_generate_and_prefill_caches(arch):
    """Serving dispatches dropless under caches (the reference's rule),
    even on a config whose forward drops."""
    cfg, pcfg, params, model = models(arch, dropless=False)
    prompt = np.random.default_rng(2).integers(2, cfg.vocab_size, (3, 9))
    want, wlen, witers = jax_generate(
        cfg, params, jnp.asarray(prompt),
        JGenerateConfig(max_new_tokens=6, eos_id=1), cache_dtype=jnp.float32)
    got, glen, giters = generate(pcfg, model, prompt,
                                 GenerateConfig(max_new_tokens=6, eos_id=1),
                                 cache_dtype=torch.float32, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(glen.numpy(), np.asarray(wlen))
    assert int(giters) == int(witers)
    jc = JT.init_cache(cfg, 3, 16, jnp.float32)
    _, jc = JT.step_with_cache(cfg, params, jc, jnp.asarray(prompt), 0)
    pc = TT.init_cache(pcfg, 3, 16, torch.float32, device="cpu")
    _, pc = TT.step_with_cache(pcfg, model, pc, torch.as_tensor(prompt), 0)
    want_c = interop.caches_from_reference(
        cfg, jax.tree.map(np.asarray, jc), device="cpu")
    for w, g in zip(want_c, pc):
        assert sorted(w) == sorted(g)
        for key in w:
            torch.testing.assert_close(g[key], w[key], rtol=0, atol=1e-5)


def test_greedy_equals_the_dropless_teacher_forced_argmax():
    """Serving is dropless; so is the forward it must agree with."""
    _, pcfg, _, model = models("deepseek-moe-16b", dropless=True)
    prompt = np.random.default_rng(3).integers(2, pcfg.vocab_size, (2, 8))
    out, lengths, _ = generate(pcfg, model, prompt,
                               GenerateConfig(max_new_tokens=8, eos_id=1),
                               cache_dtype=torch.float32, device="cpu")
    full = torch.cat([torch.as_tensor(prompt), out.long()], dim=1)
    logits, _ = TT.forward(pcfg, model, {"tokens": full}, device="cpu")
    exp = logits[:, 7:-1].argmax(dim=-1)
    for b in range(2):
        L = int(lengths[b])
        assert torch.equal(out[b, :L].long(), exp[b, :L])
