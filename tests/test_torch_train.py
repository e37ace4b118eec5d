"""The port's training tier against the JAX package on the CPU.

Reduced qwen3-1.7b (float32) with the reference's ``init_params`` weights
(``interop.params_from_reference``), batches from ``SyntheticLM`` (equal
in both packages).  Tolerances (float32): gradients within 1e-4 of each
leaf's largest reference entry (accumulation sums four microbatches in
float32 in both); loss histories within 1e-5 (ten AdamW steps measured
3.3e-6 apart); checkpointed leaves exactly; counts (faults, steps,
``run_fused``'s iters) exactly.  ``run_fused`` against ``run`` over the
same batches and the resumed run against the uninterrupted one are the
port against itself: the same operations, held exactly.
"""
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced
from repro.data import SyntheticLM as JaxSyntheticLM
from repro.models import transformer as JT
from repro.optim import AdamW as JaxAdamW
from repro.optim import cosine_with_warmup as jax_cosine
from repro.train import TrainConfig as JaxTrainConfig
from repro.train import Trainer as JaxTrainer
from repro.train import checkpoint as JC
from repro.train.objective import grad_accum_step as jax_grad_accum_step
from repro_torch import interop
from repro_torch.configs import get_reduced as port_reduced
from repro_torch.data import SyntheticLM
from repro_torch.examples import train_lm
from repro_torch.models import transformer as TT
from repro_torch.optim import AdamW, cosine_with_warmup
from repro_torch.train import TrainConfig, Trainer, checkpoint as C
from repro_torch.train.objective import grad_accum_step

ARCH = "qwen3-1.7b"
QUIET = dict(log=lambda *a: None)


@pytest.fixture(scope="module")
def setup():
    cfg = get_reduced(ARCH)
    return (cfg, port_reduced(ARCH),
            JaxSyntheticLM(vocab_size=cfg.vocab_size, seq_len=32,
                           global_batch=8, seed=1),
            SyntheticLM(vocab_size=cfg.vocab_size, seq_len=32,
                        global_batch=8, seed=1))


def reference_and_port(seed=0):
    params = JT.init_params(get_reduced(ARCH), jax.random.PRNGKey(seed))
    return params, interop.params_from_reference(
        port_reduced(ARCH), jax.tree.map(np.asarray, params), device="cpu")


def leaves_of(cfg, named):
    tree = interop.reference_tree(cfg, {k: v.detach().float()
                                        for k, v in named.items()})
    return [t.numpy() for t in jax.tree.leaves(tree)]


def assert_trees_close(want_tree, got_named, cfg, rel=1e-4):
    want = [np.asarray(w, np.float32) for w in jax.tree.leaves(want_tree)]
    got = leaves_of(cfg, got_named)
    assert len(want) == len(got)
    for w, g in zip(want, got):
        np.testing.assert_allclose(
            g, w, rtol=0, atol=rel * float(np.abs(w).max()) + 1e-12)


# ---------------------------------------------------------------------------
# gradient accumulation
# ---------------------------------------------------------------------------

def test_grad_accum_4_matches_accum_1_and_the_reference(setup):
    cfg, pcfg, jdata, data = setup
    params, model = reference_and_port()
    batch = data.batch_at(0)
    g1, l1, _ = grad_accum_step(pcfg, model, batch, accum=1, device="cpu")
    g4, l4, m4 = grad_accum_step(pcfg, model, batch, accum=4, device="cpu")
    assert all(g.dtype == torch.float32 for g in g4.values())
    np.testing.assert_allclose(float(l4), float(l1), rtol=1e-4)
    for k in g1:
        np.testing.assert_allclose(g4[k].numpy(), g1[k].numpy(), atol=2e-4,
                                   rtol=2e-3)
    jg4, jl4, jm4 = jax.jit(lambda p, b: jax_grad_accum_step(
        cfg, p, b, accum=4))(params, jax.tree.map(jnp.asarray, batch))
    np.testing.assert_allclose(float(l4), float(jl4), rtol=1e-6)
    np.testing.assert_allclose(float(m4["loss"]), float(jm4["loss"]),
                               rtol=1e-6)
    assert_trees_close(jg4, g4, pcfg)


def test_microbatches_split_on_the_trailing_factor(setup):
    """Microbatch i holds rows i, i + accum, ... (the reference's
    reshape-and-swap), not the leading block of rows."""
    _, pcfg, _, data = setup
    _, model = reference_and_port()
    batch = data.batch_at(2)
    seen = []

    def spy(cfg, params, mb, *, device):
        seen.append(np.asarray(mb["tokens"]))
        return TT.forward(cfg, params, mb, device=device)[0].sum() * 0.0, {
            k: torch.zeros(()) for k in ("loss", "lb_loss", "router_z",
                                         "drop_frac")}
    grad_accum_step(pcfg, model, batch, accum=4, loss_fn=spy, device="cpu")
    for i, mb in enumerate(seen):
        np.testing.assert_array_equal(mb, batch["tokens"][i::4])


def test_ssd_gradients_past_a_chunk_match_the_sequential_oracle(
        monkeypatch):
    """Past one chunk the reference's chunked SSD has NaN gradients: it
    takes exp(La_i - La_j) over the whole chunk and masks after, so the
    upper triangle overflows and its ``where``'s backward gives 0 · inf.
    The port masks the exponent first; its gradients equal the reference's
    through its own sequential-scan oracle (``ssd_ref``) within 1e-4 of
    each leaf's largest entry."""
    import repro.models.ssm as JS
    arch = "mamba2-130m"
    cfg = get_reduced(arch)
    params = JT.init_params(cfg, jax.random.PRNGKey(3))
    model = interop.params_from_reference(
        port_reduced(arch), jax.tree.map(np.asarray, params), device="cpu")
    rng = np.random.default_rng(3)
    batch = {k: rng.integers(0, cfg.vocab_size, (2, 256)).astype(np.int32)
             for k in ("tokens", "labels")}
    jbatch = jax.tree.map(jnp.asarray, batch)
    step = lambda p, b: jax_grad_accum_step(cfg, p, b, accum=1)
    chunked, _, _ = step(params, jbatch)
    assert not all(bool(jnp.isfinite(g).all())
                   for g in jax.tree.leaves(chunked))
    monkeypatch.setattr(JS, "ssd_chunked", JS.ssd_ref)
    jgrads, jloss, _ = step(params, jbatch)
    grads, loss, _ = grad_accum_step(port_reduced(arch), model, batch,
                                     device="cpu")
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert_trees_close(jgrads, grads, port_reduced(arch))


# ---------------------------------------------------------------------------
# the host loop
# ---------------------------------------------------------------------------

def test_ten_steps_match_the_reference_loss_history(setup):
    cfg, pcfg, jdata, data = setup
    params, model = reference_and_port()
    jtr = JaxTrainer(cfg, JaxTrainConfig(steps=10, accum=2, log_every=1000),
                     JaxAdamW(lr=jax_cosine(3e-3, 3, 10), weight_decay=0.01))
    _, _, jinfo = jtr.run(params, lambda s: jdata.batches(s), **QUIET)
    tr = Trainer(pcfg, TrainConfig(steps=10, accum=2, log_every=1000),
                 AdamW(lr=cosine_with_warmup(3e-3, 3, 10), weight_decay=0.01),
                 device="cpu")
    _, opt_state, info = tr.run(model, lambda s: data.batches(s), **QUIET)
    assert info["steps"] == jinfo["steps"] == 10
    assert int(opt_state.step) == 10
    np.testing.assert_allclose(info["history"], jinfo["history"], atol=1e-5,
                               rtol=0)
    assert info["history"][-1] < info["history"][0]


class _NanOnce:
    """The reference test's fault scheme: the 6th step's loss reads NaN."""

    def __init__(self, trainer, nan):
        self.count, inner = 0, trainer.train_step

        def wrapped(p, o, b):
            self.count += 1
            p2, o2, m = inner(p, o, b)
            if self.count == 6:
                m = dict(m)
                m["total_loss"] = nan
            return p2, o2, m
        trainer.train_step = wrapped


def test_nan_rollback_and_batch_skip_as_the_reference(setup, tmp_path):
    cfg, pcfg, jdata, data = setup
    params, model = reference_and_port()
    jtr = JaxTrainer(cfg, JaxTrainConfig(
        steps=10, ckpt_dir=str(tmp_path / "jax"), ckpt_every=4,
        log_every=100), JaxAdamW(lr=1e-3))
    _NanOnce(jtr, jnp.asarray(jnp.nan))
    _, _, jinfo = jtr.run(params, lambda s: jdata.batches(s), **QUIET)
    tr = Trainer(pcfg, TrainConfig(steps=10, ckpt_dir=str(tmp_path / "port"),
                                   ckpt_every=4, log_every=100),
                 AdamW(lr=1e-3), device="cpu")
    _NanOnce(tr, torch.tensor(float("nan")))
    _, _, info = tr.run(model, lambda s: data.batches(s), **QUIET)
    assert info["faults"] == jinfo["faults"] == 1
    assert info["steps"] == jinfo["steps"] == 10
    assert len(info["history"]) == len(jinfo["history"]) == 11
    assert all(np.isfinite(info["history"]))
    np.testing.assert_allclose(info["history"], jinfo["history"], atol=1e-5)
    assert C.latest_step(str(tmp_path / "port")) == 10


def test_a_nan_in_the_weights_is_rolled_back_from_the_checkpoint(setup,
                                                                  tmp_path):
    """Poisoned weights (not only a poisoned reading): the run restores
    the last checkpoint in memory, skips the batch, and matches a run with
    the same skip and no poison."""
    _, pcfg, _, data = setup

    def run(poison):
        _, model = reference_and_port()
        tr = Trainer(pcfg, TrainConfig(steps=7, ckpt_dir=str(
            tmp_path / str(poison)), ckpt_every=3, log_every=100),
            AdamW(lr=1e-3), device="cpu")
        inner, count = tr.train_step, [0]

        def step(p, o, b):
            count[0] += 1
            if count[0] == 5:
                if poison:
                    with torch.no_grad():
                        p.layers[0].mlp.up.fill_(float("nan"))
                else:
                    return p, o, {"total_loss": torch.tensor(float("nan"))}
            return inner(p, o, b)
        tr.train_step = step
        return tr.run(model, lambda s: data.batches(s), **QUIET)
    p1, _, info = run(True)
    p2, _, want = run(False)
    assert info["faults"] == want["faults"] == 1
    assert info["history"] == want["history"]
    for (_, a), (_, b) in zip(p1.named_parameters(), p2.named_parameters()):
        assert torch.equal(a, b)


def test_fault_budget(setup):
    _, pcfg, _, data = setup
    _, model = reference_and_port()
    tr = Trainer(pcfg, TrainConfig(steps=5, max_faults=1, log_every=100),
                 AdamW(lr=1e-3), device="cpu")
    tr.train_step = lambda p, o, b: (p, o, {"total_loss": torch.tensor(
        float("nan"))})
    with pytest.raises(RuntimeError, match="fault budget"):
        tr.run(model, lambda s: data.batches(s), **QUIET)


def test_resume_after_a_preemption_flush(setup, tmp_path):
    """SIGTERM at step 3 flushes a checkpoint and stops; a fresh trainer on
    fresh weights resumes there, and the joined history equals an
    uninterrupted run's."""
    _, pcfg, _, data = setup
    tcfg = lambda d: TrainConfig(steps=6, ckpt_dir=str(d), ckpt_every=4,
                                 log_every=100)
    opt = AdamW(lr=cosine_with_warmup(3e-3, 2, 6))
    _, model = reference_and_port()
    _, _, whole = Trainer(pcfg, tcfg(tmp_path / "whole"), opt,
                          device="cpu").run(
        model, lambda s: data.batches(s), **QUIET)

    _, model = reference_and_port()
    tr = Trainer(pcfg, tcfg(tmp_path / "cut"), opt, device="cpu")
    prev = tr.install_preemption_handler()
    inner, count = tr.train_step, [0]

    def step(p, o, b):
        out = inner(p, o, b)
        count[0] += 1
        if count[0] == 3:
            os.kill(os.getpid(), signal.SIGTERM)
        return out
    tr.train_step = step
    try:
        _, _, first = tr.run(model, lambda s: data.batches(s), **QUIET)
    finally:
        for s, h in prev.items():
            signal.signal(s, h)
    assert first["steps"] == 3 and C.latest_step(str(tmp_path / "cut")) == 3
    _, fresh = reference_and_port(seed=7)
    _, state, rest = Trainer(pcfg, tcfg(tmp_path / "cut"), opt,
                             device="cpu").run(
        fresh, lambda s: data.batches(s), **QUIET)
    assert rest["steps"] == 6 and int(state.step) == 6
    assert first["history"] + rest["history"] == whole["history"]


def test_run_fused_equals_run_over_the_same_batches(setup):
    cfg, pcfg, jdata, data = setup
    K = 4
    params, model = reference_and_port(seed=2)
    stacked = {k: np.stack([data.batch_at(i)[k] for i in range(K)])
               for k in ("tokens", "labels")}
    opt = AdamW(lr=1e-3)
    tr = Trainer(pcfg, TrainConfig(steps=K), opt, device="cpu")
    fused, fstate, last_loss, iters = tr.run_fused(model, opt.init(model),
                                                   stacked)
    assert int(iters) == K and int(fstate.step) == K
    _, other = reference_and_port(seed=2)
    host, _, info = Trainer(pcfg, TrainConfig(steps=K, log_every=100), opt,
                            device="cpu").run(
        other, [data.batch_at(i) for i in range(K)], **QUIET)
    assert float(last_loss) == info["history"][-1]
    for (_, a), (_, b) in zip(fused.named_parameters(),
                              host.named_parameters()):
        assert torch.equal(a, b)
    # and the reference's fused segment: the same iters and last loss
    jopt = JaxAdamW(lr=1e-3)
    jtr = JaxTrainer(cfg, JaxTrainConfig(steps=K), jopt)
    _, _, jlast, jiters = jtr.run_fused(
        params, jopt.init(params),
        jax.tree.map(jnp.asarray, stacked))
    assert int(jiters) == int(iters)
    np.testing.assert_allclose(float(last_loss), float(jlast), atol=1e-5)


def test_run_fused_stops_below_the_target_loss(setup):
    _, pcfg, _, data = setup
    _, model = reference_and_port()
    stacked = {k: np.stack([data.batch_at(i)[k] for i in range(4)])
               for k in ("tokens", "labels")}
    opt = AdamW(lr=1e-3)
    tr = Trainer(pcfg, TrainConfig(steps=4), opt, device="cpu")
    _, _, last, iters = tr.run_fused(model, opt.init(model), stacked,
                                     target_loss=100.0)
    assert int(iters) == 1 and float(last) < 100.0


# ---------------------------------------------------------------------------
# checkpoints in the reference's format
# ---------------------------------------------------------------------------

def test_port_checkpoint_restores_in_the_reference(setup, tmp_path):
    cfg, pcfg, _, data = setup
    params, model = reference_and_port()
    opt = AdamW(lr=1e-3)
    tr = Trainer(pcfg, TrainConfig(steps=3, ckpt_dir=str(tmp_path),
                                   ckpt_every=100, log_every=100), opt,
                 device="cpu")
    model, state, _ = tr.run(model, lambda s: data.batches(s), **QUIET)
    jopt = JaxAdamW(lr=1e-3)
    (jp, js), step, _ = JC.restore(str(tmp_path), (params,
                                                   jopt.init(params)))
    assert step == 3 and int(js.step) == 3
    named = dict(model.named_parameters())
    for want, got in zip(leaves_of(pcfg, named), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(np.asarray(got), want)
    for d, tree in ((state.master, js.master), (state.m, js.m),
                    (state.v, js.v)):
        for want, got in zip(leaves_of(pcfg, d), jax.tree.leaves(tree)):
            np.testing.assert_array_equal(np.asarray(got), want)


def test_reference_checkpoint_restores_in_the_port(setup, tmp_path):
    cfg, pcfg, jdata, data = setup
    params, _ = reference_and_port()
    jtr = JaxTrainer(cfg, JaxTrainConfig(steps=3, ckpt_dir=str(tmp_path),
                                         ckpt_every=100, log_every=100),
                     JaxAdamW(lr=1e-3))
    jp, js, _ = jtr.run(params, lambda s: jdata.batches(s), **QUIET)
    _, model = reference_and_port(seed=5)
    opt = AdamW(lr=1e-3)
    state = opt.init(model)
    (got, gstate), step, _ = C.restore(str(tmp_path), (model, state))
    assert got is model and gstate is state
    assert step == 3 and int(state.step) == 3
    for want, have in zip(jax.tree.leaves(jp),
                          leaves_of(pcfg, dict(model.named_parameters()))):
        np.testing.assert_array_equal(have, np.asarray(want))
    for tree, d in ((js.master, state.master), (js.m, state.m),
                    (js.v, state.v)):
        for want, have in zip(jax.tree.leaves(tree), leaves_of(pcfg, d)):
            np.testing.assert_array_equal(have, np.asarray(want))
    # and the port trains on from there as the reference does
    _, _, info = Trainer(pcfg, TrainConfig(
        steps=5, ckpt_dir=str(tmp_path), log_every=100), opt,
        device="cpu").run(model, lambda s: data.batches(s), **QUIET)
    _, _, jinfo = JaxTrainer(cfg, JaxTrainConfig(
        steps=5, ckpt_dir=str(tmp_path / "j"), log_every=100),
        JaxAdamW(lr=1e-3)).run(jp, lambda s: jdata.batches(s), opt_state=js,
                               start_step=3, **QUIET)
    np.testing.assert_allclose(info["history"], jinfo["history"], atol=1e-5)


def test_bf16_leaves_cross_both_ways(tmp_path):
    tree = {"a": torch.full((4, 3), 1.5, dtype=torch.bfloat16),
            "b": {"c": torch.arange(5, dtype=torch.int32)},
            "s": torch.tensor(3, dtype=torch.int32)}
    C.save(str(tmp_path / "p"), 3, tree)
    jtree = {"a": jnp.ones((4, 3), jnp.bfloat16) * 1.5,
             "b": {"c": jnp.arange(5, dtype=jnp.int32)},
             "s": jnp.asarray(3, jnp.int32)}
    got, step, _ = JC.restore(str(tmp_path / "p"), jtree)
    assert step == 3 and got["a"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(got["a"], np.float32),
                                  tree["a"].float().numpy())
    JC.save(str(tmp_path / "j"), 4, jtree)
    back, step, _ = C.restore(str(tmp_path / "j"), tree)
    assert step == 4 and back["a"].dtype == torch.bfloat16
    assert torch.equal(back["a"], tree["a"])
    assert torch.equal(back["b"]["c"], tree["b"]["c"])


def test_atomicity_and_retention(tmp_path):
    tree = {"x": torch.ones(2)}
    for s in (1, 2, 3, 4, 5):
        C.save(str(tmp_path), s, tree, keep=2)
    assert sorted(os.listdir(tmp_path)) == ["step_0000000004",
                                            "step_0000000005"]
    C.save(str(tmp_path), 5, {"x": torch.zeros(2)}, keep=2)   # re-save
    got, step, _ = C.restore(str(tmp_path), tree)
    assert step == 5 and torch.equal(got["x"], torch.zeros(2))
    os.makedirs(tmp_path / ".tmp-6")                 # a crash mid-write
    assert C.latest_step(str(tmp_path)) == 5
    with pytest.raises(ValueError, match="structure"):
        C.restore(str(tmp_path), {"x": tree["x"], "y": tree["x"]})


def test_train_lm_example_on_the_cpu(tmp_path, capsys):
    train_lm.main(["--preset", "tiny", "--steps", "4", "--batch", "4",
                   "--seq", "16", "--ckpt-dir", str(tmp_path),
                   "--ckpt-every", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[train_lm] demo-tiny" in out and "over 4 steps" in out
    assert C.latest_step(str(tmp_path)) == 4
