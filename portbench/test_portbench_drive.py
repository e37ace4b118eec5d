"""Each cell driven end to end at a size a CPU test run holds: the port
against the plain reference decides ``correct``, which comes out true on
the sound program and false on the control and on each planted fault of
the timed path.  The card's twin of the sound drive carries the ``cuda``
marker."""
import dataclasses
import time

import pytest
import torch

from portbench import report, spec
from portbench.reference import moe_lm
from portbench.reference import restore as ref
from portbench.tiny import tiny_cell

SEED = 2**31 + 77
STREAM, SERVE = "restore-1080p-light", "deepseek-moe-16b-chat"


@pytest.fixture
def one_thread():
    """One intra-op thread: the drives time a window on a shared CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


def drive(name, device="cpu", seconds=None, control=False, backend="torch"):
    c = tiny_cell(name, backend)
    stream = c["config"]["driver"] == "stream"
    out = spec.driver(c).run(c, SEED, seconds or 2.0,
                             False, device=device, t0=time.perf_counter(),
                             control=control)
    return out, all(report.passes(k) for k in out["checks"])


@pytest.mark.parametrize("name", [STREAM, SERVE])
def test_sound_run_is_correct_and_control_is_not(one_thread, name):
    out, correct = drive(name, control=True)
    assert out["attempted"] > 0 and out["failed"] == 0
    assert correct, out["checks"]
    assert not all(report.passes(k) for k in out["control"]), out["control"]
    assert set(out["e2e"]) >= {"setup_s"}
    assert all(v is not None for v in out["e2e"].values())


# -- planted faults of the timed path ---------------------------------------

def stream_unchanged(monkeypatch):
    """The restoration step returns its state unchanged."""
    from repro_torch.kernels import ref as R
    orig = R.restore_taps

    def taps(beta):
        e = orig(beta)
        return R.Elemental(e.functor, lambda get, *env: get(0, 0), k=e.k,
                           n_env=e.n_env, params=e.params)
    monkeypatch.setattr(R, "restore_taps", taps)


def stream_half(monkeypatch):
    """Half of each frame left out of the sweep: its lower rows keep their
    state."""
    from repro_torch.kernels import ref as R
    orig = R.restore_taps

    def taps(beta):
        e = orig(beta)

        def body(get, *env):
            out = e.body(get, *env).clone()
            m = out.shape[-2]
            out[..., m // 2:, :] = get(0, 0)[..., m // 2:, :]
            return out
        return R.Elemental(e.functor, body, k=e.k, n_env=e.n_env,
                           params=e.params)
    monkeypatch.setattr(R, "restore_taps", taps)


def stream_altered(monkeypatch):
    """An answer altered where it is produced: the sweep's output off by
    0.05 at one pixel."""
    from repro_torch.kernels import ref as R
    orig = R.restore_taps

    def taps(beta):
        e = orig(beta)

        def body(get, *env):
            out = e.body(get, *env).clone()
            out[..., 0, 0] += 0.05
            return out
        return R.Elemental(e.functor, body, k=e.k, n_env=e.n_env,
                           params=e.params)
    monkeypatch.setattr(R, "restore_taps", taps)


def serve_unchanged(monkeypatch):
    """The KV cache is returned unchanged: no key or value is written."""
    from repro_torch.models import attention as A
    monkeypatch.setattr(A, "_scatter_cache", lambda cache, new, pos: cache)


def serve_half(monkeypatch):
    """Half of each token's experts left out, the weighted mean taken over
    the rest."""
    from repro_torch.models import layers as L
    orig = L.route

    def route(router, xt, top_k):
        logits, probs, top_p, top_i = orig(router, xt, top_k)
        keep = torch.arange(top_k, device=xt.device) < (top_k + 1) // 2
        top_p = top_p * keep
        return logits, probs, top_p / top_p.sum(-1, keepdim=True), top_i
    monkeypatch.setattr(L, "route", route)


def serve_altered(monkeypatch):
    """A token altered where it is produced: the sampler's choice moved
    to the next token id."""
    from repro_torch.serve import engine as E
    orig = E.sample_tokens

    def sample(logits, *args):
        return (orig(logits, *args) + 1) % logits.shape[-1]
    monkeypatch.setattr(E, "sample_tokens", sample)


@pytest.mark.parametrize("name,fault", [
    (STREAM, stream_unchanged), (STREAM, stream_half),
    (STREAM, stream_altered), (SERVE, serve_unchanged),
    (SERVE, serve_half), (SERVE, serve_altered)],
    ids=lambda x: getattr(x, "__name__", x))
def test_planted_fault_is_not_correct(one_thread, monkeypatch, name, fault):
    fault(monkeypatch)
    out, correct = drive(name)
    assert not correct, out["checks"]


# -- the references against the port's plain path ---------------------------

def test_restore_reference_matches_the_port(one_thread):
    from repro_torch.core.pattern import LoopOfStencilReduce
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as R
    c = tiny_cell(STREAM)
    gen = spec.generator(c)
    frames = gen.make((24, 40), c["traffic"], SEED, "cpu")
    cfg = c["config"]
    r = cfg["restore"]
    for f in frames:
        mask, rep = ops.adaptive_median_detect(f, kmax=3, backend="torch",
                                               device="cpu")
        m2, rep2 = ref.detect(f, 3)
        assert torch.equal(mask, m2) and torch.equal(rep, rep2)
        loop = LoopOfStencilReduce(
            f=R.restore_taps(r["beta"]), k=1, combine="max",
            delta=R.abs_delta, cond=lambda x: x < r["tol"],
            boundary="reflect", max_iters=r["max_iters"], backend="torch",
            device="cpu")
        res = loop.run(rep, env=(rep, mask))
        a, it = ref.restore_frame(f, cfg)
        assert torch.equal(res.a, a) and int(res.iters) == it


def test_moe_reference_matches_the_port_in_float32(one_thread):
    from repro_torch.models import transformer as T
    from portbench import weights
    from portbench.drivers import serve
    c = tiny_cell(SERVE)
    cfg = dict(c["config"], torch_dtype="float32")
    # served dropless, as the engine serves (a cache makes it dropless)
    acfg = dataclasses.replace(serve.arch_config(cfg), moe_dropless=True)
    model = T.init_params(acfg, device="meta")
    w = weights.materialize(model, SEED, torch.device("cpu"))
    g = torch.Generator().manual_seed(SEED)
    toks = torch.randint(2, cfg["vocab_size"], (2, 24), generator=g)
    logits, _ = T.forward(acfg, model, {"tokens": toks}, device="cpu")
    rows = [torch.arange(24)] * 2
    got = moe_lm.logits_at(cfg, w, list(toks), rows)
    for i in range(2):
        torch.testing.assert_close(got[i], logits[i], rtol=1e-4, atol=1e-4)
    low = moe_lm.logits_at(cfg, w, list(toks), rows, quant="fp8")
    assert float((low[0] - got[0]).abs().max()) > 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("name", [STREAM, SERVE])
def test_sound_run_on_the_card(cuda, name):
    out, correct = drive(name, device=cuda, control=True,
                         backend="cuda")
    assert out["attempted"] > 0 and correct, out["checks"]
    assert not all(report.passes(k) for k in out["control"])
