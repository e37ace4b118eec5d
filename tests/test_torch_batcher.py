"""The port's Batcher (and the continuous engine under it) against the JAX
package's on the CPU: the cases of tests/train/test_batcher.py,
tests/resilience/test_serve_faults.py, the serve cases of
tests/train/test_serve.py and tests/train/test_serve_properties.py.

Reduced qwen3-1.7b (gemma2-9b where ring caches matter, mamba2-130m for
the SSM fallback); weights from the reference's ``init_params``; prompts
drawn with numpy from a seed; float32 caches, greedy decode.  Results
``(rid, tokens, status)`` are held equal to the reference's, in order;
deadline timing runs on a counting clock (one tick a read).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced
from repro.models import transformer as JT
from repro.serve import GenerateConfig as JGenerateConfig
from repro.serve.batcher import Batcher as JBatcher
from repro.serve.batcher import Request as JRequest
from repro_torch import interop
from repro_torch.configs import get_reduced as port_reduced
from repro_torch.serve import (Batcher, ContinuousEngine, GenerateConfig,
                               Request, Result, generate)


def load(arch):
    cfg = get_reduced(arch)
    params = JT.init_params(cfg, jax.random.PRNGKey(0))
    model = interop.params_from_reference(
        port_reduced(arch), jax.tree.map(np.asarray, params), device="cpu")
    return cfg, params, port_reduced(arch), model


@pytest.fixture(scope="module")
def served():
    return load("qwen3-1.7b")


def ticking_clock():
    ticks = [0]

    def clock():
        ticks[0] += 1
        return float(ticks[0])
    return clock


def prompts(cfg, seed, lens):
    rng = np.random.default_rng(seed)
    return [np.asarray(rng.integers(2, cfg.vocab_size, L), np.int32)
            for L in lens]


def both(served, reqs, *, cap, eos=1, max_batch=2, clocked=False,
         how="run_all", **kw):
    """Submit ``reqs`` (rid, prompt, budget, deadline) to both batchers and
    drain them with ``how``; returns (jax results, port results, port
    batcher) with results as (rid, tokens, status) lists."""
    cfg, params, pcfg, model = served
    sides = [JBatcher(cfg, params, JGenerateConfig(max_new_tokens=cap,
                                                   eos_id=eos),
                      max_batch=max_batch, cache_dtype=jnp.float32,
                      clock=ticking_clock() if clocked else None),
             Batcher(pcfg, model, GenerateConfig(max_new_tokens=cap,
                                                 eos_id=eos),
                     max_batch=max_batch, cache_dtype=torch.float32,
                     clock=ticking_clock() if clocked else None,
                     device="cpu")]
    out = []
    for b, mk in zip(sides, (JRequest, Request)):
        for rid, p, bud, dl in reqs:
            assert b.submit(mk(rid=rid, prompt=p, max_new_tokens=bud,
                               deadline=dl)) is None
        res = getattr(b, how)(**kw)
        out.append([(r.rid, [int(x) for x in np.asarray(r.tokens)],
                     r.status) for r in res])
    return out[0], out[1], sides[1]


def spec(cfg, seed, lens, budgets=None, deadlines=None):
    n = len(lens)
    return list(zip(range(n), prompts(cfg, seed, lens),
                    budgets or [None] * n, deadlines or [None] * n))


# ---------------------------------------------------------------------------
# tests/train/test_batcher.py
# ---------------------------------------------------------------------------


def test_ragged_prompts_batched_and_answered(served):
    cfg = served[0]
    ref, got, _ = both(served, spec(cfg, 0, [5, 8, 7, 12, 16, 3, 8, 5]),
                       cap=6, max_batch=4)
    assert got == ref
    assert sorted(r for r, _, _ in got) == list(range(8))
    assert all(1 <= len(t) <= 6 for _, t, _ in got)


def test_round_mode_honors_request_budgets(served):
    """Per-request budgets ride the done-mask in both paths, with the
    reference's tokens, and round and continuous agree token for token."""
    cfg, _, pcfg, model = served
    budgets = [2, 9, 4, 1, 6]
    reqs = spec(cfg, 1, [6] * 5, budgets)
    ref, got, _ = both(served, reqs, cap=9)
    assert got == ref
    for rid, toks, _ in got:
        assert len(toks) <= budgets[rid]
    _, cont, _ = both(served, reqs, cap=9, how="run_continuous")
    assert dict((r, t) for r, t, _ in cont) == dict((r, t) for r, t, _ in got)
    b = Batcher(pcfg, model, GenerateConfig(max_new_tokens=9), max_batch=2,
                device="cpu")
    b.submit(Request(rid=0, prompt=reqs[0][1], max_new_tokens=99))
    with pytest.raises(ValueError, match="budget"):
        b.run_all()


class _CountingArray:
    """A stand-in for a device array handed to ``_drain``: counts
    whole-array pulls and refuses element indexing."""

    def __init__(self, arr):
        self._arr = np.asarray(arr)
        self.pulls = 0

    def __array__(self, dtype=None, copy=None):
        self.pulls += 1
        return self._arr if dtype is None else self._arr.astype(dtype)

    def __getitem__(self, i):
        raise AssertionError("per-element device indexing in _drain")


def test_drain_pulls_each_batch_array_once(served):
    cfg, _, pcfg, model = served
    b = Batcher(pcfg, model, GenerateConfig(max_new_tokens=4), max_batch=3,
                device="cpu")
    batch = [Request(rid=i, prompt=p)
             for i, p in enumerate(prompts(cfg, 2, [5] * 3))]
    gen = np.asarray(np.random.default_rng(3).integers(
        2, cfg.vocab_size, (3, 4)), np.int32)
    lengths = _CountingArray(np.asarray([2, 4, 1], np.int32))
    out = []
    b._drain((batch, gen, lengths), out)
    assert lengths.pulls == 1
    assert [len(r.tokens) for r in out] == [2, 4, 1]
    # a device tensor comes over once as a whole, too
    out = []
    b._drain((batch, torch.as_tensor(gen), torch.tensor([1, 2, 3])), out)
    assert [r.tokens.tolist() for r in out] == [
        gen[0, :1].tolist(), gen[1, :2].tolist(), gen[2, :3].tolist()]


def test_batched_equals_solo_greedy(served):
    cfg, _, pcfg, model = served
    p = prompts(cfg, 4, [8])[0]
    solo = Batcher(pcfg, model, GenerateConfig(max_new_tokens=5),
                   max_batch=1, device="cpu")
    solo.submit(Request(rid=0, prompt=p))
    r_solo = solo.run_all()[0]
    multi = Batcher(pcfg, model, GenerateConfig(max_new_tokens=5),
                    max_batch=3, device="cpu")
    others = prompts(cfg, 5, [8, 8])
    for i, q in enumerate([others[0], p, others[1]]):
        multi.submit(Request(rid=i, prompt=q))
    r_multi = [r for r in multi.run_all() if r.rid == 1][0]
    np.testing.assert_array_equal(r_solo.tokens, r_multi.tokens)


# ---------------------------------------------------------------------------
# the serve cases of tests/train/test_serve.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,lens,budgets", [
    ("qwen3-1.7b", [6] * 5, [2, 12, 3, 12, 4]),       # slot reuse
    ("qwen3-1.7b", [4, 7, 4, 7, 4], [2, 8, 2, 8, 3]),  # ragged
    ("gemma2-9b", [3, 9, 5, 12, 4], [2, 7, 3, 7, 4]),  # ragged on rings
])
def test_continuous_mid_batch_emission_matches_reference(arch, lens,
                                                         budgets):
    """One binding serves the ragged queue; a short request of the first
    cohort is emitted before its long neighbour; results as the
    reference's, in completion order."""
    served_ = load(arch)
    ref, got, b = both(served_, spec(served_[0], 6, lens, budgets),
                       cap=12 if arch == "qwen3-1.7b" and len(set(lens)) == 1
                       else 10, how="run_continuous")
    assert got == ref
    assert len(b.engines) == 1
    eng = b.engines[0]
    assert eng.stats["segment_traces"] == eng.stats["prefill_traces"] == 1
    assert eng.stats["prefills"] == 5
    pos = {r: k for k, (r, _, _) in enumerate(got)}
    assert pos[0] < pos[1]


def test_single_pool_idles_less_than_exact_groups(served):
    cfg = served[0]
    reqs = spec(cfg, 0, [4, 7, 4, 7, 4], [2, 8, 2, 8, 3])
    _, single, b1 = both(served, reqs, cap=10, how="run_continuous")
    ref, grouped, b2 = both(served, reqs, cap=10, how="run_continuous",
                            exact_groups=True)
    assert grouped == ref
    assert len(b1.engines) == 1 and len(b2.engines) == 2
    assert sorted(single) == sorted(grouped)
    idle = [sum(e.stats["idle_slot_steps"] for e in b.engines)
            for b in (b1, b2)]
    assert idle[0] < idle[1], idle


def test_ssm_arch_falls_back_to_exact_groups():
    served_ = load("mamba2-130m")
    ref, got, b = both(served_, spec(served_[0], 7, [4, 6, 4], [3, 3, 3]),
                       cap=4, how="run_continuous")
    assert got == ref
    assert len(b.engines) == 2, "SSM archs keep exact-length grouping"


def test_sink_exception_does_not_corrupt_the_engine(served):
    cfg, _, pcfg, model = served
    eng = ContinuousEngine(pcfg, model, GenerateConfig(max_new_tokens=3),
                           slots=2, cache_dtype=torch.float32, device="cpu")
    p = prompts(cfg, 8, [4])[0]
    reqs = [Request(rid=i, prompt=p) for i in range(2)]

    def boom(rid, toks, status):
        raise RuntimeError("sink failed")
    with pytest.raises(RuntimeError, match="sink failed"):
        eng.run(reqs, boom)
    got = []
    assert eng.run(reqs, lambda rid, toks, status: got.append(rid)) == 2
    assert sorted(got) == [0, 1]


def test_unsupported_models_and_overbudget_rejected(served):
    cfg, _, pcfg, model = served
    gcfg = GenerateConfig(max_new_tokens=4)
    with pytest.raises(ValueError, match="per-sequence positions"):
        ContinuousEngine(port_reduced("whisper-base"), None, gcfg)
    with pytest.raises(ValueError, match="per-sequence positions"):
        ContinuousEngine(port_reduced("phi-3-vision-4.2b"), None, gcfg)
    eng = ContinuousEngine(pcfg, model, gcfg, slots=2,
                           cache_dtype=torch.float32, device="cpu")
    p = prompts(cfg, 9, [4])[0]
    for bud in (9, 0):
        with pytest.raises(ValueError, match="budget"):
            eng.run([Request(rid=0, prompt=p, max_new_tokens=bud)],
                    lambda *a: None)
    eng2 = ContinuousEngine(pcfg, model, gcfg, slots=2,
                            cache_dtype=torch.float32, max_prompt_len=4,
                            device="cpu")
    with pytest.raises(ValueError, match="max_prompt_len"):
        eng2.run([Request(rid=0, prompt=np.concatenate([p, p]))],
                 lambda *a: None)
    eng3 = ContinuousEngine(port_reduced("mamba2-130m"), None, gcfg, slots=2)
    with pytest.raises(ValueError, match="attention-only"):
        eng3.run([Request(rid=0, prompt=p), Request(rid=1, prompt=p[:2])],
                 lambda *a: None)


# ---------------------------------------------------------------------------
# tests/resilience/test_serve_faults.py
# ---------------------------------------------------------------------------


def test_engine_deadlines_match_reference(served):
    """Shed at admission, evicted mid-decode (slot refilled), evicted with
    an empty queue (slot retired), through the batcher on one clock:
    statuses and partial tokens as the reference's, counts in stats."""
    cfg = served[0]
    reqs = spec(cfg, 10, [5] * 5, [6, None, None, 4, None],
                [None, -1.0, 3.0, None, 5.0])
    ref, got, b = both(served, reqs, cap=12, eos=-1, clocked=True,
                       how="run_continuous")
    assert got == ref
    status = {r: s for r, _, s in got}
    assert status == {0: "ok", 1: "timed_out", 2: "timed_out", 3: "ok",
                      4: "timed_out"}
    assert b.stats["shed"] == 1 and b.stats["evicted"] == 2


def test_healthy_requests_identical_under_degradation(served):
    cfg, _, pcfg, model = served
    gcfg = GenerateConfig(max_new_tokens=6, eos_id=-1)
    ps = prompts(cfg, 11, [5] * 4)
    healthy = [Request(rid=i, prompt=ps[i]) for i in range(4)]
    doomed = [Request(rid=10, prompt=ps[0], deadline=-1.0),
              Request(rid=11, prompt=ps[1], deadline=4.0)]

    def drive(reqs):
        eng = ContinuousEngine(pcfg, model, gcfg, slots=2, segment=2,
                               cache_dtype=torch.float32, device="cpu")
        got = {}
        eng.run(reqs, lambda rid, t, s: got.__setitem__(rid, (t, s)),
                clock=ticking_clock())
        return got

    ref = drive(healthy)
    mixed = drive([healthy[0], doomed[0], healthy[1], doomed[1],
                   healthy[2], healthy[3]])
    for i in range(4):
        assert mixed[i][1] == "ok"
        np.testing.assert_array_equal(mixed[i][0], ref[i][0])


def test_queue_bound_sheds_with_reason(served):
    cfg, _, pcfg, model = served
    b = Batcher(pcfg, model, GenerateConfig(max_new_tokens=4), max_batch=2,
                max_queue=2, device="cpu")
    p = prompts(cfg, 12, [5])[0]
    assert b.submit(Request(rid=0, prompt=p)) is None
    assert b.submit(Request(rid=1, prompt=p)) is None
    rej = b.submit(Request(rid=2, prompt=p))
    assert isinstance(rej, Result)
    assert rej.status == "shed" and "queue full" in rej.error
    assert len(rej.tokens) == 0
    assert b.stats["shed_queue_full"] == 1 and b.stats["accepted"] == 2


def test_projected_delay_past_deadline_sheds(served):
    cfg, _, pcfg, model = served
    b = Batcher(pcfg, model, GenerateConfig(max_new_tokens=4), max_batch=2,
                est_service_time=10.0, clock=ticking_clock(), device="cpu")
    p = prompts(cfg, 13, [5])[0]
    for i in range(4):
        assert b.submit(Request(rid=i, prompt=p)) is None
    rej = b.submit(Request(rid=9, prompt=p, deadline=5.0))
    assert rej is not None and rej.status == "shed"
    assert "deadline" in rej.error and b.stats["shed_deadline"] == 1
    assert b.submit(Request(rid=10, prompt=p, deadline=1e6)) is None


def test_shed_never_blocks_undeadlined_requests(served):
    cfg, _, pcfg, model = served
    b = Batcher(pcfg, model, GenerateConfig(max_new_tokens=3), max_batch=2,
                est_service_time=10.0, clock=ticking_clock(), device="cpu")
    assert b.submit(Request(rid=0, prompt=prompts(cfg, 14, [5])[0])) is None
    res = b.run_all()
    assert len(res) == 1 and res[0].status == "ok"


def test_drain_failure_degrades_to_failed_results(served):
    cfg, _, pcfg, model = served
    b = Batcher(pcfg, model, GenerateConfig(max_new_tokens=4), max_batch=2,
                device="cpu")
    batch = [Request(rid=i, prompt=p)
             for i, p in enumerate(prompts(cfg, 15, [5, 5]))]

    class Boom:
        def __array__(self, dtype=None, copy=None):
            raise RuntimeError("device buffer poisoned")

    out = [Result(rid=99, tokens=np.zeros((2,), np.int32))]
    b._drain((batch, Boom(), Boom()), out)
    assert len(out) == 3 and out[0].rid == 99
    for r in out[1:]:
        assert r.status == "failed" and "poisoned" in r.error
        assert len(r.tokens) == 0


def test_continuous_midstream_exception_degrades(served, monkeypatch):
    cfg, _, pcfg, model = served
    b = Batcher(pcfg, model, GenerateConfig(max_new_tokens=3), max_batch=2,
                device="cpu")
    for i, p in enumerate(prompts(cfg, 16, [5] * 4)):
        b.submit(Request(rid=i, prompt=p))
    real_run = ContinuousEngine.run
    state = {"emitted": 0}

    def flaky_run(self, requests, emit, **kw):
        def tripwire(rid, toks, status):
            emit(rid, toks, status)
            state["emitted"] += 1
            if state["emitted"] == 2:
                raise RuntimeError("lost the accelerator")
        return real_run(self, requests, tripwire, **kw)

    monkeypatch.setattr(ContinuousEngine, "run", flaky_run)
    res = b.run_continuous()
    assert sorted(r.rid for r in res) == [0, 1, 2, 3]
    fails = [r for r in res if r.status == "failed"]
    assert len(fails) == 2 and len(res) - len(fails) == 2
    assert all("lost the accelerator" in r.error for r in fails)
    assert b.stats["failed"] == 2


def test_continuous_statuses_ride_results(served):
    """A mid-decode eviction surfaces as ``Result.status`` through the
    batcher (default segment 8, budget 24: three segments)."""
    cfg = served[0]
    reqs = spec(cfg, 17, [5, 5], [4, None], [None, 3.0])
    ref, got, b = both(served, reqs, cap=24, eos=-1, clocked=True,
                       how="run_continuous")
    assert got == ref
    res = {r: (t, s) for r, t, s in got}
    assert res[0] == (res[0][0], "ok") and len(res[0][0]) == 4
    assert res[1][1] == "timed_out" and len(res[1][0]) < 24
    assert b.stats["evicted"] + b.stats["shed"] == 1


# ---------------------------------------------------------------------------
# tests/train/test_serve_properties.py, on fixed draws
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lens,budgets,slots", [
    ([1, 9, 4], [6, 1, 3], 1),
    ([7, 2, 2, 9, 5, 3], [2, 6, 6, 1, 4, 5], 3),
    ([8, 8, 3, 1], [5, 3, 6, 2], 2),
])
def test_exactly_once_no_pad_leak_and_accounting(served, lens, budgets,
                                                 slots):
    """Every request once through one binding, each equal to its solo
    greedy ``generate`` (which never pads), budgets exact, and
    slot_steps = useful + idle (useful = the emitted tokens past the
    prefilled first) — and the reference's results."""
    cfg, _, pcfg, model = served
    reqs = spec(cfg, sum(lens) + 17 * slots, lens, budgets)
    ref, got, b = both(served, reqs, cap=6, max_batch=slots,
                       how="run_continuous")
    assert got == ref
    assert len(b.engines) == 1
    assert sorted(r for r, _, _ in got) == list(range(len(lens)))
    for rid, toks, _ in got:
        solo, L, _ = generate(pcfg, model, reqs[rid][1][None],
                              GenerateConfig(max_new_tokens=budgets[rid]),
                              cache_dtype=torch.float32, device="cpu")
        assert toks == solo[0, :int(L[0])].tolist()
        assert len(toks) <= budgets[rid]
    st = b.engines[0].stats
    useful = sum(len(t) - 1 for _, t, _ in got)
    assert st["idle_slot_steps"] >= 0
    assert st["slot_steps"] == useful + st["idle_slot_steps"]
