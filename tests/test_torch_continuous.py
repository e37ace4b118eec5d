"""The port's ContinuousEngine against the JAX package's on the CPU.

Reduced qwen3-1.7b (full caches) and reduced gemma2-9b (window 8, so ring
caches wrap and ragged prompts straddle the window).  Weights come from the
reference's ``init_params``; prompts are drawn with numpy from a seed.
Both engines serve the same requests with float32 caches and greedy decode;
the emission sequence ``(rid, tokens, status)`` and ``stats`` must be equal
(``recovery_seconds`` is a wall time, held only to be positive), for
ragged admission, deadlines on a counting clock, the chained dispatcher and
a run killed at a segment and resumed on fewer slots.
"""
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced
from repro.models import transformer as JT
from repro.resilience import FaultPlan as JFaultPlan
from repro.resilience import RecoveryConfig as JRecoveryConfig
from repro.resilience.recovery import PreemptionError as JPreemptionError
from repro.serve import GenerateConfig as JGenerateConfig
from repro.serve.batcher import Request as JRequest
from repro.serve.engine import ContinuousEngine as JEngine
from repro_torch import interop
from repro_torch.configs import get_reduced as port_reduced
from repro_torch.resilience import FaultPlan, PreemptionError, RecoveryConfig
from repro_torch.serve import (ContinuousEngine, GenerateConfig, Request,
                               generate)


@pytest.fixture(scope="module", params=["qwen3-1.7b", "gemma2-9b"])
def served(request):
    arch = request.param
    cfg = get_reduced(arch)
    params = JT.init_params(cfg, jax.random.PRNGKey(0))
    model = interop.params_from_reference(
        port_reduced(arch), jax.tree.map(np.asarray, params), device="cpu")
    return arch, cfg, params, model


def ticking_clock():
    ticks = [0]

    def clock():
        ticks[0] += 1
        return float(ticks[0])
    return clock


def specs(cfg, seed, lens, budgets, deadlines=None):
    rng = np.random.default_rng(seed)
    deadlines = deadlines or [None] * len(lens)
    return [(i, np.asarray(rng.integers(2, cfg.vocab_size, L), np.int32), b,
             d) for i, (L, b, d) in enumerate(zip(lens, budgets, deadlines))]


def collect():
    seq = []

    def sink(rid, toks, status):
        seq.append((int(rid), [int(x) for x in np.asarray(toks)], status))
    return seq, sink


def without_wall(stats):
    """The counters of a run, without its wall clock and the port's own
    keys, which the reference's engine does not keep: its spans
    (``span_*``, ``idle_ms.*``), its graph counters (``graph_*``) and its
    decode attention's routes (``attn_decode_*``)."""
    return {k: v for k, v in stats.items() if k != "recovery_seconds"
            and not k.startswith(("span_", "idle_ms.", "graph_",
                                  "attn_decode_"))}


def run_both(served, reqs, *, cap, eos=1, slots=2, segment=2,
             max_prompt_len=None, clocked=False, **run_kw):
    """Serve ``reqs`` on both engines; returns ((seq, stats) jax,
    (seq, stats) port)."""
    arch, cfg, params, model = served
    out = []
    for side in ("jax", "port"):
        if side == "jax":
            eng = JEngine(cfg, params, JGenerateConfig(
                max_new_tokens=cap, eos_id=eos), slots=slots,
                cache_dtype=jnp.float32, segment=segment,
                max_prompt_len=max_prompt_len)
            mk = JRequest
        else:
            eng = ContinuousEngine(port_reduced(arch), model, GenerateConfig(
                max_new_tokens=cap, eos_id=eos), slots=slots,
                cache_dtype=torch.float32, segment=segment,
                max_prompt_len=max_prompt_len, device="cpu")
            mk = Request
        seq, sink = collect()
        n = eng.run([mk(rid=i, prompt=p, max_new_tokens=b, deadline=d)
                     for i, p, b, d in reqs], sink,
                    clock=ticking_clock() if clocked else None, **run_kw)
        assert n == len(seq)
        out.append((seq, eng.stats))
    return out


def assert_same(ref, got):
    (rseq, rstats), (gseq, gstats) = ref, got
    assert gseq == rseq
    assert without_wall(gstats) == without_wall(rstats)


@pytest.mark.parametrize("chained", [False, True])
def test_ragged_admission_matches_reference(served, chained):
    """Ragged prompts (gemma2's straddle its window 8) and budgets 1-7
    through 3 slots: the same emissions in the same order, the same
    segment, admission and idle-slot counts, one binding serving the
    stream (each entry point served once)."""
    arch, cfg, _, _ = served
    reqs = specs(cfg, 1, [3, 11, 5, 9, 12, 2, 7], [2, 7, 1, 5, 3, 7, 4])
    ref, got = run_both(served, reqs, cap=7, slots=3, chained=chained)
    assert_same(ref, got)
    assert sorted(r for r, _, _ in got[0]) == list(range(7))
    stats = got[1]
    assert stats["prefills"] == 7 and stats["prefill_traces"] == 1
    assert stats["segment_traces"] == 1
    assert stats["chain_traces"] == int(chained)


def test_results_equal_solo_generate(served):
    """The port's own oracle: each request's tokens equal its solo greedy
    ``generate``, which never pads (a pad leaking into a window, a ring
    slot or the sampled row would diverge the argmax chain)."""
    arch, cfg, _, model = served
    reqs = specs(cfg, 2, [4, 10, 6, 12], [3, 6, 6, 2])
    eng = ContinuousEngine(port_reduced(arch), model,
                           GenerateConfig(max_new_tokens=6), slots=2,
                           cache_dtype=torch.float32, device="cpu")
    seq, sink = collect()
    eng.run([Request(rid=i, prompt=p, max_new_tokens=b)
             for i, p, b, _ in reqs], sink)
    for rid, toks, status in seq:
        _, p, b, _ = reqs[rid]
        solo, L, _ = generate(port_reduced(arch), model, p[None],
                              GenerateConfig(max_new_tokens=b),
                              cache_dtype=torch.float32, device="cpu")
        assert status == "ok" and toks == solo[0, :int(L[0])].tolist()


def test_eos_retires_mid_segment(served):
    """EOS chosen as a token the stream really emits, so sequences retire
    on it mid-segment, not only at their budgets."""
    arch, cfg, _, _ = served
    reqs = specs(cfg, 3, [5, 8, 6, 4, 9], [6] * 5)
    (seq, _), _ = run_both(served, reqs, cap=6)
    eos = seq[0][1][2]
    ref, got = run_both(served, reqs, cap=6, eos=eos, segment=3)
    assert_same(ref, got)
    assert any(len(toks) < 6 for _, toks, _ in got[0])


def test_deadlines_on_a_counting_clock(served):
    """Shed at admission (deadline already passed), evicted mid-decode
    with partial tokens (its slot refilled), and evicted with an empty
    queue (the slot retired in place): statuses, tokens and counts as the
    reference's on the same clock."""
    arch, cfg, _, _ = served
    never = -1                        # no token is negative
    reqs = specs(cfg, 4, [5, 5, 7, 5, 6], [6, 12, 12, 4, 12],
                 [None, -1.0, 3.0, None, 8.0])
    ref, got = run_both(served, reqs, cap=12, eos=never, clocked=True)
    assert_same(ref, got)
    status = {r: s for r, _, s in got[0]}
    assert status[1] == "timed_out" and got[1]["shed"] == 1
    assert status[2] == status[4] == "timed_out"
    assert got[1]["evicted"] == 2


@pytest.mark.parametrize("seed,slots,segment", [(5, 2, 2), (7, 4, 3)])
def test_chained_emits_the_sync_sequence(served, seed, slots, segment):
    """``chained=True``: the reference's chained emissions in its order,
    and the sync path's emissions token for token; the lagged admissions
    idle more slot-steps.  The order may differ from the sync path's (a
    request seated one segment later may finish later), on the reference
    as on the port."""
    arch, cfg, _, model = served
    reqs = specs(cfg, seed, [6, 3, 9, 4, 8, 5, 12, 7],
                 [5, 2, 6, 3, 6, 1, 4, 6])
    ref, got = run_both(served, reqs, cap=6, chained=True, slots=slots,
                        segment=segment)
    assert_same(ref, got)
    _, sync = run_both(served, reqs, cap=6, slots=slots, segment=segment)
    assert sorted(got[0]) == sorted(sync[0])
    assert got[1]["idle_slot_steps"] >= sync[1]["idle_slot_steps"]


def test_killed_and_resumed_on_fewer_slots(served, tmp_path):
    """Killed at segment 3 (``FaultPlan.preempt_hook``) with snapshots and
    the journal, then resumed on 2 slots with an empty queue: every rid
    emitted exactly once, the tokens of an uninterrupted run, and the
    resumed run's emissions (the journal's replay first) and stats as the
    reference's."""
    arch, cfg, params, model = served
    reqs = specs(cfg, 6, [4, 9, 5, 12, 6, 7, 3], [4, 8, 6, 4, 8, 5, 6])
    pcfg = port_reduced(arch)
    sides = {
        "jax": (lambda slots: JEngine(cfg, params, JGenerateConfig(
                    max_new_tokens=8, eos_id=-1), slots=slots,
                    cache_dtype=jnp.float32, segment=2),
                JRequest, JRecoveryConfig, JFaultPlan, JPreemptionError),
        "port": (lambda slots: ContinuousEngine(pcfg, model, GenerateConfig(
                     max_new_tokens=8, eos_id=-1), slots=slots,
                     cache_dtype=torch.float32, segment=2, device="cpu"),
                 Request, RecoveryConfig, FaultPlan, PreemptionError)}
    res = {}
    for side, (engine, mk, Rec, Plan, Preempted) in sides.items():
        work = [mk(rid=i, prompt=p, max_new_tokens=b) for i, p, b, _ in reqs]
        full, sink = collect()
        engine(3).run(list(work), sink)
        rec = Rec(dir=str(tmp_path / side), snapshot_every=1, fsync=False)
        killed, sink = collect()
        with pytest.raises(Preempted):
            engine(3).run(list(work), sink, recovery=rec,
                          on_segment=Plan(lanes=3, preempt_at_segment=3)
                          .preempt_hook(mode="raise"))
        eng = engine(2)
        resumed, sink = collect()
        eng.run([], sink, recovery=rec, resume=True)
        res[side] = (full, killed, resumed, eng.stats)
    (jfull, jkilled, jres, jstats), (full, killed, resumed, stats) = \
        res["jax"], res["port"]
    assert full == jfull and killed == jkilled and resumed == jres
    assert without_wall(stats) == without_wall(jstats)
    assert stats["recovered_occupants"] > 0 and stats["replayed_items"] > 0
    assert stats["recovery_seconds"] > 0
    assert sorted(r for r, _, _ in resumed) == list(range(len(reqs)))
    assert sorted(resumed) == sorted(full)


def test_a_dropped_engine_frees_its_pool(served):
    """After ``run`` the engine keeps a snapshot closure; it must not hold
    the engine in a reference cycle, or a dropped engine's KV pool and
    weights stay allocated until the next garbage collection."""
    arch, cfg, _, model = served
    eng = ContinuousEngine(port_reduced(arch), model,
                           GenerateConfig(max_new_tokens=3), slots=2,
                           cache_dtype=torch.float32, device="cpu")
    eng.run([Request(rid=0, prompt=specs(cfg, 8, [5], [3])[0][1])],
            lambda *a: None)
    assert eng.snapshot()["complete"]
    pool = weakref.ref(eng._caches[0]["k"])
    gc.disable()
    try:
        del eng
        assert pool() is None
    finally:
        gc.enable()


@pytest.mark.parametrize("tree,match", [
    ({"kind": "farm"}, "not a ContinuousEngine"),
    ({"kind": "serve", "version": 2}, "version"),
    ({"kind": "serve", "version": 1, "cap": 5, "S0": 4}, "generation cap"),
    ({"kind": "serve", "version": 1, "cap": 3, "S0": 4,
      "occupants": [{"rid": 0, "prefix": [], "unit": []}]}, "caches"),
])
def test_restore_refuses_foreign_trees(served, tree, match):
    arch, _, _, model = served
    eng = ContinuousEngine(port_reduced(arch), model,
                           GenerateConfig(max_new_tokens=3), device="cpu")
    with pytest.raises(ValueError, match=match):
        eng.restore(tree)
