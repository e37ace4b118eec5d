"""The port's spans (``repro_torch.obs``): off, a span is one check and
touches nothing; on, the engines' spans lie in a profiler's trace, fold
into their ``stats``, and change no output, host read or slot step; the
idle attribution is a pure function of host intervals and gaps.  The
``cuda``-marked tests hold the device spans to no host synchronisation and
a graph capture to no event."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.configs import get_reduced
from repro_torch.core import pattern as TP
from repro_torch.core import streaming as TS
from repro_torch.models import transformer as T
from repro_torch.serve import ContinuousEngine, GenerateConfig, Request
from repro_torch.serve import engine as TE
from repro_torch.serve.graphs import StepGraph

TRIPS = [3, 5, 2, 7, 4, 1, 6, 3]


@pytest.fixture(autouse=True)
def tracing_off():
    obs.enable(False)
    yield
    obs.enable(False)


def countdown(get, *_):
    return get(0, 0) - 1.0


def farm(chained=True):
    loop = TP.LoopOfStencilReduce(
        f=countdown, k=1, combine="max", cond=lambda r: r < 0.5,
        boundary="zero", max_iters=64, backend="torch", device="cpu")
    return TS.FarmEngine(loop, lanes=2, segment=4, chained=chained,
                         device="cpu")


def stream(eng):
    """The emissions of a small stream: (index, iters, status, grid)."""
    base = np.linspace(0.1, 0.9, 8 * 16, dtype=np.float32).reshape(8, 16)
    out = []
    eng.run([torch.as_tensor(base + t) for t in TRIPS],
            lambda r: out.append((r.index, int(r.iters), r.status, r.a)),
            continuous=True)
    return out


@pytest.fixture(scope="module")
def moe_model():
    cfg = get_reduced("deepseek-moe-16b")
    return cfg, T.init_params(cfg, device="cpu")


def serve(cfg, model, chained=False):
    """A small served job on a MoE stack: (engine, emissions)."""
    eng = ContinuousEngine(cfg, model, GenerateConfig(max_new_tokens=5),
                           slots=2, segment=3, cache_dtype=torch.float32,
                           device="cpu")
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=np.asarray(
        rng.integers(2, cfg.vocab_size, n), np.int32), max_new_tokens=b)
        for i, (n, b) in enumerate([(3, 4), (6, 2), (4, 5)])]
    seq = []
    eng.run(reqs, lambda r, t, s: seq.append((r, t.tolist(), s)),
            chained=chained)
    return eng, seq


def trace_keys(stats):
    return {k: v for k, v in stats.items()
            if k.startswith(("span_", "idle_ms."))}


class Counting:
    """A constructor that counts its calls."""

    def __init__(self, cls):
        self.cls, self.n = cls, 0

    def __call__(self, *a, **kw):
        self.n += 1
        return self.cls(*a, **kw)


def test_off_a_span_touches_nothing(monkeypatch, moe_model):
    rf = Counting(torch._C._profiler._RecordFunctionFast)
    ev = Counting(torch.cuda.Event)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", rf)
    monkeypatch.setattr(torch.cuda, "Event", ev)
    before = obs.table()
    assert obs.span("a", device=True) is obs.span("b")
    f = farm()
    stream(f)
    eng, _ = serve(*moe_model)
    assert (rf.n, ev.n) == (0, 0)
    assert obs.table() == before
    for e in (f, eng):
        assert set(trace_keys(e.stats).values()) == {0}
    obs.enable()                       # the counters do count when on
    with obs.span("a"):
        pass
    assert rf.n == 1


def test_on_the_spans_lie_in_a_cpu_profile(moe_model):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        stream(farm())
        serve(*moe_model)
    names = {e.name for e in prof.events()}
    assert {"farm.stage", "farm.check", "farm.prep", "farm.dispatch",
            "farm.emit", "loop.step", "loop.exit_read", "serve.admit",
            "serve.segment", "moe.route", "moe.experts"} <= names


def test_every_trace_key_exists_at_construction(moe_model):
    f = farm()
    eng = ContinuousEngine(*moe_model, GenerateConfig(max_new_tokens=5),
                           slots=2, device="cpu")
    for e, spans, dev, other in (
            (f, TS.FARM_SPANS, TS.FARM_DEVICE_SPANS, "farm.other"),
            (eng, TE.SERVE_SPANS, TE.SERVE_DEVICE_SPANS, "serve.other")):
        want = obs.stats_keys(spans, device=dev, other=other)
        assert want.items() <= e.stats.items()
        for n in spans:
            assert f"span_n.{n}" in e.stats and f"idle_ms.{n}" in e.stats
            assert (f"span_dev_ms.{n}" in e.stats) == (n in dev)
        assert all(isinstance(v, (int, float)) for v in e.stats.values())
    assert eng.stats["graph_replays"] == eng.stats["graph_captures"] == 0


@pytest.mark.parametrize("chained", [True, False])
def test_tracing_changes_no_stream_output(chained):
    off = farm(chained)
    a = stream(off)
    obs.enable()
    on = farm(chained)
    b = stream(on)
    assert [x[:3] for x in a] == [x[:3] for x in b]
    assert all(torch.equal(x[3], y[3]) for x, y in zip(a, b))
    for key in ("host_reads", "lane_steps", "wasted_lane_steps", "refills",
                "segments"):
        assert on.stats[key] == off.stats[key], key
    s = on.stats
    assert s["span_n.farm.emit"] == len(TRIPS)
    assert s["span_n.farm.check"] == len(TRIPS)
    assert s["span_n.farm.sink"] == len(TRIPS)
    assert s["span_n.farm.dispatch"] == s["segments"]
    assert s["span_host_ms.farm.stage"] > 0
    # no CUDA event on the CPU: nothing of the device is counted
    assert s["span_dev_n.farm.prep"] == 0 and s["idle_ms.farm.other"] == 0


@pytest.mark.parametrize("chained", [False, True])
def test_tracing_changes_no_served_output(moe_model, chained):
    off, a = serve(*moe_model, chained=chained)
    obs.enable()
    on, b = serve(*moe_model, chained=chained)
    assert a == b
    for key in ("slot_steps", "idle_slot_steps", "segments", "prefills"):
        assert on.stats[key] == off.stats[key], key
    s = on.stats
    assert s["span_n.serve.admit"] == s["prefills"] == 3
    assert s["span_n.serve.segment"] == s["segments"]
    assert s["span_n.serve.emit"] == len(b)
    layers = moe_model[0].num_layers - 1        # a dense first layer
    assert s["span_n.moe.route"] >= 3 * layers
    assert s["span_n.moe.route"] == s["span_n.moe.experts"] \
        == s["span_n.moe.combine"] == s["span_n.moe.shared"]


def test_a_second_run_adds_to_the_stats():
    obs.enable()
    f = farm()
    stream(f)
    n, ms = f.stats["span_n.farm.emit"], f.stats["span_host_ms.farm.emit"]
    stream(f)
    assert f.stats["span_n.farm.emit"] == 2 * n
    assert f.stats["span_host_ms.farm.emit"] > ms


# -- the attribution rule on synthetic timelines -----------------------------

@pytest.mark.parametrize("gaps,want", [
    # nested spans: the deepest open at the gap's start takes it
    ([(2.0, 500.0)], {"inner": 500.0}),
    ([(3.5, 1000.0)], {"outer": 1000.0}),
    # a gap before any span goes to "other"
    ([(0.5, 300.0)], {"other": 300.0}),
    # a zero gap goes nowhere
    ([(2.5, 0.0)], {}),
    # a gap over two spans is charged where it starts
    ([(4.5, 2000.0)], {"outer": 2000.0}),
    ([(2.5, 4000.0)], {"inner": 4000.0}),
    ([(2.0, 500.0), (3.5, 1000.0), (2.1, 100.0)],
     {"inner": 600.0, "outer": 1000.0}),
])
def test_idle_goes_to_the_span_open_at_its_start(gaps, want):
    spans = [("outer", 1.0, 5.0, 0), ("inner", 2.0, 3.0, 1),
             ("next", 5.5, 7.0, 0)]
    got = obs.attribute(spans, gaps, "other")
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k] == pytest.approx(v)


def test_an_open_span_takes_idle():
    spans = [("run", 0.0, float("inf"), 0), ("step", 1.0, 2.0, 1)]
    assert obs.attribute(spans, [(2.5, 500.0)], "x") == {"run": 500.0}


class FakeEvent:
    """A completed CUDA event at device time ``t`` (seconds)."""

    def __init__(self, t):
        self.t = t

    def query(self):
        return True

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


def test_poll_resolves_pairs_and_snaps_gap_starts(monkeypatch):
    """Device spans add their elapsed time; a gap whose start falls within
    ``SNAP`` after its first event's record starts at that record, so
    idle that opens as a span's work runs out is that span's."""
    for name, value in (("_table", {}), ("_closed", obs.deque()),
                        ("_pending", obs.deque()), ("_last", None)):
        monkeypatch.setattr(obs, name, value)
    obs._closed.extend([("payload", 1.0, 1.001, 1), ("emit", 0.9, 1.2, 0),
                        ("check", 1.1, 1.15, 1)])
    e = [FakeEvent(t) for t in (1.0, 1.0004, 1.2, 1.202, 1.3)]
    obs._pending.extend([
        ("span", e[0], e[1], "payload", None),
        # the device ran dry 30 µs after the payload's end event was
        # recorded at 1.00098 (inside "payload"): the start snaps there
        ("gap", e[1], e[2], 1.20001, 1.00098),
        # this one began well after its first event: charged at h - gap
        ("gap", e[3], e[4], 1.12 + 0.098, 1.0),
    ])
    obs.poll()
    t = obs.table()
    assert t["payload"]["dev_n"] == 1
    assert t["payload"]["dev_ms"] == pytest.approx(0.4)
    assert t["payload"]["idle_ms"] == pytest.approx(199.6)
    assert t["check"]["idle_ms"] == pytest.approx(98.0)
    assert not obs._pending


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (device spans record CUDA events)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_device_spans_resolve_without_a_host_sync(cuda):
    x = torch.ones(1 << 20, device=cuda)
    torch.cuda.synchronize()
    obs.enable()
    stats = obs.stats_keys(("a", "b"), device=("a", "b"), other="o")
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with obs.collect(stats, "o"):
            for _ in range(20):
                with obs.span("a", device=cuda):
                    x.mul_(1.0001)
                with obs.span("b", device=cuda):
                    x.add_(1.0)
                obs.poll()
            torch.cuda.set_sync_debug_mode(prev)
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    assert stats["span_dev_n.a"] == stats["span_dev_n.b"] == 20
    assert stats["span_dev_ms.a"] > 0 and stats["span_dev_ms.b"] > 0


@pytest.mark.cuda
def test_a_span_is_no_device_interval_in_a_cuda_trace(cuda):
    """A span lies in the trace as a host range only: the device's busy
    time in a CUDA trace stays its kernels' and copies'."""
    x = torch.ones(1 << 20, device=cuda)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        with obs.span("farm.dispatch", device=cuda):
            for _ in range(4):
                x.mul_(1.0001)
        torch.cuda.synchronize()
    spans = [e for e in prof.events() if e.name == "farm.dispatch"]
    assert spans and all(e.device_type == torch.autograd.DeviceType.CPU
                         for e in spans)


@pytest.mark.cuda
def test_a_graph_capture_with_tracing_on_records_no_event(cuda,
                                                          monkeypatch):
    x = torch.zeros(1024, device=cuda)

    def step():
        with obs.span("moe.experts", device=cuda, idle=False):
            x.add_(1.0)
    g = StepGraph(step, cuda)
    g()
    g()                                    # the warm-up steps
    obs.enable()
    ev = Counting(torch.cuda.Event)
    monkeypatch.setattr(torch.cuda, "Event", ev)
    g()                                    # captures, then replays
    assert g.captures == 1 and ev.n == 0
    torch.cuda.synchronize()
    assert float(x[0]) == 3.0
