"""The readers of the program's spans and counters: each reads the right
value from a run's ``stats`` and nothing where the program has no such key
(a program without spans) or counted nothing (tracing was off).  A small
CPU drive of each cell with the program's tracing on gives the host-side
readers a value and the device-side ones nothing (no CUDA event runs on
the CPU)."""
import time

import pytest
import torch

from portbench import spec
from portbench.tiny import tiny_cell

STREAM = {"span_dev_ms.farm.prep": 113.0, "span_dev_n.farm.prep": 10,
          "span_host_ms.farm.stage": 50.0, "span_host_ms.farm.emit": 30.0,
          "span_n.farm.emit": 8, "idle_ms.farm.check": 12.0,
          "idle_ms.farm.payload": 20.0, "idle_ms.farm.other": 0.5,
          "idle_ms.loop.exit_read": 1.5}
SERVE = {"span_dev_ms.serve.admit": 760.0, "span_dev_n.serve.admit": 4,
         "span_n.serve.admit": 4, "span_dev_ms.serve.segment": 1464.0,
         "span_dev_n.serve.segment": 3, "span_dev_n.loop.step": 20,
         "span_n.loop.step": 20, "idle_ms.serve.segment": 1.0,
         "idle_ms.loop.step": 0.5, "idle_ms.loop.exit_read": 6.5,
         "idle_ms.serve.drain": 40.0, "span_dev_ms.moe.route": 10.0,
         "span_dev_n.moe.route": 108, "span_dev_ms.moe.dispatch": 20.0,
         "span_dev_ms.moe.experts": 200.0, "span_dev_ms.moe.combine": 30.0,
         "span_dev_ms.moe.shared": 40.0, "graph_captures": 0}

CASES = [
    ("detect_span_ms_per_item", STREAM, 11.3, "span_dev_n.farm.prep"),
    ("farm_host_ms_per_item", STREAM, 10.0, "span_n.farm.emit"),
    ("farm_idle_ms_per_item", STREAM, 34.0 / 8, "span_n.farm.emit"),
    ("admit_span_ms_per_request", SERVE, 190.0, "span_dev_n.serve.admit"),
    ("decode_span_ms_per_step", SERVE, 73.2, "span_dev_n.loop.step"),
    ("serve_idle_ms_per_step", SERVE, 0.4, "span_n.loop.step"),
    ("admit_moe_ms_per_request", SERVE, 75.0, "span_n.serve.admit"),
]
NAMES = [c[0] for c in CASES] + ["serve_graph_captures"]


def read(name, stats):
    return spec.reader(name).read({"stats": stats, "window_s": 51.0})


@pytest.mark.parametrize("name,stats,want,count", CASES)
def test_a_reader_reads_its_span(name, stats, want, count):
    assert read(name, stats) == pytest.approx(want)
    assert read(name, dict(stats, **{count: 0})) is None


@pytest.mark.parametrize("name", NAMES)
def test_a_reader_reads_nothing_without_its_keys(name):
    assert read(name, {}) is None
    assert read(name, {"items": 10, "host_reads": 72}) is None
    assert spec.reader(name).read({}) is None


def test_the_captures_reader_reads_the_window_count():
    assert read("serve_graph_captures", SERVE) == 0
    assert read("serve_graph_captures", dict(SERVE, graph_captures=2)) == 2


@pytest.fixture
def tracing():
    from repro_torch import obs
    obs.enable()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    obs.enable(False)


@pytest.mark.parametrize("cell,host,device", [
    ("restore-1080p-light", ["farm_host_ms_per_item", "farm_idle_ms_per_item"],
     ["detect_span_ms_per_item"]),
    ("deepseek-moe-16b-chat", ["serve_idle_ms_per_step",
                               "serve_graph_captures"],
     ["admit_span_ms_per_request", "decode_span_ms_per_step",
      "admit_moe_ms_per_request"]),
])
def test_a_traced_cpu_drive_feeds_the_host_readers(tracing, cell, host,
                                                   device):
    c = tiny_cell(cell)
    out = spec.driver(c).run(c, 2**31 + 77, 1.0, False, device="cpu",
                             t0=time.perf_counter())
    for name in host:
        assert read(name, out["ctx"]["stats"]) is not None, name
    for name in device:
        assert read(name, out["ctx"]["stats"]) is None, name
    assert read("serve_graph_captures", out["ctx"]["stats"]) in (0, None)
