"""Find a cell's configuration, traffic, driver and metric readers by name.

A cell is one entry of ``workloads`` in ``BENCHMARK.json``.  Its
configuration lives in ``configs/<config>.json`` and its traffic in
``traffic/<traffic>.json``; the configuration's ``driver`` names
``drivers/<driver>.py`` and the traffic's ``generator`` names
``traffic/<generator>.py``.  A per-layer metric ``m`` is read by
``metrics/<m>.py``.  A later cell, configuration or metric is added as new
files and new entries; no file here names one.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent          # portbench/
REPO = HERE.parent                              # the checkout's root
# intra-op threads of a run's process: the stream cells are bound by the
# host, which the card's machine shares, and host operations split over
# every core wait on the busiest one (load from one process, few threads)
HOST_THREADS = 2


def load_benchmark(repo: Path = REPO) -> dict:
    with open(Path(repo) / "BENCHMARK.json") as f:
        return json.load(f)


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """Import the file ``path`` as a module called ``name`` (metric files
    carry dots in their names, so they are loaded by path)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_of(bench: dict, cell: str, section: str) -> list:
    """The entries of ``bench[section]`` that the cell reports: those with
    no ``workloads`` key and those whose ``workloads`` list it."""
    return [m for m in bench[section]
            if "workloads" not in m or cell in m["workloads"]]


def cell(name: str, root: Path = HERE, bench: dict | None = None) -> dict:
    """Everything one cell needs, found by name under ``root``: its
    workload entry, configuration, traffic, and the metrics it reports."""
    bench = bench if bench is not None else load_benchmark(Path(root).parent)
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        raise KeyError(f"no cell named {name!r} in BENCHMARK.json")
    w = entries[0]
    root = Path(root)
    config = _read_json(root / "configs" / f"{w['config']}.json")
    traffic = _read_json(root / "traffic" / f"{w['traffic']}.json")
    return {"name": name, "chips": int(w["chips"]), "workload": w,
            "config": config, "traffic": traffic,
            "end_to_end": metrics_of(bench, name, "end_to_end"),
            "per_layer": metrics_of(bench, name, "per_layer"),
            "root": str(root)}


def driver(c: dict):
    """The module that runs the cell's kind of system."""
    root = Path(c["root"])
    d = c["config"]["driver"]
    return load_module(root / "drivers" / f"{d}.py", f"portbench_driver_{d}")


def generator(c: dict):
    """The module that turns the cell's traffic file into inputs."""
    root = Path(c["root"])
    g = c["traffic"]["generator"]
    return load_module(root / "traffic" / f"{g}.py",
                       f"portbench_traffic_{g}")


def reader(name: str, root: Path = HERE):
    """``read(ctx)`` of the per-layer metric ``name``."""
    path = Path(root) / "metrics" / f"{name}.py"
    return load_module(path, "portbench_metric_" + name.replace(".", "_"))


def list_cells(root: Path = HERE, bench: dict | None = None) -> list:
    """The cells whose configuration, traffic, driver, generator and
    per-layer readers are all present under ``root``, in the order of
    ``BENCHMARK.json``."""
    bench = bench if bench is not None else load_benchmark(Path(root).parent)
    root = Path(root)
    out = []
    for w in bench["workloads"]:
        cfg = root / "configs" / f"{w['config']}.json"
        trf = root / "traffic" / f"{w['traffic']}.json"
        if not (cfg.is_file() and trf.is_file()):
            continue
        drv = root / "drivers" / f"{_read_json(cfg)['driver']}.py"
        gen = root / "traffic" / f"{_read_json(trf)['generator']}.py"
        readers = [root / "metrics" / f"{m['name']}.py"
                   for m in metrics_of(bench, w["name"], "per_layer")]
        if drv.is_file() and gen.is_file() and all(
                r.is_file() for r in readers):
            out.append(w["name"])
    return out
