"""The benchmark's files are found by name, and BENCHMARK.json keeps the
contract's shape."""
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import report, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = ["deepseek-moe-16b-chat", "deepseek-moe-16b-longprompt",
         "restore-1080p-light"]


@pytest.fixture(scope="module")
def bench():
    return spec.load_benchmark()


def test_cells_listed_in_order(bench):
    assert [w["name"] for w in bench["workloads"]] == CELLS
    assert spec.list_cells() == CELLS


@pytest.mark.parametrize("name", CELLS)
def test_cell_loads_by_name(name):
    c = spec.cell(name)
    assert c["config"]["driver"] in ("stream", "serve")
    assert hasattr(spec.driver(c), "run")
    assert hasattr(spec.generator(c), "__doc__")
    names = {m["name"] for m in c["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert c["per_layer"]
    for m in c["per_layer"]:
        assert callable(spec.reader(m["name"]).read)
        assert m["moves"] in names


def test_unknown_cell_raises():
    with pytest.raises(KeyError):
        spec.cell("no-such-cell")


def test_a_new_cell_is_new_files_alone(tmp_path, bench):
    """A cell added as a new configuration file, a new traffic file and
    a new entry is listed, with no file that was there edited."""
    root = tmp_path / "portbench"
    shutil.copytree(spec.HERE, root,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    cfg = json.loads((root / "configs" / "restore-1080p.json").read_text())
    cfg["frame"] = [2160, 3840]
    (root / "configs" / "restore-2160p.json").write_text(json.dumps(cfg))
    trf = json.loads(
        (root / "traffic" / "restore-1080p-light.json").read_text())
    trf["density"] = [0.30, 0.70]
    (root / "traffic" / "restore-2160p-mixed.json").write_text(
        json.dumps(trf))
    b = json.loads(json.dumps(bench))
    b["workloads"].append({"name": "restore-2160p-mixed",
                           "config": "restore-2160p",
                           "traffic": "restore-2160p-mixed", "chips": 1,
                           "why": "a dummy cell"})
    for m in b["end_to_end"] + b["per_layer"]:
        if "restore-1080p-light" in m.get("workloads", ()):
            m["workloads"].append("restore-2160p-mixed")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    assert spec.list_cells(root) == CELLS + ["restore-2160p-mixed"]
    c = spec.cell("restore-2160p-mixed", root)
    assert c["config"]["frame"] == [2160, 3840]
    assert all(p.read_bytes() == data for p, data in before.items())


def test_contract_shape(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"]
    assert bench["command"] == ["python3", "portbench/run.py"]
    rs = bench["run_seconds"]
    assert 1 <= rs <= 51
    # a full check of 24 cells fits its 43200 seconds
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    names = [c["name"] for c in bench["configs"]]
    cells = [w["name"] for w in bench["workloads"]]
    metrics = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    for n in names + cells + metrics:
        assert NAME.match(n), n
    assert len(set(names)) == len(names)
    assert len(set(cells)) == len(cells)
    assert len(set(metrics)) == len(metrics)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert Path(spec.REPO / c["file"]).is_file()
        assert c["file"].startswith("portbench/")
        assert 1 <= len(c["why"]) <= 200 and 1 <= len(c["source"]) <= 200
    pairs = {(w["config"], w["traffic"]) for w in bench["workloads"]}
    assert len(pairs) == len(cells)
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25 and m["bound"] >= 0.01
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    layers = {m["layer"] for m in bench["per_layer"]}
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert UNIT.match(m["unit"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert (spec.HERE / "metrics" / f"{m['name']}.py").is_file()
    assert len(layers) >= 5
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert set(m.get("workloads", cells)) <= set(cells)
    setup = [m for m in bench["end_to_end"] if m["name"] == "setup_s"][0]
    assert setup["bound"] <= 0.25 and "workloads" not in setup


@pytest.mark.parametrize("name", CELLS)
def test_every_moved_metric_is_reported_where_read(bench, name):
    c = spec.cell(name)
    e2e = {m["name"] for m in c["end_to_end"]}
    for m in c["per_layer"]:
        assert m["moves"] in e2e


def test_no_forbidden_imports_under_the_harness():
    """No file imports jax, jaxlib, flax or the JAX package (top-level
    names compared whole), and the references import nothing of the
    port."""
    for path in spec.HERE.rglob("*.py"):
        names = report.imported_names(path)
        assert not names & set(report.FORBIDDEN), (path, names)
        if path.parent.name == "reference":
            assert "repro_torch" not in names, path


def test_loaded_forbidden_compares_whole_names():
    assert report.loaded_forbidden({"repro_torch": 1, "repro_torch.serve": 1,
                                    "reproducible": 1}) == []
    assert report.loaded_forbidden({"repro.core": 1, "jax.numpy": 1,
                                    "flax": 1}) == ["flax", "jax", "repro"]


def _run(cwd, *args):
    return subprocess.run([sys.executable, "portbench/run.py", *args],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=120)


ARGS = ("--workload", "restore-1080p-light", "--seed", str(2**31 + 5),
        "--seconds", "1", "--trace", "0")


def test_run_without_a_card_prints_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    r = _run(spec.REPO, *ARGS)
    assert r.returncode != 0 and r.stdout == ""
    assert "CUDA card" in r.stderr


def test_run_without_the_port_prints_no_result(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's files
    is not enough to run."""
    shutil.copy(spec.REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = _run(tmp_path, *ARGS)
    assert r.returncode != 0 and r.stdout == ""
