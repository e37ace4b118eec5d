"""The port's quickstart against the reference's: the same printed
integers (GoL generations and alive cells, the -d and -s iterations, the
farm's and the stream's trip counts and rounds), the port on the CPU
(backend "torch") and the reference on its CPU path.  The card's run is
held against a CPU run by ``chip_smoke.py`` phase 22(c)."""
import importlib.util
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def integers(text: str) -> list:
    """Every integer on the quickstart's lines, in order (the one float,
    max |Δ|, left out)."""
    text = re.sub(r"max \|Δ\| = \S+", "", text)
    return [int(x) for x in re.findall(r"(?<![\w.])\d+(?![\w.])", text)]


def test_quickstart_integers_equal_the_reference(capsys):
    from repro_torch.examples import quickstart
    got = quickstart.main(["--device", "cpu"])
    port_out = capsys.readouterr().out
    spec = importlib.util.spec_from_file_location(
        "reference_quickstart", ROOT / "examples" / "quickstart.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    ref.main()
    ref_out = capsys.readouterr().out
    assert integers(port_out) == integers(ref_out), (port_out, ref_out)
    assert got["gol"] == (200, 226) and got["stream"]["rounds"] == 3
    assert len(port_out.splitlines()) == len(ref_out.splitlines()) == 5


def test_quickstart_raises_without_a_card(monkeypatch):
    import torch
    from repro_torch.examples import quickstart
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        quickstart.main([])
