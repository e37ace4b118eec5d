"""The result line, the checks beside their limits, and the import scan.

The last line of a run's standard output is one JSON object with the keys
``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each number the
correctness comparison made, with its limit.  The same checks end standard
error, one a line.
"""
from __future__ import annotations

import ast
import json
import math
import sys
from pathlib import Path

# top-level module names the benchmark's process may not hold: JAX, its
# libraries, and the JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0-100) of ``values`` by linear
    interpolation between order statistics (numpy's default)."""
    xs = sorted(float(v) for v in values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def loaded_forbidden(modules=None) -> list:
    """Forbidden top-level names among ``modules`` (default: this
    process's ``sys.modules``), compared whole: ``repro_torch`` is not
    ``repro``."""
    names = sys.modules if modules is None else modules
    return sorted({top_level(n) for n in names} & set(FORBIDDEN))


def imported_names(path: Path) -> set:
    """Top-level names of every module a Python file imports (absolute
    imports; a relative import stays inside its package)."""
    tree = ast.parse(Path(path).read_text(), filename=str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(top_level(a.name) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            out.add(top_level(node.module))
    return out


def check(name: str, value, limit, kind: str = "max") -> dict:
    """One number the comparison made: ``value`` must not exceed
    ``limit`` (``kind="max"``) or must reach it (``kind="min"``)."""
    return {"name": name, "value": value, "limit": limit, "kind": kind}


def passes(c: dict) -> bool:
    v, lim = c["value"], c["limit"]
    if v is None or (isinstance(v, float) and not math.isfinite(v)):
        return False
    return v <= lim if c["kind"] == "max" else v >= lim


def checks_text(checks: list) -> list:
    """One plain line a check: name, value, limit."""
    sign = {"max": "<=", "min": ">="}
    return [f"check {c['name']} = {c['value']!r} (limit {sign[c['kind']]} "
            f"{c['limit']!r}): {'pass' if passes(c) else 'FAIL'}"
            for c in checks]


def result_line(*, correct: bool, attempted: int, failed: int,
                metrics: dict, device: dict, checks: list,
                breakdown=None) -> str:
    """The result's JSON line; ``checks`` comes last."""
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                     for c in checks}
    return json.dumps(out)
