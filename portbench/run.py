"""Run one cell of the port's benchmark once.

    python portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, ``portbench/``
and the port (``src/repro_torch``), on a machine with at least as many
CUDA cards as the cell asks for.  With ``--trace 0`` the result's metrics
are the cell's end-to-end metrics; with ``--trace 1`` its per-layer
metrics, read from a profiled slice of the same window, with the device's
busy and window seconds and a breakdown.  The last line of standard output
is the result as one JSON object; the checks that decide ``correct`` end
standard error.  Without a card, or with fewer cards than the cell asks
for, or without the port, it prints no result and exits with a code other
than 0.
"""
import time

T0 = time.perf_counter()        # set-up is counted from here

import argparse  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent


def cache_dirs():
    """Every build and kernel cache inside the checkout, at fixed paths, so
    that only a checkout's first run builds."""
    build = REPO / "build"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv_compute_cache")):
        os.environ[var] = str(build / sub)


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def metric_values(bench_cell: dict, out: dict, trace: bool, root) -> dict:
    """The metrics of the result line: the cell's end-to-end metrics, or
    with ``trace`` its per-layer metrics that found something to read."""
    from portbench import spec
    metrics = {}
    if not trace:
        for m in bench_cell["end_to_end"]:
            v = out["e2e"].get(m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        return metrics
    for m in bench_cell["per_layer"]:
        v = spec.reader(m["name"], root).read(out["ctx"])
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    return metrics


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not (REPO / "src" / "repro_torch").is_dir():
        print("the port (src/repro_torch) is not in this checkout",
              file=sys.stderr)
        return 5
    cache_dirs()
    sys.path[:0] = [str(REPO), str(REPO / "src")]
    from portbench import report, spec

    bench_cell = spec.cell(args.workload)
    import torch
    torch.set_num_threads(spec.HOST_THREADS)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < bench_cell["chips"]:
        print(f"{args.workload} needs {bench_cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3

    out = spec.driver(bench_cell).run(
        bench_cell, args.seed, args.seconds, bool(args.trace),
        device="cuda", t0=T0)
    trace = bool(args.trace)
    metrics = metric_values(bench_cell, out, trace, spec.HERE)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": bench_cell["chips"],
              "memory_peak_bytes": int(out["memory_peak_bytes"]),
              "power_limit": power_limit()}
    breakdown = None
    if trace:
        s = out["trace"] or {"busy_s": 0.0, "window_s": 0.0,
                             "device_ops": [], "idle_gaps": []}
        device["busy_s"], device["window_s"] = s["busy_s"], s["window_s"]
        print(f"traced slice: {s.get('wall_s')} s of host clock, "
              f"{s['window_s']} s of events, {s['busy_s']} s busy",
              file=sys.stderr)
        breakdown = {"device_ops": s["device_ops"],
                     "idle_gaps": s["idle_gaps"]}
    checks = out["checks"]
    correct = all(report.passes(c) for c in checks)

    found = report.loaded_forbidden()
    if found:
        print("modules of JAX or of the JAX package are loaded: "
              + ", ".join(found), file=sys.stderr)
        return 4
    sys.stdout.flush()
    for line in report.checks_text(checks):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(report.result_line(correct=correct, attempted=out["attempted"],
                             failed=out["failed"], metrics=metrics,
                             device=device, checks=checks,
                             breakdown=breakdown))
    return 0


if __name__ == "__main__":
    sys.exit(main())
