"""Readings for the limits that decide ``correct``, over many seeds in one
process.

    python portbench/calibrate.py --workload <cell> --seeds 1,2,3 --seconds 10 [--control]

For each seed the cell's driver runs as ``run.py`` runs it (set-up, a
window of ``--seconds``, the comparison with the plain reference), and one
JSON line reports the numbers compared; with ``--control`` also the
control's readings: the reference itself in the precision below the
configuration's (bfloat16 frames for the restoration stream, float8
products for a served model), which the limits must fail.  The
benchmark's own runs never run the control.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(REPO), str(REPO / "src")]
    from portbench import spec

    import torch
    torch.set_num_threads(spec.HOST_THREADS)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 3
    c = spec.cell(args.workload)
    drv = spec.driver(c)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        out = drv.run(c, seed, args.seconds, False, device="cuda", t0=t0,
                      control=args.control)
        line = {"workload": args.workload, "seed": seed,
                "checks": {k["name"]: k["value"] for k in out["checks"]},
                "e2e": out["e2e"], "attempted": out["attempted"],
                "memory_peak_bytes": out["memory_peak_bytes"],
                "seconds": time.perf_counter() - t0}
        if out.get("readings"):
            line["readings"] = out["readings"]
        if out["control"] is not None:
            line["control"] = {k["name"]: k["value"] for k in out["control"]}
        print(json.dumps(line), flush=True)
        del out
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
