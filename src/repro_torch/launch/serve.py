"""Production serving entry point (twin of :mod:`repro.launch.serve`).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
        [--reduced] [--dry-run --shape decode_32k] [--device cpu]

``--dry-run`` prices the full-scale decode / prefill cell on the
production mesh on the meta device; otherwise the reduced config serves
batched requests (as the reference, with or without ``--reduced``)
through ``generate``'s Loop-of-stencil-reduce decode loop.  Runs on the
CUDA card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="decode_32k")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--dry-run", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' when asked")
    args = ap.parse_args(argv)

    from ..device import resolve_device
    device = resolve_device(args.device)
    if args.dry_run:
        from . import dryrun
        rec = dryrun.run_cell(args.arch, args.shape,
                              "multipod" if args.multi_pod else "pod",
                              out_dir="runs/dryrun_cli_torch", force=True,
                              device=device)
        return 0 if rec.get("ok") else 1

    import numpy as np
    import torch
    from ..configs import get_reduced
    from ..models import transformer as T
    from ..serve import GenerateConfig, generate

    cfg = get_reduced(args.arch)
    params = T.init_params(cfg, seed=0, device=device)
    rng = np.random.default_rng(0)
    prompt = torch.as_tensor(rng.integers(2, cfg.vocab_size,
                                          (args.batch, 8)), device=device)
    gcfg = GenerateConfig(max_new_tokens=args.max_new, eos_id=1,
                          temperature=0.7)
    t0 = time.perf_counter()
    out, lengths, iters = generate(cfg, params, prompt, gcfg,
                                   cache_dtype=torch.float32, device=device)
    total = int(lengths.sum())
    print(f"[launch.serve] {cfg.name} (reduced): {total} tokens in "
          f"{time.perf_counter() - t0:.2f}s over {args.batch} requests "
          f"({int(iters)} decode steps)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
