"""Production training entry point (twin of :mod:`repro.launch.train`).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
        [--steps 100] [--reduced] [--dry-run] [--pod-shape 32,8] [--device cpu]

Modes:
    --dry-run    price the full-scale train cell on the production mesh on
                 the meta device (:func:`repro_torch.launch.dryrun.run_cell`)
                 and print its memory / roofline summary — the
                 cluster-submission check.
    --reduced    train the reduced config (CPU-runnable end to end, with
                 checkpointing when ``--ckpt-dir`` is given).
Without either, the full-size config trains on one device.  Runs on the
CUDA card unless ``--device cpu`` is given.  Exit code 0 when every step
ran with no fault and a finite loss.
"""
from __future__ import annotations

import argparse
import math
import signal
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--dry-run", action="store_true")
    ap.add_argument("--pod-shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' when asked")
    args = ap.parse_args(argv)

    from ..device import resolve_device
    device = resolve_device(args.device)
    if args.dry_run:
        from . import dryrun
        pod_shape = (tuple(int(x) for x in args.pod_shape.split(","))
                     if args.pod_shape else None)
        rec = dryrun.run_cell(args.arch, args.shape,
                              "multipod" if args.multi_pod else "pod",
                              out_dir="runs/dryrun_cli_torch", force=True,
                              pod_shape=pod_shape, device=device)
        return 0 if rec.get("ok") else 1

    from ..configs import get_config, get_reduced
    from ..data import SyntheticLM
    from ..models import transformer as T
    from ..optim import AdamW, cosine_with_warmup
    from ..train import TrainConfig, Trainer

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=args.seq,
                       global_batch=args.batch, seed=0)
    params = T.init_params(cfg, seed=0, max_position=args.seq,
                           device=device)
    opt = AdamW(lr=cosine_with_warmup(args.lr, max(args.steps // 10, 1),
                                      args.steps), weight_decay=0.01)
    trainer = Trainer(cfg, TrainConfig(
        steps=args.steps, ckpt_dir=args.ckpt_dir, log_every=10), opt,
        device=device)
    prev = trainer.install_preemption_handler()
    try:
        _, _, info = trainer.run(params, lambda s: data.batches(s))
    finally:
        for sig, handler in prev.items():
            signal.signal(sig, handler)
    h = info["history"]
    print(f"[launch.train] {cfg.name}: {info['steps']} steps, "
          f"{info['faults']} faults, loss "
          f"{' -> '.join(repr(x) for x in h[:1] + h[-1:])}")
    ok = (info["steps"] == args.steps and info["faults"] == 0 and h
          and math.isfinite(h[-1]))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
