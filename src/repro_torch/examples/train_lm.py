"""End-to-end training on the port: an LM on the synthetic task.

Twin of ``examples/train_lm.py`` with the same presets and flags, plus
``--device`` (default the CUDA card; the CPU only when asked): config →
model → data pipeline → AdamW → Trainer (the Loop-of-stencil-reduce-s
pattern with checkpoint/restart and NaN rollback).

    PYTHONPATH=src python -m repro_torch.examples.train_lm --preset tiny --steps 40 --device cpu
    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 300   # ~100M run, on the card

Resume: re-running with the same --ckpt-dir picks up at the last step
(the checkpoint format is the reference's, so either package's run
resumes the other's).
"""
from __future__ import annotations

import argparse
import signal

from repro_torch.configs.base import ArchConfig
from repro_torch.data import SyntheticLM
from repro_torch.models import transformer as T
from repro_torch.optim import AdamW, cosine_with_warmup
from repro_torch.train import TrainConfig, Trainer

PRESETS = {
    # ~110M params: a qwen3-shaped dense decoder
    "100m": ArchConfig(
        name="demo-100m", family="dense", num_layers=12, d_model=768,
        num_heads=12, num_kv_heads=4, head_dim=64, d_ff=3072,
        vocab_size=32768, qk_norm=True, act="silu", dtype="float32",
        remat=False),
    "tiny": ArchConfig(
        name="demo-tiny", family="dense", num_layers=4, d_model=128,
        num_heads=4, num_kv_heads=2, head_dim=32, d_ff=512,
        vocab_size=2048, act="silu", dtype="float32", remat=False),
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", choices=list(PRESETS), default="100m")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="runs/train_lm")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    cfg = PRESETS[args.preset]
    params = T.init_params(cfg, seed=0, device=args.device)
    n_params = sum(p.numel() for p in params.parameters())
    print(f"[train_lm] {cfg.name}: {n_params / 1e6:.1f}M params, "
          f"{args.steps} steps, batch {args.batch}x{args.seq}")

    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=args.seq,
                       global_batch=args.batch, seed=0)
    opt = AdamW(lr=cosine_with_warmup(args.lr, args.steps // 10,
                                      args.steps), weight_decay=0.01)
    trainer = Trainer(cfg, TrainConfig(
        steps=args.steps, accum=args.accum, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, log_every=10), opt, device=args.device)
    prev = trainer.install_preemption_handler()
    try:
        params, opt_state, info = trainer.run(params,
                                              lambda s: data.batches(s))
    finally:
        for sig, handler in prev.items():
            signal.signal(sig, handler)
    h = info["history"]
    if h:
        print(f"[train_lm] loss {h[0]:.3f} -> {h[-1]:.3f} over "
              f"{info['steps']} steps ({info['faults']} faults)")
    return info


if __name__ == "__main__":
    main()
