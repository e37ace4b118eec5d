"""Serving example on the port: batched generation with the decode loop as
Loop-of-stencil-reduce-s (KV caches resident on the device), on a reduced
config with random weights from a seed.

Twin of ``examples/serve_lm.py``, with the same flags and ``--device``
(default the CUDA card; the CPU only when asked):

    PYTHONPATH=src python -m repro_torch.examples.serve_lm --device cpu

``--continuous`` serves ragged prompts through continuous batching
(per-sequence KV-slot refill, mid-batch emission): requests with different
prompt lengths and token budgets stream through one engine binding of
``--batch`` slots and print in completion order.

``--recover-dir <dir>`` arms preemption recovery on the continuous path
(journal + per-segment snapshots); ``--resume`` restarts a killed serve
from that directory, even with another ``--batch``:

    PYTHONPATH=src python -m repro_torch.examples.serve_lm --continuous \\
        --device cpu --recover-dir /tmp/serve_rec           # kill it...
    PYTHONPATH=src python -m repro_torch.examples.serve_lm --continuous \\
        --device cpu --recover-dir /tmp/serve_rec --resume  # ...it ends
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_reduced
from repro_torch.models import transformer as T
from repro_torch.serve import Batcher, GenerateConfig, Request, generate


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--continuous", action="store_true",
                    help="continuous batching: per-sequence KV-slot "
                         "refill, results in completion order")
    ap.add_argument("--requests", type=int, default=8,
                    help="request count for --continuous (> --batch "
                         "slots, so slots get reused mid-batch)")
    ap.add_argument("--recover-dir", default=None,
                    help="arm preemption recovery (journal + snapshots) on "
                         "the continuous path")
    ap.add_argument("--resume", action="store_true",
                    help="resume a killed --continuous run from "
                         "--recover-dir (replays + continues; submits "
                         "nothing new)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    if args.resume and not args.recover_dir:
        ap.error("--resume needs --recover-dir")
    recovery = None
    if args.recover_dir:
        from repro_torch.resilience import RecoveryConfig, load_snapshot
        recovery = RecoveryConfig(dir=args.recover_dir)
        if args.resume:
            # the snapshot's token cap sizes the decode buffers: adopt it
            st = load_snapshot(recovery.snap_dir)
            if st is not None and st.get("kind") == "serve":
                args.max_new = int(st["cap"])

    dev = torch.device(args.device)
    cfg = get_reduced(args.arch)
    params = T.init_params(cfg, seed=0, device=dev)
    rng = np.random.default_rng(0)
    gcfg = GenerateConfig(max_new_tokens=args.max_new, eos_id=1,
                          temperature=args.temperature, seed=0)

    if args.continuous:
        b = Batcher(cfg, params, gcfg, max_batch=args.batch,
                    cache_dtype=torch.float32, device=dev)
        budgets = [max(1, (i * 7) % args.max_new + 1)
                   for i in range(args.requests)]
        # ragged prompts: one slot pool serves every length
        plens = [max(2, (args.prompt_len - 3 * i) % args.prompt_len + 1)
                 for i in range(args.requests)]
        if not args.resume:      # a resumed run takes its requests from
            for i, bud in enumerate(budgets):  # the snapshot
                b.submit(Request(rid=i, max_new_tokens=bud,
                                 prompt=np.asarray(rng.integers(
                                     2, cfg.vocab_size, plens[i]),
                                     np.int32)))
        t0 = time.perf_counter()
        results = b.run_continuous(recovery=recovery, resume=args.resume)
        dt = time.perf_counter() - t0
        eng = b.engines[0]
        total = sum(len(r.tokens) for r in results)
        print(f"[serve_lm] {args.arch} (reduced, continuous, {dev}): "
              f"{len(results)} ragged requests through {args.batch} KV "
              f"slots (one engine binding) in {dt:.2f}s "
              f"({total / dt:.1f} tok/s, {eng.stats['segments']} segments, "
              f"{eng.stats['prefills']} slot prefills, "
              f"{eng.stats['idle_slot_steps']} idle slot-steps)")
        if args.resume:
            print(f"[serve_lm] resumed: {eng.stats['replayed_items']} "
                  f"replayed from the journal, "
                  f"{eng.stats['recovered_occupants']} decodes continued "
                  f"mid-generation, recovery took "
                  f"{eng.stats['recovery_seconds']:.3f}s")
        for r in results:           # completion order
            print(f"  rid{r.rid} prompt={plens[r.rid]} "
                  f"budget={budgets[r.rid]} len={len(r.tokens)} "
                  f"{r.status}: {r.tokens[:8].tolist()}...")
        return

    prompt = rng.integers(2, cfg.vocab_size, (args.batch, args.prompt_len))
    t0 = time.perf_counter()
    out, lengths, iters = generate(cfg, params, prompt, gcfg,
                                   cache_dtype=torch.float32, device=dev)
    lengths = lengths.tolist()
    dt = time.perf_counter() - t0
    total = sum(lengths)
    print(f"[serve_lm] {args.arch} (reduced, {dev}): generated {total} "
          f"tokens over {args.batch} sequences in {dt:.2f}s "
          f"({total / dt:.1f} tok/s, {int(iters)} loop steps)")
    for i in range(args.batch):
        print(f"  seq{i} len={lengths[i]}: "
              f"{out[i, :min(lengths[i], 12)].tolist()}...")


if __name__ == "__main__":
    main()
