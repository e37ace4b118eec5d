"""The whole serving step's share of the card's bf16 peak over the window,
in percent: the useful model FLOPs of the window's work (``counts/lm.py``:
the real prompt tokens and decode steps of every request completed in it or
evicted when it closed, attention at real lengths, pads not counted) over
the window's seconds times 989 TFLOP/s."""
from portbench.counts import lm, peaks


def read(ctx):
    served = ctx.get("served")
    if not served:
        return None
    flops = sum(lm.request_flops(ctx["config"], p, g) for p, g in served)
    return 100.0 * flops / (ctx["window_s"] * peaks.BF16_FLOPS)
