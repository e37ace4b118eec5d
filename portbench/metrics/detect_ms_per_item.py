"""Device milliseconds of detection an item: CUDA events around each call
of the farm's ``prep`` (adaptive-median detection), averaged over the
window's items."""


def read(ctx):
    ms = ctx.get("detect_ms") or []
    return sum(ms) / len(ms) if ms else None
