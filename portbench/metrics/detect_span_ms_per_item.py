"""Device milliseconds of detection an item, from the program's own span:
the CUDA events of ``FarmEngine``'s ``farm.prep`` span (the farm's prep and
the write of its result into the staging ring), summed over the traced
slice and divided by their count."""


def read(ctx):
    s = ctx.get("stats", {})
    if not s.get("span_dev_n.farm.prep"):
        return None
    return s["span_dev_ms.farm.prep"] / s["span_dev_n.farm.prep"]
