"""Milliseconds the device sat idle an item, as the farm puts it down to
its spans: the sum of ``FarmEngine``'s ``idle_ms.*`` over the traced slice,
divided by the items emitted there."""


def read(ctx):
    s = ctx.get("stats", {})
    if not s.get("span_n.farm.emit"):
        return None
    return sum(v for k, v in s.items()
               if k.startswith("idle_ms.")) / s["span_n.farm.emit"]
