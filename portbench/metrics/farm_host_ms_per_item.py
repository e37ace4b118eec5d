"""Host milliseconds the farm spends an item outside its segments: the
host time of ``FarmEngine``'s ``farm.stage`` spans (pull, finite check,
upload, prep) and ``farm.emit`` spans (the result's pull, the sink), over
the traced slice, divided by the items emitted there."""


def read(ctx):
    s = ctx.get("stats", {})
    if not s.get("span_n.farm.emit"):
        return None
    return (s["span_host_ms.farm.stage"]
            + s["span_host_ms.farm.emit"]) / s["span_n.farm.emit"]
