"""The device's idle share of a traced slice, shared by the
``device_idle_share.*`` metrics."""


def share(ctx):
    s = ctx.get("trace")
    if not s or s["window_s"] <= 0 or s["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
