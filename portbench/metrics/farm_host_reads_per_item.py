"""Device-to-host reads the farm makes an item (``FarmEngine.stats``:
host_reads / items), over the window and its drain."""


def read(ctx):
    s = ctx.get("stats", {})
    if not s.get("items"):
        return None
    return s["host_reads"] / s["items"]
