"""Device milliseconds an admission takes, from the program's own span:
the CUDA events of ``ContinuousEngine``'s ``serve.admit`` span (the
prefill at the pool width and the slot write), over the traced slice."""


def read(ctx):
    s = ctx.get("stats", {})
    if not s.get("span_dev_n.serve.admit"):
        return None
    return s["span_dev_ms.serve.admit"] / s["span_dev_n.serve.admit"]
