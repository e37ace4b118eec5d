"""Milliseconds of the device's timeline a decode step takes, from the
program's own spans: the CUDA events of ``ContinuousEngine``'s
``serve.segment`` spans, summed over the traced slice and divided by the
``loop.step`` spans that timed a step inside them."""


def read(ctx):
    s = ctx.get("stats", {})
    if not s.get("span_dev_n.loop.step") \
            or not s.get("span_dev_n.serve.segment"):
        return None
    return s["span_dev_ms.serve.segment"] / s["span_dev_n.loop.step"]
