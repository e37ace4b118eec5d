"""Milliseconds the device sat idle a decode step inside the engine's
segments: the idle ``ContinuousEngine`` puts down to ``serve.segment``,
``loop.step`` and ``loop.exit_read`` (the host's read of the exit test a
step), over the traced slice, divided by its decode steps."""

SPANS = ("serve.segment", "loop.step", "loop.exit_read")


def read(ctx):
    s = ctx.get("stats", {})
    if not s.get("span_n.loop.step") \
            or any(f"idle_ms.{n}" not in s for n in SPANS):
        return None
    return sum(s[f"idle_ms.{n}"] for n in SPANS) / s["span_n.loop.step"]
