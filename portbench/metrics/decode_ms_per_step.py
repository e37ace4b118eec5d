"""Milliseconds of the device's timeline a decode step takes: CUDA events
around each of the engine's segments, summed and divided by the segments'
steps (a replayed step with the host's read of its done flags)."""


def read(ctx):
    return ctx.get("decode_ms")
