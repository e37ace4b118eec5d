"""Milliseconds an admission takes on the device: CUDA events around each
of the engine's admissions (the prompt's prefill at the pool width and the
slot write), averaged over the window's admissions."""


def read(ctx):
    return ctx.get("admit_ms")
