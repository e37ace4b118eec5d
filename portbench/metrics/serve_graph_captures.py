"""Captures of the engine's decode step inside the window
(``ContinuousEngine.stats["graph_captures"]``): a capture there is the
step's CUDA graph built again."""


def read(ctx):
    return ctx.get("stats", {}).get("graph_captures")
