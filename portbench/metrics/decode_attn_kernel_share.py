"""Share of the decode steps' cached attention calls that took the
hand-written decode kernel (``ContinuousEngine.stats``:
attn_decode_kernel / (attn_decode_kernel + attn_decode_einsum), steps ×
attention layers, replays included), over the window and its drain, in
percent.  A program without the counters reads nothing."""


def read(ctx):
    s = ctx.get("stats", {})
    kernel, einsum = s.get("attn_decode_kernel"), s.get("attn_decode_einsum")
    if kernel is None or einsum is None or not kernel + einsum:
        return None
    return 100.0 * kernel / (kernel + einsum)
