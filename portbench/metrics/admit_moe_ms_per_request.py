"""Device milliseconds of the MoE layers an admission: the CUDA events of
the ``moe.*`` spans (router, dispatch, experts, combine, shared experts;
eager work only, so the admission prefill's) over the traced slice,
divided by the admissions there."""


def read(ctx):
    s = ctx.get("stats", {})
    if not s.get("span_n.serve.admit") or not s.get("span_dev_n.moe.route"):
        return None
    return sum(v for k, v in s.items() if k.startswith("span_dev_ms.moe.")
               ) / s["span_n.serve.admit"]
