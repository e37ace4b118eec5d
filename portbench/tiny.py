"""A cell cut to a size a CPU test run can hold, for the harness's tests.

The cell's files are loaded by name as a run loads them; only its sizes
change: a few tiny frames on two lanes on the ``"torch"`` backend, or the
served model at the port's reduced widths (``configs.base.shrink``) with a
handful of slots at a short pool width.  What is compared and how stay the
cell's own.  The reduced model is another configuration, with a limit of
its own set from its readings: sound runs read a mean gap of 4e-5 to 1e-3,
its float8 control 0.05 to 0.11, so 0.02.
"""
from __future__ import annotations

import copy

from portbench import spec

# the port's reduced deepseek-moe-16b (configs/base.py shrink), in the
# configuration file's key names
REDUCED_MOE = dict(hidden_size=64, num_hidden_layers=3, num_attention_heads=4,
                   num_key_value_heads=4, intermediate_size=160,
                   moe_intermediate_size=48, n_routed_experts=4,
                   num_experts_per_tok=2, n_shared_experts=1, vocab_size=736)


def tiny_cell(name: str, backend: str = "torch") -> dict:
    c = copy.deepcopy(spec.cell(name))
    cfg, trf = c["config"], c["traffic"]
    if cfg["driver"] == "stream":
        cfg["frame"] = [24, 40]
        cfg["engine"].update(lanes=2, segment=4, backend=backend)
        trf.update(distinct=4, warmup_items=2)
    else:
        cfg.update(REDUCED_MOE)
        trf.update(slots=4, pool_width=32, cap=8, job=8,
                   prompt={"dist": "uniform", "range": [4, 32]},
                   budget={"dist": "uniform", "range": [2, 8]},
                   warmup={"requests": 1, "budget": 4}, check_requests=4)
        cfg["limits"] = dict(cfg["limits"], token_gap_mean=0.02)
    cfg["trace_seconds"] = 0.5
    return c
