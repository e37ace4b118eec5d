"""Jobs of requests for a serving cell, made from the seed.

The traffic file gives a job's size and the distributions of prompt
lengths and token budgets.  Every job holds the same lengths and budgets,
the distribution's quantiles at (i + 0.5) / n, each job in orders drawn from
``order_seed`` (the same sequence of jobs for every seed), and token ids
drawn uniformly from the seed: the seed changes the tokens, not how much
work a job holds or in what order it comes.
"""
from __future__ import annotations

from statistics import NormalDist

import numpy as np


def quantiles(spec: dict, n: int) -> np.ndarray:
    """n whole numbers at the quantiles (i + 0.5) / n of ``spec``."""
    u = (np.arange(n) + 0.5) / n
    if spec["dist"] == "lognormal":
        z = np.array([NormalDist().inv_cdf(x) for x in u])
        v = spec["median"] * np.exp(spec["sigma"] * z)
        v = np.clip(v, *spec["clip"])
    elif spec["dist"] == "uniform":
        lo, hi = spec["range"]
        v = lo + u * (hi - lo)
    else:
        raise ValueError(f"unknown distribution {spec['dist']!r}")
    return np.rint(v).astype(np.int64)


def jobs(traffic: dict, vocab: int, seed: int):
    """Yield jobs: lists of (rid, prompt int32 array, budget)."""
    n = int(traffic["job"])
    lens = quantiles(traffic["prompt"], n)
    buds = quantiles(traffic["budget"], n)
    order = np.random.default_rng(int(traffic["order_seed"]))
    rng = np.random.default_rng(seed)
    rid = 0
    while True:
        lp, bp = order.permutation(lens), order.permutation(buds)
        job = []
        for L, b in zip(lp, bp):
            job.append((rid, rng.integers(2, vocab, int(L)).astype(np.int32),
                        int(b)))
            rid += 1
        yield job


def warmup_job(traffic: dict, vocab: int, seed: int) -> list:
    """The set-up's job: a few requests at the pool's width, so that the
    one binding, the prefill at the pool width and the captured decode
    step are made before the window."""
    w = traffic["warmup"]
    rng = np.random.default_rng(seed + 1)
    return [(-1 - i, rng.integers(2, vocab, int(traffic["pool_width"]))
             .astype(np.int32), int(w["budget"]))
            for i in range(int(w["requests"]))]
