"""Driver of a served language model: jobs of requests through the port's
``ContinuousEngine``.

Set-up builds the model's parameter tree on the meta device, gives it
weights drawn on the card from the seed (``weights.py``), builds the engine
as the configuration and the traffic state it (slots, pool width, token
cap, segment, KV cache dtype, greedy decoding), and serves one small job at
the pool's width, so that the one binding, the prefill and the captured
decode step exist before the window.

The window hands jobs to ``engine.run`` one after another, a batch
endpoint's clients.  Every request carries the window's end as its
deadline: at the first segment boundary past it the engine evicts what is
decoding, with the tokens it has, and sheds what is queued.  Those requests
count neither as attempted nor as completed, but the tokens they were given
count as the window's work, over the time up to that boundary.  A request's
latency runs from its job's hand-off to its emission.

Correctness: once the window has closed and the engine is freed, a sample
of the requests completed in it, drawn from the seed and holding the one
with the most tokens, is run through the plain reference
(``reference/moe_lm.py``, float32) over its prompt and served tokens; the
number compared is the mean, over the sample's served positions, of the gap
by which a served token's logit lies below the reference's best at its
position (``token_gap_mean``; the widest gap does not separate sound runs
from the float8 control on random weights, PERF.md §2).
"""
from __future__ import annotations

import dataclasses
import gc
import time

import numpy as np
import torch

from portbench import report, spec, weights
from portbench.reference import moe_lm
from portbench.trace import Slice

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def arch_config(cfg: dict):
    """The port's ``ArchConfig`` for the configuration file (Hugging Face
    keys), on top of the port's registered config of ``cfg["arch"]``."""
    from repro_torch.configs import get_config

    if not cfg["norm_topk_prob"] or cfg["scoring_func"] != "softmax" \
            or cfg["moe_layer_freq"] != 1 or cfg["first_k_dense_replace"] \
            != 1 or cfg["attention_bias"]:
        raise ValueError(f"{cfg['name']}: the port's MoE stack runs softmax "
                         "routing with renormalised top-k weights, one "
                         "leading dense layer, a MoE every layer after it, "
                         "and no attention bias")
    H = cfg["num_attention_heads"]
    return dataclasses.replace(
        get_config(cfg["arch"]),
        num_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        num_heads=H, num_kv_heads=cfg["num_key_value_heads"],
        head_dim=cfg.get("head_dim") or cfg["hidden_size"] // H,
        d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"],
        n_experts=cfg["n_routed_experts"],
        top_k=cfg["num_experts_per_tok"],
        n_shared_experts=cfg["n_shared_experts"],
        expert_d_ff=cfg["moe_intermediate_size"],
        shared_d_ff=cfg["n_shared_experts"] * cfg["moe_intermediate_size"],
        first_dense=True, act=cfg["hidden_act"], rope_theta=cfg["rope_theta"],
        tie_embeddings=cfg["tie_word_embeddings"],
        norm_eps=cfg["rms_norm_eps"], dtype=cfg["torch_dtype"])


class Timed:
    """CUDA events around each call of an engine method (traced runs on
    the card only); ``steps`` reads a segment's step count."""

    def __init__(self, fn, steps=None):
        self.fn, self.steps = fn, steps
        self.events = []

    def __call__(self, *args):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        out = self.fn(*args)
        b.record()
        self.events.append((a, b, self.steps(out) if self.steps else 1))
        return out

    def per_unit_ms(self):
        units = sum(u for _, _, u in self.events)
        if not units:
            return None
        return sum(a.elapsed_time(b) for a, b, _ in self.events) / units


def requests(job, deadline):
    from repro_torch.serve import Request
    return [Request(rid=rid, prompt=p, max_new_tokens=b, deadline=deadline)
            for rid, p, b in job]


def run(c: dict, seed: int, seconds: float, trace: bool, *, device="cuda",
        t0: float, control: bool = False) -> dict:
    from repro_torch.models import transformer as T
    from repro_torch.serve import ContinuousEngine, GenerateConfig

    cfg, traffic = c["config"], c["traffic"]
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    acfg = arch_config(cfg)
    model = T.init_params(acfg, device="meta")
    w = weights.materialize(model, seed, dev)
    sv = cfg["serving"]
    gcfg = GenerateConfig(max_new_tokens=int(traffic["cap"]),
                          eos_id=int(sv["eos_id"]),
                          temperature=float(sv["temperature"]), seed=0)
    eng = ContinuousEngine(acfg, model, gcfg, slots=int(traffic["slots"]),
                           cache_dtype=DTYPES[sv["cache_dtype"]],
                           segment=int(sv["segment"]),
                           max_prompt_len=int(traffic["pool_width"]),
                           device=dev)
    gen = spec.generator(c)
    V = cfg["vocab_size"]
    Slice(trace).prime()
    eng.run(requests(gen.warmup_job(traffic, V, seed), None),
            lambda *a: None)
    if cuda:
        torch.cuda.synchronize(dev)
    stats0 = dict(eng.stats)
    timed = trace and cuda
    if timed:
        eng._admit_slot = Timed(eng._admit_slot)
        eng._segment_core = Timed(eng._segment_core, steps=lambda o: o[1])

    sent = {}                     # rid -> (prompt, hand-off time)
    out = []                      # (rid, t, tokens, status)
    t_start = time.perf_counter()
    t_end = t_start + seconds
    tslice = Slice(trace, t_start + (seconds - cfg["trace_seconds"]) / 2,
                   t_start + (seconds + cfg["trace_seconds"]) / 2)

    def emit(rid, tokens, status):
        out.append((rid, time.perf_counter(), tokens, status))

    jobs = gen.jobs(traffic, V, seed)
    while time.perf_counter() < t_end:
        job = next(jobs)
        now = time.perf_counter()
        for rid, p, _ in job:
            sent[rid] = (p, now)
        eng.run(requests(job, t_end), emit, clock=time.perf_counter,
                on_segment=lambda k: tslice.tick(time.perf_counter()))
    tslice.stop()
    if cuda:
        torch.cuda.synchronize(dev)
    stats = {k: eng.stats[k] - stats0[k] for k in stats0
             if isinstance(stats0[k], (int, float))}

    # the window closes at the first segment boundary at or after t_end:
    # there the engine evicts every occupant, its deadline passed, with
    # the tokens it has, and sheds the queue; every token generated before
    # that boundary counts, over the time up to it
    t_close = max([t_end] + [o[1] for o in out])
    window = t_close - t_start
    ok = [o for o in out if o[3] == "ok"]
    work = ok + [o for o in out if o[3] == "timed_out" and len(o[2])]
    lat = [o[1] - sent[o[0]][1] for o in ok]
    e2e = {"setup_s": t_start - t0,
           "output_tokens_per_s": sum(len(o[2]) for o in work) / window,
           "request_p95_s": report.percentile(lat, 95) if lat else None}
    summary = tslice.summary()
    ctx = {"stats": stats, "window_s": window, "trace": summary,
           "config": cfg,
           "served": [(len(sent[o[0]][0]), len(o[2])) for o in work],
           "admit_ms": eng._admit_slot.per_unit_ms() if timed else None,
           "decode_ms": eng._segment_core.per_unit_ms() if timed else None}
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    del eng                       # the Timed wrappers hold it in a cycle
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    failed = sum(o[3] not in ("ok", "timed_out") for o in out)
    checks, ctrl, readings = compare(cfg, traffic, w, sent, ok, seed, dev,
                                     control, failed)
    return {"e2e": e2e, "ctx": ctx, "trace": summary,
            "attempted": len(ok) + failed, "failed": failed,
            "memory_peak_bytes": peak, "checks": checks, "control": ctrl,
            "readings": readings}


def sample(ok: list, sent: dict, k: int, seed: int) -> list:
    """``k`` completed requests drawn from the seed, the one with the most
    prompt and served tokens first."""
    if not ok:
        return []
    longest = max(range(len(ok)),
                  key=lambda i: len(sent[ok[i][0]][0]) + len(ok[i][2]))
    rest = [i for i in range(len(ok)) if i != longest]
    rng = np.random.default_rng(seed + 2)
    pick = rng.choice(len(rest), size=min(k - 1, len(rest)), replace=False)
    return [ok[longest]] + [ok[rest[i]] for i in sorted(pick)]


def gap_stats(g: torch.Tensor) -> dict:
    """Summaries of the per-position gaps below the reference's best."""
    return {"max": float(g.max()), "mean": float(g.mean()),
            "p99": float(torch.quantile(g, 0.99)),
            "flipped": float((g > 0).float().mean())}


def compare(cfg, traffic, w, sent, ok, seed, dev, control, not_ok):
    """Checks on a sample of the completed requests: at every served
    position, the gap by which the served token's reference logit lies
    below the reference's best, summarised as the configuration's limits
    name them (``token_gap_mean``: the mean over the sample's positions, the
    one limit the configuration sets).  With ``control``, the same
    summaries of the token the float8 reference puts first at each
    position."""
    picked = sample(ok, sent, int(traffic["check_requests"]), seed)
    seqs, rows, served = [], [], []
    for rid, _, tokens, _ in picked:
        p = sent[rid][0]
        toks = np.concatenate([p, tokens[:-1]]).astype(np.int64)
        seqs.append(torch.as_tensor(toks, device=dev))
        rows.append(torch.arange(len(p) - 1, len(p) - 1 + len(tokens),
                                 device=dev))
        served.append(torch.as_tensor(tokens.astype(np.int64), device=dev))
    n_tok = sum(len(s) for s in served)
    stats, ctrl_stats = {}, {}
    if picked:
        ref = moe_lm.logits_at(cfg, w, seqs, rows)
        best = [r.max(-1).values for r in ref]
        g = torch.cat([b - r.gather(1, s[:, None])[:, 0]
                       for r, b, s in zip(ref, best, served)])
        stats = gap_stats(g)
        if control:
            low = moe_lm.logits_at(cfg, w, seqs, rows, quant="fp8")
            gc_ = torch.cat([b - r.gather(1, q.argmax(-1)[:, None])[:, 0]
                             for r, b, q in zip(ref, best, low)])
            ctrl_stats = gap_stats(gc_)
    lim = cfg["limits"]
    gaps = [k for k in lim if k.startswith("token_gap_")]
    checks = [report.check(k, stats.get(k[len("token_gap_"):]), lim[k])
              for k in gaps]
    checks += [report.check("not_ok", not_ok, lim["not_ok"]),
               report.check("tokens_compared", n_tok, 1, kind="min")]
    ctrl = None
    if control:
        ctrl = [report.check(k, ctrl_stats.get(k[len("token_gap_"):]),
                             lim[k]) for k in gaps]
    return checks, ctrl, {"program": stats, "control": ctrl_stats}
