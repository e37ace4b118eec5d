"""Cached single-token decode attention: the hand-written kernel's route
(``repro_torch.kernels.decode_attention``) against the einsum route of
``repro_torch.models.attention`` on the CPU.

The kernel launches only on a CUDA card; here the route is forced by
patching the card check (``attention._on_card``), so the same call runs the
kernel's plain version through the same code.  Its card twins are in
``tests/test_torch_cuda.py``.

Tolerance between the routes: the attention output (after ``wo``, in bf16)
within ``atol 1e-2 + rtol 2^-7``, about one bf16 ulp of outputs of size 2-4.
The einsum route rounds its scores and its probabilities to bf16 where the
kernel keeps float32 until the output's one rounding, so the two differ by
up to an ulp of the output (read 0.0078-0.0156).  Against a float64
reference on the same rotated query and cache, the kernel route's largest
and mean errors are no larger than the einsum route's.

End to end, the port's engine served on the kernel route is held against
the JAX package's engine on the same bf16 weights and requests, up to
near-ties of bf16 decoding (see :data:`GAP_LIMIT`).
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.models.attention as A
from repro.configs import get_reduced as reference_reduced
from repro.models import transformer as JT
from repro.serve import GenerateConfig as JGenerateConfig
from repro.serve.batcher import Request as JRequest
from repro.serve.engine import ContinuousEngine as JEngine
from repro_torch import interop
from repro_torch.configs import get_reduced
from repro_torch.kernels import decode_attention as DK
from repro_torch.models import transformer as T
from repro_torch.models.layers import apply_rope
from repro_torch.serve import ContinuousEngine, GenerateConfig, Request

KH, B, T_POOL, D = 2, 5, 96, 128
POSITIONS = [0, T_POOL - 1, 1, 37, 61]      # ragged, both ends of the pool
ATOL, RTOL = 1e-2, 2.0 ** -7
MODES = {"plain": (0, 0.0), "window": (16, 0.0), "softcap": (0, 5.0)}


@pytest.fixture
def on_card(monkeypatch):
    """Route as if the tensors lay on the card: the kernel route then runs
    the kernel's plain version on these CPU tensors."""
    monkeypatch.setattr(A, "_on_card", lambda t: True)


def layer(G, hd, seed=0):
    """(params, x, positions, k, v): one attention layer in bf16, a token a
    sequence, and a pool of random keys and values, stale rows included."""
    g = torch.Generator().manual_seed(seed)
    p = A.Attention(D, G * KH, KH, hd, device="cpu", dtype=torch.bfloat16,
                    generator=g)
    x = torch.randn(B, 1, D, generator=g).to(torch.bfloat16)
    k = torch.randn(B, T_POOL, KH, hd, generator=g).to(torch.bfloat16)
    v = torch.randn(B, T_POOL, KH, hd, generator=g).to(torch.bfloat16)
    return p, x, torch.tensor(POSITIONS).reshape(B, 1), k, v


def decode(G, hd, mode, p, x, pos, k, v):
    """One cached decode call: (out (B, 1, D), the cache it wrote)."""
    window, cap = MODES[mode]
    cache = {"k": k.clone(), "v": v.clone()}
    return A.attention(p, x, positions=pos, num_heads=G * KH,
                       num_kv_heads=KH, head_dim=hd, window=window,
                       attn_softcap=cap, kv_cache=cache, cache_pos=pos)


def both_routes(monkeypatch, G, hd, mode, seed=0):
    """(kernel route out, einsum route out, cache, inputs)."""
    p, x, pos, k, v = layer(G, hd, seed)
    want, wcache = decode(G, hd, mode, p, x, pos, k, v)
    with monkeypatch.context() as m:
        m.setattr(A, "_on_card", lambda t: True)
        got, gcache = decode(G, hd, mode, p, x, pos, k, v)
    assert torch.equal(gcache["k"], wcache["k"])
    assert torch.equal(gcache["v"], wcache["v"])
    return got, want, gcache, (p, x, pos)


def reference(G, hd, mode, p, x, pos, cache):
    """float64 attention on the routes' own rotated query and cache, each
    sequence over the slice of its visible keys (no mask)."""
    window, cap = MODES[mode]
    q = apply_rope(torch.einsum("bsd,dhk->bshk", x, p.wq), pos, 10000.0)
    out = torch.zeros(B, G * KH, hd, dtype=torch.float64)
    for b in range(B):
        P = int(pos[b])
        lo = max(0, P - window + 1) if window else 0
        ks = cache["k"][b, lo:P + 1].double()
        vs = cache["v"][b, lo:P + 1].double()
        for h in range(G * KH):
            s = ks[:, h // G] @ q[b, 0, h].double() / math.sqrt(hd)
            if cap:
                s = cap * torch.tanh(s / cap)
            out[b, h] = torch.softmax(s, 0) @ vs[:, h // G]
    return torch.einsum("bhk,hkd->bd", out, p.wo.double())[:, None]


def agree(got, want) -> bool:
    return bool(((got.float() - want.float()).abs()
                 <= ATOL + RTOL * want.float().abs()).all())


CASES = [(G, hd, mode) for G in (1, 2, 4) for hd in DK.HEAD_DIMS
         for mode in MODES]


@pytest.mark.parametrize("G,hd,mode", CASES)
def test_kernel_route_matches_einsum_route(monkeypatch, G, hd, mode):
    got, want, _, _ = both_routes(monkeypatch, G, hd, mode)
    assert got.dtype == want.dtype == torch.bfloat16
    assert agree(got, want), float((got.float() - want.float()).abs().max())


@pytest.mark.parametrize("G,hd,mode", CASES)
def test_kernel_route_is_no_less_exact_than_einsum_route(monkeypatch, G, hd,
                                                         mode):
    got, want, cache, (p, x, pos) = both_routes(monkeypatch, G, hd, mode)
    ref = reference(G, hd, mode, p, x, pos, cache)
    e_kernel = (got.double() - ref).abs()
    e_einsum = (want.double() - ref).abs()
    assert float(e_kernel.max()) <= float(e_einsum.max())
    assert float(e_kernel.mean()) <= float(e_einsum.mean())


def one_past(q, k, v, pos, **kw):
    """A planted fault: each sequence also attends the key after its own."""
    return DK.decode_attention_plain(q, k, v, pos + 1, **kw)


def key_zero_dropped(q, k, v, pos, **kw):
    """A planted fault: key 0 is never attended."""
    return DK.decode_attention_plain(q, k[:, 1:], v[:, 1:], pos - 1, **kw)


@pytest.mark.parametrize("fault", [one_past, key_zero_dropped])
@pytest.mark.parametrize("G,hd,mode", [(1, 128, "plain"), (2, 256, "softcap"),
                                       (4, 64, "window")])
def test_parity_catches_a_planted_fault(monkeypatch, fault, G, hd, mode):
    monkeypatch.setattr(A.decode_kernel, "decode_attention", fault)
    got, want, _, _ = both_routes(monkeypatch, G, hd, mode)
    assert not agree(got, want)


def cache_of(kind, hd=64, dtype=torch.bfloat16):
    """A decode cache of ``kind`` for :func:`test_route_condition`."""
    if kind == "ring":
        return A.init_kv_cache(B, T_POOL, KH, hd, dtype, window=8,
                               device="cpu")
    return A.init_kv_cache(B, T_POOL, KH, hd, dtype, quant=kind == "int8",
                           device="cpu")


ROUTES = {
    # case: (route a decode call takes, or None where no decode call runs)
    "full bf16": "kernel",
    "ring": "einsum",
    "int8": "einsum",
    "cross": "einsum",
    "float32": "einsum",
    "head dim 16": "einsum",
    "prefill (S > 1)": None,
    "the CPU": "einsum",
}


@pytest.mark.parametrize("case", list(ROUTES))
def test_route_condition(monkeypatch, case):
    """Which cached calls take the kernel: only single-token decode over a
    full bf16 cache, on the card, with a head layout the kernel has."""
    if case != "the CPU":
        monkeypatch.setattr(A, "_on_card", lambda t: True)
    hd = 16 if case == "head dim 16" else 64
    dtype = torch.float32 if case == "float32" else torch.bfloat16
    g = torch.Generator().manual_seed(1)
    p = A.Attention(D, 2 * KH, KH, hd, device="cpu", dtype=dtype,
                    generator=g)
    S = 4 if case == "prefill (S > 1)" else 1
    x = torch.randn(B, S, D, generator=g).to(dtype)
    pos = torch.tensor(POSITIONS).reshape(B, 1) % (T_POOL - S) \
        + torch.arange(S)[None]
    kw = dict(num_heads=2 * KH, num_kv_heads=KH, head_dim=hd)
    before = dict(A.decode_route_calls)
    if case == "cross":
        enc = torch.randn(B, 12, D, generator=g).to(dtype)
        kv = {"k": torch.einsum("bsd,dhk->bshk", enc, p.wk),
              "v": torch.einsum("bsd,dhk->bshk", enc, p.wv)}
        A.attention(p, x, positions=pos, causal=False, x_kv=enc,
                    kv_cache=kv, **kw)
    else:
        kind = case if case in ("ring", "int8") else "full"
        window = 8 if kind == "ring" else 0
        A.attention(p, x, positions=pos, window=window,
                    kv_cache=cache_of(kind, hd, dtype), cache_pos=pos[:, :1],
                    **kw)
    moved = {r: A.decode_route_calls[r] - before[r] for r in before}
    want = ROUTES[case]
    assert moved == {r: int(r == want) for r in before}


def test_positions_broadcast_on_the_device():
    """An int, a 0-d tensor and a (B, 1) tensor of one position agree."""
    _, _, _, k, v = layer(2, 64)
    q = torch.randn(B, 1, 2 * KH, 64).to(torch.bfloat16)
    outs = [DK.decode_attention_plain(q, k, v, p) for p in
            (40, torch.tensor(40), torch.full((B, 1), 40))]
    assert all(torch.equal(outs[0], o) for o in outs[1:])


def test_a_sequence_without_visible_keys_reads_zeros():
    _, _, _, k, v = layer(1, 64)
    q = torch.randn(B, 1, KH, 64).to(torch.bfloat16)
    out = DK.decode_attention_plain(q, k, v, torch.tensor([-1, 5, -3, 0, 9]))
    assert not out[[0, 2]].any() and out[[1, 3, 4]].any()


@pytest.mark.parametrize("H,KH_,hd", [(6, 2, 64), (4, 2, 48), (4, 2, 16)])
def test_wrapper_refuses_a_layout_without_a_kernel(H, KH_, hd):
    q = torch.zeros(2, 1, H, hd, dtype=torch.bfloat16)
    k = torch.zeros(2, 32, KH_, hd, dtype=torch.bfloat16)
    assert not DK.takes(H, KH_, hd)
    with pytest.raises(ValueError):
        DK.decode_attention(q, k, k, 3)


def test_wrapper_refuses_gradients():
    q = torch.zeros(2, 1, 2, 64, requires_grad=True)
    k = torch.zeros(2, 32, 2, 64)
    with pytest.raises(RuntimeError):
        DK.decode_attention(q, k, k, 3)


def served_model():
    cfg = dataclasses.replace(get_reduced("deepseek-moe-16b"),
                              dtype="bfloat16", head_dim=64)
    return cfg, T.init_params(cfg, device="cpu")


class PlainStep(ContinuousEngine):
    """The engine with its body step issued as a plain function (as an
    eager leg beside a graphed one runs it), counting its calls."""

    def _step_runner(self, step):
        def run():
            run.calls += 1
            step()
        run.calls = 0
        return run


@pytest.mark.parametrize("engine", [ContinuousEngine, PlainStep],
                         ids=["StepGraph", "plain function"])
@pytest.mark.parametrize("route", ["kernel", "einsum"])
def test_engine_counts_decode_attention_by_route(monkeypatch, route, engine):
    """``ContinuousEngine.stats`` counts each decode step's attention calls
    on the route they took: steps × attention layers, whatever runs the
    step."""
    if route == "kernel":
        monkeypatch.setattr(A, "_on_card", lambda t: True)
    cfg, model = served_model()
    eng = engine(cfg, model, GenerateConfig(max_new_tokens=4), slots=2,
                 segment=2, cache_dtype=torch.bfloat16, device="cpu")
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=np.asarray(
        rng.integers(2, cfg.vocab_size, n), np.int32), max_new_tokens=b)
        for i, (n, b) in enumerate([(3, 4), (6, 3), (4, 4)])]
    eng.run(reqs, lambda *a: None)
    layers = sum(s.kind == "attn" for s in T.layer_specs(cfg))
    steps = eng._step.calls
    assert steps > 0
    other = "einsum" if route == "kernel" else "kernel"
    assert eng.stats[f"attn_decode_{route}"] == steps * layers
    assert eng.stats[f"attn_decode_{other}"] == 0


# How far below a float32 reference forward's best logit a served token may
# lie, and how close two tokens' logits must be for a divergence from the
# reference engine to count as a near-tie.  Both engines decode in bf16, so
# a near-tie may go either way: the reference engine's own tokens read gaps
# up to 0.033 here, and the kernel route with the newest key dropped at each
# step 0.84 or more.
GAP_LIMIT = 0.1


def reference_logits(cfg, params, prompt, tokens):
    """float32 logits of the reference's forward over prompt + tokens, at
    the rows that chose each token: (len(tokens), vocab)."""
    f32 = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    full = np.concatenate([prompt, np.asarray(tokens, np.int32)])[None]
    logits, _ = JT.forward(dataclasses.replace(cfg, dtype="float32"), f32,
                           {"tokens": jnp.asarray(full)})
    return np.asarray(logits[0, len(prompt) - 1:-1])


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "deepseek-moe-16b"])
def test_engine_on_the_kernel_route_serves_the_reference_tokens(on_card,
                                                                 arch):
    """The port's ContinuousEngine with every decode attention call on the
    kernel route (bf16 weights and cache, hd 64) against the reference's
    engine on the same weights and ragged requests through 3 slots: each
    request's tokens equal the reference engine's up to a near-tie, and
    every served token is within :data:`GAP_LIMIT` of the best logit."""
    cfg = dataclasses.replace(reference_reduced(arch), dtype="bfloat16",
                              head_dim=64)
    params = JT.init_params(cfg, jax.random.PRNGKey(0))
    pcfg = dataclasses.replace(get_reduced(arch), dtype="bfloat16",
                               head_dim=64)
    model = interop.params_from_reference(
        pcfg, jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)),
                           params), device="cpu")
    rng = np.random.default_rng(0)
    reqs = [(i, np.asarray(rng.integers(2, cfg.vocab_size, L), np.int32), b)
            for i, (L, b) in enumerate(zip([3, 11, 5, 9, 12, 2, 7],
                                           [2, 7, 1, 5, 3, 7, 4]))]

    def serve(eng, request):
        """{rid: (tokens, status)} of ``reqs`` served on ``eng``."""
        got = {}
        eng.run([request(rid=i, prompt=p, max_new_tokens=b)
                 for i, p, b in reqs],
                lambda rid, toks, status: got.__setitem__(
                    int(rid), ([int(t) for t in np.asarray(toks)], status)))
        return got

    ref = serve(JEngine(cfg, params, JGenerateConfig(max_new_tokens=7,
                                                     eos_id=1),
                        slots=3, cache_dtype=jnp.bfloat16, segment=2),
                JRequest)
    eng = ContinuousEngine(pcfg, model, GenerateConfig(max_new_tokens=7,
                                                       eos_id=1),
                           slots=3, cache_dtype=torch.bfloat16, segment=2,
                           device="cpu")
    port = serve(eng, Request)
    assert eng.stats["attn_decode_kernel"] > 0
    assert eng.stats["attn_decode_einsum"] == 0
    assert port.keys() == ref.keys() == set(range(len(reqs)))
    for rid, prompt, _ in reqs:
        (toks, status), (want, want_status) = port[rid], ref[rid]
        assert status == want_status == "ok"
        logits = reference_logits(cfg, params, prompt, toks)
        gaps = logits.max(-1) - logits[np.arange(len(toks)), toks]
        assert float(gaps.max()) <= GAP_LIMIT, (rid, gaps)
        split = next((j for j, (a, b) in enumerate(zip(toks, want))
                      if a != b), None)
        if split is None:
            assert toks == want
        else:
            tie = abs(float(logits[split, toks[split]]
                            - logits[split, want[split]]))
            assert tie <= GAP_LIMIT, (rid, split, tie)
