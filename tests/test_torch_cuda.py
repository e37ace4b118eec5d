"""The port's CUDA kernels on the card, against their plain versions.

Every test here is marked ``cuda`` and skips without a CUDA device (the
kernels have no CPU mode); the module imports neither JAX nor the JAX
package, so the tests run on a machine with a card and PyTorch alone:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

``chip_smoke.py`` runs the full-size versions of these checks.  Tolerances:
float32 grids within 1e-5 (measured bit-identical), float sums rel 1e-5,
bf16 5e-2 (rtol and atol).  Attention: the kernel against its plain
version within atol 2e-5 in float32 and within one bf16 ulp in bf16
(rtol 1e-2, atol 1e-4: both round nearly the same float32 value once,
as in ``chip_smoke.py`` phase 11); the flash route against the einsum
route within atol 1e-4 on float32 logits (online against dense softmax,
TF32 off).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import pattern as TP
from repro_torch.core.frames import (frame_env, frame_spec, make_frame,
                                     make_lane_frames, refresh_frame)
from repro_torch.kernels import multistep as TM
from repro_torch.kernels import ref as TR
from repro_torch.kernels import stencil2d as TK
from repro_torch.kernels import swa_attention as TS

BOUNDARIES = ["zero", "nan", "reflect", "wrap"]
# mirror-asymmetric weights: the reference test's `lopsided` stencil
LOPSIDED = [[0.0, 0.0, 0.3], [0.2, 0.25, 0.0], [0.0, 0.25, 0.0]]
PORT_FN = {"lopsided": TR.conv_taps(LOPSIDED)}
SCALES = (1.0, 5.0, 0.1, 2.0)


def field(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def mixed_batch(seed=0, n=4, shape=(40, 136)):
    """Stacked items with deliberately different convergence speeds."""
    u0 = field(seed, shape)
    return np.stack([u0 * SCALES[i % len(SCALES)] for i in range(n)])


# ---------------------------------------------------------------------------
# the multistep and single-step kernels
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("boundary", BOUNDARIES)
@pytest.mark.parametrize("name", ["heat", "lopsided", "helmholtz",
                                  "restore", "amf_repl2", "conv7"])
@pytest.mark.parametrize("T", [2, 3])
def test_cuda_multistep_matches_plain(cuda, name, boundary, T):
    w7 = field(14, (7, 7)) * 0.1
    f, n_env = {
        "heat": (TR.heat_taps(0.1), 0),
        "lopsided": (PORT_FN["lopsided"], 0),
        "helmholtz": (TR.helmholtz_jacobi_taps(0.5, 0.2), 1),
        "restore": (TR.restore_taps(2.0), 2),
        "amf_repl2": (TR.amf_detect_taps(2)[1], 0),
        "conv7": (TR.conv_taps(w7), 0)}[name]
    m, n = 100, 130
    spec = frame_spec(m, n, k=f.k, sweeps=T)
    frame = make_frame(torch.as_tensor(field(15, (m, n)), device=cuda),
                       spec, boundary)
    env = tuple(frame_env(torch.as_tensor(field(16 + i, (m, n)),
                                          device=cuda).abs(), spec, boundary,
                          halo=True) for i in range(n_env))
    kw = dict(T=T, env_framed=env, combine="max", measure=TR.abs_delta,
              boundary=boundary)
    before = TK.launch_counts["multistep_sweep"]
    got, red = TM.stencil2d_multistep_framed(frame, f, spec, **kw)
    assert TK.launch_counts["multistep_sweep"] == before + 1
    want, wred = TM.stencil2d_multistep_framed_ref(frame, f, spec, **kw)
    p = spec.pad
    torch.testing.assert_close(got[p:p + m, p:p + n], want[p:p + m, p:p + n],
                               rtol=0, atol=1e-5, equal_nan=True)
    assert torch.equal(red, wred) or (bool(torch.isnan(red))
                                      and bool(torch.isnan(wred)))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["stencil_sweep", "multistep_sweep"])
def test_cuda_lanes_with_a_frozen_lane(cuda, kernel):
    T = 3 if kernel == "multistep_sweep" else 1
    m, n, b = 100, 130, "reflect"
    spec = frame_spec(m, n, k=1, sweeps=T)
    stack = torch.as_tensor(np.stack([field(20 + i, (m, n))
                                      for i in range(3)]), device=cuda)
    frames = make_lane_frames(stack, spec, b)
    live = torch.tensor([True, False, True], device=cuda)
    f = TR.heat_taps(0.1)
    kw = dict(combine="sum", measure=TR.abs_delta, live=live)
    if kernel == "multistep_sweep":
        kw.update(T=T, boundary=b)
        run, ref = TM.stencil2d_multistep_framed, \
            TM.stencil2d_multistep_framed_ref
    else:
        run, ref = TK.stencil2d_fused_framed, TK.stencil2d_fused_framed_ref
    got, red = run(frames, f, spec, **kw)
    want, wred = ref(frames, f, spec, **kw)
    p = spec.pad
    torch.testing.assert_close(got[:, p:p + m, p:p + n],
                               want[:, p:p + m, p:p + n], rtol=0, atol=1e-5)
    assert torch.equal(got[1, p:p + m, p:p + n], frames[1, p:p + m, p:p + n])
    torch.testing.assert_close(red, wred, rtol=1e-5, atol=0)
    assert float(red[1]) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("boundary", BOUNDARIES)
def test_cuda_bf16_kernels_match_plain(cuda, boundary):
    m, n, T = 100, 130, 3
    a = torch.as_tensor(field(30, (m, n)), device=cuda).to(torch.bfloat16)
    e = torch.as_tensor(field(31, (m, n)), device=cuda).to(torch.bfloat16)
    f = TR.helmholtz_jacobi_taps(0.5, 0.2)
    kw = dict(combine="max", measure=TR.abs_delta)
    s1 = frame_spec(m, n, k=1)
    fr1 = make_frame(a, s1, boundary)
    e1 = (frame_env(e, s1, boundary),)
    g1, r1 = TK.stencil2d_fused_framed(fr1, f, s1, env_framed=e1, **kw)
    w1, q1 = TK.stencil2d_fused_framed_ref(fr1, f, s1, env_framed=e1, **kw)
    sT = frame_spec(m, n, k=1, sweeps=T)
    frT = make_frame(a, sT, boundary)
    eT = (frame_env(e, sT, boundary, halo=True),)
    gT, rT = TM.stencil2d_multistep_framed(frT, f, sT, T=T, env_framed=eT,
                                           boundary=boundary, **kw)
    wT, qT = TM.stencil2d_multistep_framed_ref(frT, f, sT, T=T,
                                               env_framed=eT,
                                               boundary=boundary, **kw)
    # the multistep kernel rounds every sweep as T single-step launches do
    cur, nxt = fr1.clone(), torch.empty_like(fr1)
    for _ in range(T):
        nxt, _ = TK.stencil2d_fused_framed(cur, f, s1, env_framed=e1,
                                           out=nxt, **kw)
        refresh_frame(nxt, s1, boundary)
        cur, nxt = nxt, cur
    q = sT.pad
    for got, want in ((g1[1:1 + m, 1:1 + n], w1[1:1 + m, 1:1 + n]),
                      (gT[q:q + m, q:q + n], wT[q:q + m, q:q + n])):
        assert got.dtype == torch.bfloat16
        torch.testing.assert_close(got.float(), want.float(), atol=5e-2,
                                   rtol=5e-2, equal_nan=True)
    torch.testing.assert_close(gT[q:q + m, q:q + n], cur[1:1 + m, 1:1 + n],
                               rtol=0, atol=0, equal_nan=True)
    for got, want in ((r1, q1), (rT, qT)):
        torch.testing.assert_close(got, want, atol=5e-2, rtol=5e-2,
                                   equal_nan=True)


# ---------------------------------------------------------------------------
# farm_run: against its solo runs, one launch for all lanes
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("backend,unroll,key", [
    ("cuda", 1, "stencil_sweep"), ("cuda", 2, "stencil_sweep"),
    ("cuda-multistep", 3, "multistep_sweep")])
def test_cuda_farm_run_matches_solo_runs(cuda, backend, unroll, key):
    batch = torch.as_tensor(mixed_batch(), device=cuda)
    loop = TP.LoopOfStencilReduce(
        f=TR.heat_taps(0.1), k=1, combine="max", cond=lambda r: r < 2e-3,
        delta=TR.abs_delta, boundary="reflect", max_iters=60, unroll=unroll,
        backend=backend, device=cuda)
    before = TK.launch_counts[key]
    got = loop.farm_run(batch)
    launched = TK.launch_counts[key] - before
    iters = got.iters.tolist()
    assert len(set(iters)) > 1
    checks = max(iters) // unroll
    assert launched == checks * (unroll if backend == "cuda" else 1)
    for i in range(len(batch)):
        solo = loop.run(batch[i])
        assert int(solo.iters) == iters[i]
        torch.testing.assert_close(got.a[i], solo.a, rtol=0, atol=1e-5)
    ref = TP.LoopOfStencilReduce(
        f=TR.heat_taps(0.1), k=1, combine="max", cond=lambda r: r < 2e-3,
        delta=TR.abs_delta, boundary="reflect", max_iters=60, unroll=unroll,
        backend="torch", device=cuda).farm_run(batch)
    assert ref.iters.tolist() == iters
    torch.testing.assert_close(got.a, ref.a, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# sliding-window attention and the LM forward
# ---------------------------------------------------------------------------

def swa_launches():
    return sum(TS.launch_counts.values())


@pytest.fixture
def cuda_f32(cuda, monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return cuda


SWA_CASES = [
    # (B·H, B·KH, S, hd, window, causal, softcap)
    (2, 2, 256, 64, 0, True, 0.0),
    (2, 2, 256, 64, 128, True, 0.0),
    (1, 1, 512, 128, 256, True, 0.0),
    (2, 2, 128, 64, 0, False, 0.0),
    (1, 1, 256, 64, 64, True, 0.0),
    (1, 1, 384, 64, 200, True, 0.0),
    (8, 4, 256, 64, 128, True, 0.0),         # GQA, B=2 H=4 KH=2
    (2, 2, 256, 64, 128, True, 50.0),
    (2, 2, 256, 16, 8, True, 50.0),
    (2, 1, 256, 32, 0, True, 0.0),
    (2, 1, 384, 256, 100, True, 50.0),
    (1, 1, 64, 64, 0, True, 0.0),             # S < 128 tiles by S
    # the wgmma route's edges (bf16 at hd 64/128/256)
    (2, 1, 64, 256, 0, True, 50.0),           # S = 64: half a 128-row q block
    (4, 2, 384, 128, 200, True, 0.0),         # q blocks straddle the band's edge
    (2, 2, 384, 64, 300, True, 50.0),         # windows 200, 300: not tile multiples
    (2, 1, 512, 256, 200, True, 50.0),
    (2, 1, 256, 256, 0, False, 50.0),         # causal = False
    (2, 2, 384, 128, 200, False, 0.0),        # band without the causal mask
    (8, 2, 256, 64, 0, True, 0.0),            # G = 4
    (8, 1, 256, 128, 128, True, 50.0),        # G = 8
    (2, 2, 256, 128, 0, True, 50.0),          # hd 128 with softcap
]
SWA_BF16_LIMIT = dict(rtol=1e-2, atol=1e-4)   # one bf16 ulp (phase 11's)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SWA_CASES)
def test_cuda_swa_attention_matches_plain(cuda_f32, case, dtype):
    bh, bkh, S, hd, window, causal, cap = case
    dt = getattr(torch, dtype)
    q, k, v = (torch.as_tensor(field(40 + i, (rows, S, hd)), device=cuda_f32)
               .to(dt) for i, rows in enumerate((bh, bkh, bkh)))
    before = swa_launches()
    got = TS.swa_attention(q, k, v, window=window, causal=causal,
                           softcap=cap)
    torch.cuda.synchronize()
    assert swa_launches() == before + 1
    want = TS.swa_attention_plain(q, k, v, window=window, causal=causal,
                                  softcap=cap)
    assert got.dtype == dt and got.shape == q.shape
    tol = dict(atol=2e-5, rtol=0) if dt == torch.float32 else SWA_BF16_LIMIT
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,hd,route", [
    ("bfloat16", 64, "wgmma"), ("bfloat16", 128, "wgmma"),
    ("bfloat16", 256, "wgmma"), ("bfloat16", 32, "cuda_core"),
    ("float32", 64, "cuda_core"), ("float32", 256, "cuda_core")])
def test_cuda_swa_attention_takes_its_route(cuda_f32, dtype, hd, route):
    dt = getattr(torch, dtype)
    q, k, v = (torch.as_tensor(field(60 + i, (2, 128, hd)), device=cuda_f32)
               .to(dt) for i in range(3))
    before = dict(TS.launch_counts)
    TS.swa_attention(q, k, v, window=64, softcap=50.0)
    torch.cuda.synchronize()
    assert {r: TS.launch_counts[r] - before[r] for r in before} == \
        {r: int(r == route) for r in before}


@pytest.mark.cuda
def test_cuda_swa_window_one_is_the_identity(cuda_f32):
    q, k, v = (torch.as_tensor(field(50 + i, (1, 128, 64)), device=cuda_f32)
               for i in range(3))
    torch.testing.assert_close(TS.swa_attention(q, k, v, window=1), v,
                               atol=1e-5, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 2])
def test_cuda_forward_routes_agree_and_count_launches(cuda_f32, batch):
    from repro_torch.configs import get_reduced
    from repro_torch.models import attention as TA
    from repro_torch.models import transformer as TT
    cfg = get_reduced("gemma2-9b")
    model = TT.init_params(cfg, seed=0, device=cuda_f32)
    tokens = torch.as_tensor(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (batch, 256)),
        device=cuda_f32)
    before = swa_launches()
    flash, _ = TT.forward(cfg, model, {"tokens": tokens})
    assert swa_launches() - before == cfg.num_layers
    TA.set_flash_swa(False)
    try:
        einsum, _ = TT.forward(cfg, model, {"tokens": tokens})
    finally:
        TA.set_flash_swa(None)
    assert swa_launches() - before == cfg.num_layers
    assert bool(torch.isfinite(flash).all())
    torch.testing.assert_close(flash, einsum, atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_cuda_greedy_equals_teacher_forced_argmax(cuda_f32):
    from repro_torch.configs import get_reduced
    from repro_torch.models import transformer as TT
    from repro_torch.serve import GenerateConfig, generate
    cfg = get_reduced("gemma2-9b")
    model = TT.init_params(cfg, seed=1, device=cuda_f32)
    prompt = np.random.default_rng(1).integers(2, cfg.vocab_size, (2, 120))
    out, lengths, iters = generate(cfg, model, prompt,
                                   GenerateConfig(max_new_tokens=8),
                                   cache_dtype=torch.float32)
    full = torch.cat([torch.as_tensor(prompt, device=cuda_f32),
                      out.long()], dim=1)
    before = swa_launches()
    logits, _ = TT.forward(cfg, model, {"tokens": full})   # 128: flash
    assert swa_launches() - before == cfg.num_layers
    exp = logits[:, 119:-1].argmax(dim=-1)
    for b in range(2):
        L = int(lengths[b])
        assert torch.equal(out[b, :L].long(), exp[b, :L])
