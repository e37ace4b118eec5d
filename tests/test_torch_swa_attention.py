"""The port's sliding-window attention against the JAX package on the CPU.

On CPU tensors the port's wrapper runs its plain version, which is held
here against the reference's Pallas kernel in interpret mode and against
its oracle.  Tolerances: atol 2e-5 in float32 (the reference test's own;
dense softmax against an online softmax over 128-key blocks), atol = rtol
= 3e-2 in bf16 (the reference's bf16 tolerance).  The kernel itself is
held against the plain version on the card (tests/test_torch_cuda.py,
chip_smoke.py phase 11); here, its route choice and the numerics of its
bf16 P·V (P split into two bf16 parts) are held to that card limit, one
bf16 ulp (rtol 1e-2, atol 1e-4).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.swa_attention import swa_attention as jax_swa
from repro.kernels.swa_attention import swa_attention_ref
from repro_torch.kernels import swa_attention as TS

# the reference test's shapes (tests/kernels/test_swa_attention.py)
SHAPES = [
    ((2, 256, 64), 0, True),
    ((2, 256, 64), 128, True),
    ((1, 512, 128), 256, True),
    ((2, 128, 64), 0, False),
    ((1, 256, 64), 64, True),
    ((1, 384, 64), 200, True),
]


def qkv(seed, q_rows, kv_rows, S, hd):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(q_rows, S, hd)).astype(np.float32),
            rng.normal(size=(kv_rows, S, hd)).astype(np.float32),
            rng.normal(size=(kv_rows, S, hd)).astype(np.float32))


def port(q, k, v, dtype=torch.float32, **kw):
    t = [torch.as_tensor(a).to(dtype) for a in (q, k, v)]
    return TS.swa_attention(*t, **kw)


@pytest.mark.parametrize("shape,window,causal", SHAPES)
def test_plain_matches_jax_kernel(shape, window, causal):
    q, k, v = qkv(0, shape[0], shape[0], shape[1], shape[2])
    want = jax_swa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   window=window, causal=causal, interpret=True)
    got = port(q, k, v, window=window, causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("case", ["gqa", "softcap", "hd16"])
def test_plain_matches_jax_kernel_gqa_softcap_hd16(case):
    B, H, KH, S, hd, window, cap = 1, 2, 2, 256, 64, 128, 0.0
    if case == "gqa":
        B, H, KH = 2, 4, 2
    elif case == "softcap":
        cap = 50.0
    else:
        hd, window = 16, 8
    q, k, v = qkv(1, B * H, B * KH, S, hd)
    want = jax_swa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   window=window, softcap=cap, interpret=True)
    got = port(q, k, v, window=window, softcap=cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_plain_matches_jax_kernel_hd96():
    # phi-3-vision's head_dim: f32, GQA 4/2, a window that is no tile
    # multiple, softcap 50
    q, k, v = qkv(7, 4, 2, 256, 96)
    want = jax_swa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   window=100, softcap=50.0, interpret=True)
    got = port(q, k, v, window=100, softcap=50.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_plain_matches_jax_kernel_bf16():
    q, k, v = qkv(2, 2, 2, 256, 64)
    bf = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    want = jax_swa(*bf, window=128, interpret=True)
    got = port(q, k, v, dtype=torch.bfloat16, window=128)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("shape,window,causal", SHAPES[:3])
def test_plain_matches_oracle(shape, window, causal):
    q, k, v = qkv(3, shape[0], shape[0], shape[1], shape[2])
    want = swa_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             window=window, causal=causal)
    got = TS.swa_attention_plain(*map(torch.as_tensor, (q, k, v)),
                                 window=window, causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_window_one_is_the_identity():
    q, k, v = qkv(4, 1, 1, 128, 64)
    got = port(q, k, v, window=1, causal=True)
    np.testing.assert_allclose(got.numpy(), v, atol=1e-5)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    q, k, v = (torch.as_tensor(a) for a in qkv(5, 2, 2, 256, 64))
    before = dict(TS.launch_counts)
    with pytest.raises(ValueError, match="head_dim"):
        TS.swa_attention(q[..., :48], k[..., :48], v[..., :48])
    with pytest.raises(ValueError, match="dtype"):
        TS.swa_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="S must tile"):
        TS.swa_attention(q[:, :200], k[:, :200], v[:, :200])
    with pytest.raises(ValueError, match="multiple of kv heads"):
        TS.swa_attention(q[:1], k, v)
    with pytest.raises(ValueError, match="k and v"):
        TS.swa_attention(q, k, v[:, :128])
    with pytest.raises(ValueError, match="window"):
        TS.swa_attention(q, k, v, window=-1)
    # a tensor on a device with no kernel is refused, not run plainly
    with pytest.raises(ValueError, match="no kernel"):
        TS.swa_attention(q.to("meta"), k.to("meta"), v.to("meta"))
    assert TS.launch_counts == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", TS.HEAD_DIMS)
def test_route_is_chosen_by_dtype_and_head_dim(dtype, hd):
    want = ("wgmma" if dtype == torch.bfloat16 and hd in (64, 96, 128, 256)
            else "cuda_core")
    assert TS._route(dtype, hd) == want


def kernel_pv_emulation(q, k, v, *, window, softcap, split, head_dim=None):
    """The wgmma route's arithmetic in torch, dense: float32 scores (scale
    after the bf16 dot), softcap, mask, P = exp(s - max) in float32, P·V
    with P rounded to bf16 as P_hi + P_lo (``split``) or P_hi alone, one
    division by the float32 row sum, one final bf16 rounding.  Where q, k
    and v come padded with zero columns (hd 96 in the kernel's hd-128
    layout), ``head_dim`` is their own width: it sets the scale, and the
    output keeps that many columns."""
    BH, S, hd = q.shape
    head_dim = head_dim or hd
    rows = torch.arange(BH) // (BH // k.shape[0])
    s = (q.float() @ k.float()[rows].transpose(-1, -2)) \
        * float(1.0 / np.sqrt(head_dim))
    s = softcap * torch.tanh(s / softcap)
    qp, kp = torch.arange(S)[:, None], torch.arange(S)[None, :]
    ok = (kp <= qp) & (kp > qp - window)
    s = torch.where(ok[None], s, torch.full((), TS.NEG_INF))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p_hi = p.to(torch.bfloat16).float()
    p_in = p_hi + (p - p_hi).to(torch.bfloat16).float() if split else p_hi
    out = (p_in @ v.float()[rows]) / p.sum(dim=-1, keepdim=True)
    return out[..., :head_dim].to(torch.bfloat16)


@pytest.mark.parametrize("hd,S,pad", [(256, 1024, 0), (96, 384, 32)])
def test_p_split_keeps_the_bf16_route_within_one_ulp(hd, S, pad):
    # gemma2-like head: hd 256, softcap 50, a window that is no tile
    # multiple; the split P·V passes the card limit, P in bf16 alone fails
    # it.  phi-3-vision's hd 96 runs in the hd-128 layout: the emulation
    # takes q, k and v with the 32 zero columns TMA fills in, and is held
    # against the plain version and the reference's kernel too
    q, k, v = (torch.as_tensor(a).to(torch.bfloat16)
               for a in qkv(6, 2, 1, S, hd))
    kw = dict(window=300, softcap=50.0)
    want = TS.swa_attention_plain(q, k, v, **kw).float()
    limit = 1e-4 + 1e-2 * want.abs()
    padded = [torch.nn.functional.pad(t, (0, pad)) for t in (q, k, v)]
    split = kernel_pv_emulation(*padded, split=True, head_dim=hd,
                                **kw).float()
    hi_only = kernel_pv_emulation(*padded, split=False, head_dim=hd,
                                  **kw).float()
    assert split.shape == want.shape
    assert bool(((split - want).abs() <= limit).all())
    assert float(((hi_only - want).abs() / limit).max()) > 1.0
    if pad:
        ref = torch.as_tensor(np.asarray(jax_swa(
            *(jnp.asarray(t.float().numpy(), jnp.bfloat16)
              for t in (q, k, v)), interpret=True, **kw), np.float32))
        assert bool(((split - ref).abs() <= 1e-4 + 1e-2 * ref.abs()).all())
        assert bool(((want - ref).abs() <= 1e-4 + 1e-2 * ref.abs()).all())
