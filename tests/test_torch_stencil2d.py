"""Port parity: the fused stencil+reduce sweep (``repro_torch.kernels.
stencil2d``) and the elemental functions (``repro_torch.kernels.ref``).

On the CPU the sweep's wrapper runs its plain version; it is held against
the JAX Pallas kernel in interpret mode and against the JAX oracle
``stencil2d_fused_ref``.  The CUDA kernel itself is held against the plain
version by the ``cuda``-marked tests (skipped without a card) and by
``chip_smoke.py``.
"""
import re
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels import ref as JR  # noqa: E402
from repro.kernels.stencil2d import stencil2d_fused as j_fused  # noqa: E402
from repro_torch.core.frames import frame_env, frame_spec, make_frame  # noqa: E402,E501
from repro_torch.kernels import ref as TR  # noqa: E402
from repro_torch.kernels import stencil2d as TK  # noqa: E402

CSRC = Path(TK.__file__).resolve().parent / "csrc"


def field(seed, shape, binary=False):
    rng = np.random.default_rng(seed)
    if binary:
        return (rng.uniform(size=shape) < 0.3).astype(np.float32)
    return rng.uniform(size=shape).astype(np.float32)


def elementals(name):
    """(jax body, port Elemental, k, n_env, binary input) per functor."""
    w3 = field(9, (3, 3)) - 0.5
    w7 = field(10, (7, 7)) - 0.5
    table = {
        "jacobi": (JR.jacobi_taps(0.25), TR.jacobi_taps(0.25), 1, 0, False),
        "helmholtz_jacobi": (JR.helmholtz_jacobi_taps(0.5, 1 / 64),
                             TR.helmholtz_jacobi_taps(0.5, 1 / 64), 1, 1,
                             False),
        "heat": (JR.heat_taps(0.1), TR.heat_taps(0.1), 1, 0, False),
        "sobel": (JR.sobel_taps(), TR.sobel_taps(), 1, 0, False),
        "gol": (JR.gol_taps(), TR.gol_taps(), 1, 0, True),
        "median3": (JR.median3_taps(), TR.median3_taps(), 1, 0, False),
        "restore": (JR.restore_taps(2.0), TR.restore_taps(2.0), 1, 2,
                    False),
        "conv3": (_jconv(w3), TR.conv_taps(w3), 1, 0, False),
        "conv7": (_jconv(w7), TR.conv_taps(w7), 3, 0, False),
    }
    for k in (1, 2, 3):
        jm, jr = JR.amf_detect_taps(k)
        tm, tr = TR.amf_detect_taps(k)
        table[f"amf_mask{k}"] = (jm, tm, k, 0, False)
        table[f"amf_repl{k}"] = (jr, tr, k, 0, False)
    return table[name]


def _jconv(w):
    from repro.core.stencil import conv_taps
    f = conv_taps(jnp.asarray(w))
    return lambda get, *_: f(get)


NAMES = ["jacobi", "helmholtz_jacobi", "heat", "sobel", "gol", "median3",
         "restore", "conv3", "conv7", "amf_mask1", "amf_repl1", "amf_mask2",
         "amf_repl2", "amf_mask3", "amf_repl3"]


def env_fields(n_env, shape):
    if n_env == 1:
        return [np.random.default_rng(11).normal(size=shape)
                .astype(np.float32)]
    if n_env == 2:
        return [field(12, shape), field(13, shape, binary=True)]
    return []


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("boundary", ["zero", "reflect"])
def test_elemental_bodies_match_reference(name, boundary):
    """Every port body ≡ its JAX body through the two oracles."""
    jf, tf, k, n_env, binary = elementals(name)
    assert tf.k == k and tf.n_env == n_env
    a = field(1, (48, 64), binary)
    env = env_fields(n_env, a.shape)
    meas = name in ("jacobi", "restore", "amf_repl2")
    jn, jr = JR.stencil2d_fused_ref(
        jnp.asarray(a), jf, env=tuple(jnp.asarray(e) for e in env), k=k,
        combine="sum", measure=JR.abs_delta if meas else None,
        boundary=boundary)
    tn, tr = TR.stencil2d_fused_ref(
        torch.as_tensor(a), tf, env=tuple(torch.as_tensor(e) for e in env),
        k=k, combine="sum", measure=TR.abs_delta if meas else None,
        boundary=boundary)
    if name.startswith(("amf_mask", "gol")):
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    else:
        np.testing.assert_allclose(tn.numpy(), np.asarray(jn), atol=1e-5,
                                   rtol=0)
    assert float(tr) == pytest.approx(float(jr), rel=1e-5, abs=1e-6)


# few cases: the JAX kernel runs in Pallas interpret mode, which is slow
@pytest.mark.parametrize("name,shape,boundary,combine,meas", [
    ("heat", (100, 130), "zero", "max", True),
    ("helmholtz_jacobi", (96, 160), "wrap", "sum", True),
    ("amf_mask3", (48, 64), "reflect", "any", False),
])
def test_plain_sweep_matches_pallas_interpret(name, shape, boundary,
                                              combine, meas):
    jf, tf, k, n_env, binary = elementals(name)
    a = field(2, shape, binary)
    env = env_fields(n_env, shape)
    jn, jr = j_fused(jnp.asarray(a), jf, env=tuple(map(jnp.asarray, env)),
                     k=k, combine=combine,
                     measure=JR.abs_delta if meas else None,
                     boundary=boundary, block=(64, 128), interpret=True)
    tn, tr = TK.stencil2d_fused(
        torch.as_tensor(a), tf, env=tuple(map(torch.as_tensor, env)), k=k,
        combine=combine, measure=TR.abs_delta if meas else None,
        boundary=boundary)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), atol=1e-5,
                               rtol=0)
    if combine == "any":
        assert tr.dtype == torch.bool and bool(tr) == bool(jr)
    else:
        assert float(tr) == pytest.approx(float(jr), rel=1e-5)


@pytest.mark.parametrize("combine", ["sum", "max", "min", "any", "all"])
def test_framed_wrapper_on_cpu_is_the_plain_version(combine):
    a = torch.as_tensor(field(3, (100, 130)))
    spec = frame_spec(100, 130, k=1)
    frame = make_frame(a, spec, "reflect")
    out = torch.full(spec.shape, -7.0)
    kw = dict(combine=combine, measure=TR.abs_delta)
    got, red = TK.stencil2d_fused_framed(frame, TR.heat_taps(0.1), spec,
                                         out=out, **kw)
    want, wred = TK.stencil2d_fused_framed_ref(frame, TR.heat_taps(0.1),
                                               spec, **kw)
    assert got is out
    p = spec.pad
    mi, ni = spec.interior
    torch.testing.assert_close(got[p:p + mi, p:p + ni],
                               want[p:p + mi, p:p + ni], rtol=0, atol=0)
    assert float(got[0, 0]) == -7.0                  # ghost ring untouched
    assert red.dtype == (torch.bool if combine in ("any", "all")
                         else torch.float32)
    assert float(red) == float(wred)
    # do_reduce=False: ⊕'s identity, typed like the reduce
    _, ident = TK.stencil2d_fused_framed(frame, TR.heat_taps(0.1), spec,
                                         do_reduce=False, **kw)
    assert ident.dtype == red.dtype
    with pytest.raises(ValueError, match="second frame"):
        TK.stencil2d_fused_framed(frame, TR.heat_taps(0.1), spec,
                                  out=frame, **kw)


def test_reduce_is_masked_to_the_domain():
    """Round-up cells fold as ⊕'s identity: a huge value there is never
    seen by the reduce."""
    spec = frame_spec(100, 130, k=1)
    frame = make_frame(torch.zeros(100, 130), spec, "zero")
    frame[-3, -3] = 1e9                              # deep round-up
    _, red = TK.stencil2d_fused_framed(frame, TR.jacobi_taps(), spec,
                                       combine="max")
    assert float(red) == 0.0


def _enum(text, name):
    body = re.search(r"enum\s+" + name + r"\s*:\s*int\s*\{(.*?)\}", text,
                     re.S).group(1)
    return {k: int(v) for k, v in re.findall(r"(\w+)\s*=\s*(\d+)", body)}


def test_descriptor_ids_match_the_cuda_sources():
    fun = _enum((CSRC / "elementals.cuh").read_text(), "FunctorId")
    assert {k.lower(): v for k, v in fun.items()} == TR.FUNCTOR_IDS
    cu = (CSRC / "fold.cuh").read_text()
    assert {k[2:].lower(): v for k, v in _enum(cu, "MonoidId").items()} \
        == TK.MONOID_IDS
    assert {k[5:].lower(): v for k, v in _enum(cu, "MeasureId").items()} \
        == TR.MEASURE_IDS
    assert f"kMaxParams = {TR.MAX_PARAMS}" in \
        (CSRC / "elementals.cuh").read_text()


def test_kernel_descriptor_rejects_what_has_no_functor():
    with pytest.raises(ValueError, match="Registered functors.*sobel"):
        TK.kernel_descriptor(lambda get: get(0, 0), None, "sum", None)
    with pytest.raises(ValueError, match="Registered measures"):
        TK.kernel_descriptor(TR.heat_taps(), lambda n, o: n - o, "sum",
                             None)
    with pytest.raises(ValueError, match="named monoids"):
        TK.kernel_descriptor(TR.heat_taps(), None, (min, 0.0), 0.0)
    el, mid, name = TK.kernel_descriptor(TR.sobel_taps(), TR.abs_delta,
                                         "max", None)
    assert (el.functor_id, mid, name) == (3, 1, "max")
    with pytest.raises(ValueError, match="side <= 7"):
        TR.conv_taps(np.ones((9, 9)))


# ---------------------------------------------------------------------------
# the kernel's own CTA tile (cta_tile), its shared memory and the reduce
# scratch, pinned on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mi,ni", [(8192, 8192), (1088, 1920), (1024, 1312),
                                   (128, 320), (64, 160), (8, 32)])
@pytest.mark.parametrize("pad,n_env,heavy", [(1, 0, False), (1, 1, False),
                                             (1, 2, False), (3, 0, True),
                                             (3, 0, False)])
@pytest.mark.parametrize("lanes", [1, 8])
def test_cta_tile_is_whole_pieces_that_fit(mi, ni, pad, n_env, heavy,
                                           lanes):
    tm, tn, ring = TK.cta_tile(mi, ni, lanes=lanes, pad=pad, n_env=n_env,
                               heavy=heavy)
    assert tm % 8 == 0 and tn % 32 == 0 and ring in (1, 2)
    assert tm <= -(-mi // 8) * 8 and tn <= -(-ni // 32) * 32
    assert TK.window_bytes((tm, tn), pad, n_env, ring=ring) \
        <= TK.SMEM_BYTES


def test_cta_tile_at_the_main_paths_shapes():
    # Helmholtz 8192^2 (phases 2-3), AMF k=3 and restore at 1080x1920
    # (phase 4), a frame too small to fill the card
    assert TK.cta_tile(8192, 8192, pad=1, n_env=1) == (32, 128, 2)
    assert TK.cta_tile(1088, 1920, pad=3, heavy=True) == (8, 32, 2)
    assert TK.cta_tile(1088, 1920, pad=1, n_env=2) == (16, 128, 2)
    assert TK.cta_tile(64, 160, pad=1) == (8, 32, 2)


def test_window_bytes_and_partial_slots():
    # two slots of a 34x130 frame window and a 32x128 env tile: 68,128
    # bytes, what the kernel reported on the card for this launch
    assert TK.window_bytes((32, 128), 1, 1) == 2 * (34 * 130 + 32 * 128) * 4
    assert TK.window_bytes((32, 128), 1, 1, ring=1, work=True) \
        == 2 * 34 * 130 * 4 + 32 * 128 * 4
    # bf16: 10 x 34 x 2 = 680 bytes, each buffer rounded up to 16 bytes
    assert TK.window_bytes((8, 32), 1, 0, itemsize=2) == 2 * 688
    # one partial per CTA that visits a lane: at most the 8x32 pieces or
    # the grid's cap
    assert TK.partial_slots(frame_spec(8192, 8192)) == TK.MAX_GRID
    assert TK.partial_slots(frame_spec(40, 136)) == (64 // 8) * (160 // 32)


def test_forced_tiles_are_checked():
    spec = frame_spec(40, 136)
    frame = torch.zeros(spec.shape)
    el = TR.heat_taps(0.1)
    assert TK.resolve_tile((16, 64), spec, None, el, frame, env_halo=False,
                           work=False) == (16, 64, 2)
    for bad in ((12, 32), (16, 48), (16, 32, 3)):
        with pytest.raises(ValueError, match="CTA tile"):
            TK.resolve_tile(bad, spec, None, el, frame, env_halo=False,
                            work=False)
    odd = frame_spec(40, 15, block=(8, 15))
    with pytest.raises(ValueError, match="even interior width"):
        TK.check_pair_layout(odd, torch.zeros(odd.shape))


# ---------------------------------------------------------------------------
# On the card: the CUDA kernel against its plain version (skipped without a
# CUDA device; chip_smoke.py runs the full-size version of this check).
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("boundary", ["zero", "nan", "reflect", "wrap"])
def test_cuda_kernel_matches_plain(cuda, name, boundary):
    _, tf, k, n_env, binary = elementals(name)
    a = torch.as_tensor(field(4, (100, 130), binary), device=cuda)
    spec = frame_spec(100, 130, k=k)
    frame = make_frame(a, spec, boundary)
    env = tuple(frame_env(torch.as_tensor(e, device=cuda), spec, boundary)
                for e in env_fields(n_env, (100, 130)))
    for combine in ("sum", "max", "any"):
        kw = dict(env_framed=env, combine=combine, measure=TR.abs_delta)
        before = TK.launch_counts["stencil_sweep"]
        got, red = TK.stencil2d_fused_framed(frame, tf, spec, **kw)
        assert TK.launch_counts["stencil_sweep"] == before + 1
        want, wred = TK.stencil2d_fused_framed_ref(frame, tf, spec, **kw)
        p = spec.pad
        torch.testing.assert_close(got[p:p + 100, p:p + 130],
                                   want[p:p + 100, p:p + 130], rtol=0,
                                   atol=1e-5, equal_nan=True)
        if combine == "sum":
            torch.testing.assert_close(red, wred, rtol=1e-5, atol=0,
                                       equal_nan=True)
        else:
            assert torch.equal(red, wred) or (
                bool(torch.isnan(red)) and bool(torch.isnan(wred)))
