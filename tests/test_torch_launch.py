"""The launch layer of the port against the reference's: the LM sharding
specs leaf for leaf, the dry-run cells' tables, the per-device argument
bytes, the counted FLOPs against the reference's HLO analyzer, the
live-bytes tracker, the stencil dry run's exchange against real
exchanges, and the ``train`` / ``serve`` / ``dryrun`` entry points on the
CPU and the meta device.

The reference's parameter, optimizer and cache trees come from
``jax.eval_shape`` (nothing is compiled but the one reduced forward); the
port's are built on ``torch.device("meta")``.  The reference stacks each
unit layer's leaves on a leading rep axis, so its specs are compared with
that entry dropped (it is never sharded: the rules skip it, and ZeRO-1
never picks it on these configs).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ALL_ARCHS, get_config as jget, get_reduced as jred
from repro.launch import cells as JC
from repro.models import transformer as JT
from repro.optim import AdamW as JAdamW
from repro.sharding import specs as JS

from repro_torch import interop
from repro_torch.configs import get_config, get_reduced
from repro_torch.launch import cells as C
from repro_torch.launch import cost_analysis as CA
from repro_torch.launch import dryrun as D
from repro_torch.launch import roofline as RF
from repro_torch.launch import stencil_dryrun as SD
from repro_torch.models import transformer as T
from repro_torch.optim import AdamW
from repro_torch.sharding import specs as S

META = torch.device("meta")
MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model")),
          "pod_32x8": ((32, 8), ("data", "model"))}


def meshes(kind):
    shape, names = MESHES[kind]
    return JS.make_abstract_mesh(shape, names), S.make_abstract_mesh(
        shape, names)


def jspec(sharding_or_spec) -> tuple:
    """A reference PartitionSpec (or a sharding's) as the port's tuple."""
    spec = getattr(sharding_or_spec, "spec", sharding_or_spec)
    return tuple(tuple(e) if isinstance(e, (list, tuple)) else e
                 for e in spec)


def per_layer(shardings, shapes):
    """A reference tree of shardings (over the tree of ``shapes``) as one
    of spec tuples, each stacked (``unit``) leaf an object array over its
    reps of the spec with the rep entry dropped (that entry must be None),
    for :func:`interop.reference_layers` to slice."""
    def one(kp, sh, leaf):
        spec = jspec(sh)
        if "unit" not in JS._path_str(kp):
            return spec
        assert spec[0] is None, (JS._path_str(kp), spec)
        reps = np.empty(leaf.shape[0], dtype=object)
        for r in range(leaf.shape[0]):
            reps[r] = spec[1:]
        return reps
    return jax.tree_util.tree_map_with_path(
        one, shardings, shapes, is_leaf=lambda x: hasattr(x, "spec"))


@pytest.fixture(scope="module")
def ref_params():
    """The reference's parameter shapes of every config, by max_position."""
    cache = {}

    def get(arch, max_position=4096):
        key = (arch, max_position)
        if key not in cache:
            cfg = jget(arch)
            cache[key] = jax.eval_shape(
                lambda k: JT.init_params(cfg, k, max_position=max_position),
                jax.random.PRNGKey(0))
        return cache[key]
    return get


# ---------------------------------------------------------------------------
# sharding specs
# ---------------------------------------------------------------------------

SPEC_CASES = {
    # tests/launch/test_sharding_specs.py's cases: (arch, path, shape,
    # the reference test's own assertion on the spec)
    "embedding_shards_vocab": ("gemma2-9b", "embed", (256000, 3584),
                               lambda s: s[0] == "model" and s[1] is None),
    "gqa_divisible_heads_wq": ("yi-9b", "unit/0/attn/wq",
                               (48, 4096, 32, 128),
                               lambda s: s[2] == "model"),
    "gqa_kv_below_tp_replicated": ("yi-9b", "unit/0/attn/wk",
                                   (48, 4096, 4, 128),
                                   lambda s: all(e is None for e in s)),
    "context_parallel_replicates": ("phi3-medium-14b", "unit/0/attn/wq",
                                    (40, 5120, 40, 128),
                                    lambda s: all(e is None for e in s)),
    "experts_shard_on_model": ("qwen3-moe-30b-a3b", "unit/0/moe/w_up",
                               (48, 128, 2048, 768),
                               lambda s: s[1] == "model"),
    "mlp_column": ("yi-9b", "unit/0/mlp/up", (48, 4096, 11008),
                   lambda s: s[2] == "model"),
    "mlp_row": ("yi-9b", "unit/0/mlp/down", (48, 11008, 4096),
                lambda s: s[1] == "model"),
    "norms_replicated": ("yi-9b", "unit/0/ln1", (48, 4096),
                         lambda s: all(e is None for e in s)),
}


@pytest.mark.parametrize("case", sorted(SPEC_CASES) + [
    "zero1_free_dim", "zero1_nothing_divides", "batch_composes_pod_data",
    "batch_one_unsharded"])
def test_spec_rules_as_the_reference_tests_state_them(case):
    jm, m = meshes("pod")
    if case in SPEC_CASES:
        arch, path, shape, holds = SPEC_CASES[case]
        got = S.param_spec(get_config(arch), path, shape, m)
        want = jspec(JS.param_spec(jget(arch), path, shape, jm))
    elif case == "zero1_free_dim":
        got = S.zero1_spec((None, "model"), (4096, 11008), m)
        want = jspec(JS.zero1_spec(JS.P(None, "model"), (4096, 11008), jm))
        holds = lambda s: s[0] == "data"                    # noqa: E731
    elif case == "zero1_nothing_divides":
        got = S.zero1_spec((), (7,), m)
        want = jspec(JS.zero1_spec(JS.P(), (7,), jm))
        holds = lambda s: all(e is None for e in s)          # noqa: E731
    else:
        kind, B = (("multipod", 256) if case == "batch_composes_pod_data"
                   else ("pod", 1))
        jm, m = meshes(kind)
        got, want = S.batch_spec(m, B), jspec(JS.batch_spec(jm, B))
        holds = (lambda s: s[0] == ("pod", "data")) if B == 256 \
            else (lambda s: s[0] is None)
    assert got == want and holds(got), (got, want)


@pytest.mark.parametrize("mesh_kind", sorted(MESHES))
def test_param_and_optimizer_specs_every_leaf(mesh_kind, ref_params):
    """Every parameter leaf of the 10 full-size configs, and ZeRO-1 on
    every optimizer leaf (master, m and v), as the reference's."""
    jm, m = meshes(mesh_kind)
    for arch in ALL_ARCHS:
        jcfg, cfg = jget(arch), get_config(arch)
        p_shape = ref_params(arch)
        o_shape = jax.eval_shape(JAdamW().init, p_shape)
        model = T.init_params(cfg, max_position=4096, device=META)
        names = [k for k, _ in model.named_parameters()]
        want_p = interop.named_from_reference(
            cfg, per_layer(JS.params_shardings(jcfg, p_shape, jm), p_shape),
            names)
        got_p = S.params_shardings(cfg, model, m)
        assert got_p == want_p, arch
        ref_o = JS.opt_shardings(jcfg, o_shape, jm)
        got_o = S.opt_shardings(cfg, AdamW().init(model), m)
        assert got_o["step"] == jspec(ref_o.step) == ()
        for field in ("master", "m", "v"):
            want = interop.named_from_reference(
                cfg, per_layer(getattr(ref_o, field),
                               getattr(o_shape, field)), names)
            assert got_o[field] == want, (arch, field)


@pytest.mark.parametrize("mesh_kind", sorted(MESHES))
@pytest.mark.parametrize("batch,seq,quant", [(128, 32768, False),
                                             (1, 524288, False),
                                             (32, 32768, True)])
def test_batch_and_cache_specs_every_leaf(mesh_kind, batch, seq, quant,
                                          ref_params):
    """``batch_spec`` at 2 and 3 dims, and ``cache_shardings`` of every
    layer's decode caches (KV, ring, int8 scales, SSM) and of whisper's
    cross caches, as the reference's."""
    jm, m = meshes(mesh_kind)
    for nd in (2, 3):
        assert S.batch_spec(m, batch, nd) == jspec(
            JS.batch_spec(jm, batch, nd))
    for arch in ALL_ARCHS:
        jcfg, cfg = jget(arch), get_config(arch)
        c_shape = jax.eval_shape(
            lambda: JT.init_cache(jcfg, batch, seq, quant=quant))
        want = interop.reference_layers(cfg, per_layer(
            JS.cache_shardings(jcfg, c_shape, jm, batch), c_shape))
        caches = T.init_cache(cfg, batch, seq, quant=quant, device=META)
        got = S.cache_shardings(cfg, caches, m, batch)
        assert got == want, arch
        if not cfg.is_encoder_decoder:
            continue
        enc = jax.ShapeDtypeStruct((batch, jcfg.encoder_seq, jcfg.d_model),
                                   jnp.bfloat16)
        x_shape = jax.eval_shape(
            lambda p, e: JT.prefill_cross_caches(jcfg, p, e),
            ref_params(arch), enc)
        want = interop.reference_layers(cfg, per_layer(JS.cache_shardings(
            jcfg, x_shape, jm, batch, seq_shard=False), x_shape))
        model = T.init_params(cfg, device=META)
        cross = T.prefill_cross_caches(cfg, model, torch.empty(
            enc.shape, dtype=torch.bfloat16, device=META))
        assert S.cache_shardings(cfg, cross, m, batch,
                                 seq_shard=False) == want


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_cells_tables_as_the_reference(arch, ref_params):
    """SHAPES, skip_reason, pick_accum (on every mesh), count_params,
    active_params and model_flops of every shape."""
    assert {k: vars(v) for k, v in C.SHAPES.items()} == \
        {k: vars(v) for k, v in JC.SHAPES.items()}
    jcfg, cfg = jget(arch), get_config(arch)
    for name, shape in C.SHAPES.items():
        assert C.skip_reason(cfg, name) == JC.skip_reason(jcfg, name)
        for kind in MESHES:
            jm, m = meshes(kind)
            assert C.pick_accum(cfg, shape, m) == JC.pick_accum(
                jcfg, JC.SHAPES[name], jm), (name, kind)
        p_shape = ref_params(arch, shape.seq)
        model = T.init_params(cfg, max_position=shape.seq, device=META)
        assert C.count_params(model) == JC.count_params(p_shape)
        assert C.active_params(cfg, model) == JC.active_params(jcfg,
                                                               p_shape)
        assert C.model_flops(cfg, name, model) == JC.model_flops(
            jcfg, name, p_shape)


def ref_arg_bytes(arch, shape, jm, ref_params) -> float:
    """The reference's ``_sharded_arg_bytes`` rule (each leaf's bytes
    over the mesh sizes its spec names) on the reference's own specs of
    the cell's arguments (``cells.build_*_cell``'s in_shardings)."""
    jcfg, cell = jget(arch), JC.SHAPES[shape]
    p_shape = ref_params(arch, cell.seq)
    leaves = [(p_shape, JS.params_shardings(jcfg, p_shape, jm))]
    B, S_text = cell.batch, cell.seq - (jcfg.vision_patches or 0)

    def sds(shape_, dtype, spec):
        leaves.append((jax.ShapeDtypeStruct(shape_, dtype), spec))
    if cell.kind == "train":
        o_shape = jax.eval_shape(JAdamW().init, p_shape)
        leaves.append((o_shape, JS.opt_shardings(jcfg, o_shape, jm)))
        sds((B, S_text), jnp.int32, JS.batch_spec(jm, B))
        sds((B, S_text), jnp.int32, JS.batch_spec(jm, B))
    if cell.kind in ("train", "prefill"):
        if cell.kind == "prefill":
            sds((B, S_text), jnp.int32, JS.batch_spec(jm, B))
        if jcfg.is_encoder_decoder:
            sds((B, jcfg.encoder_seq, jcfg.d_model), jnp.bfloat16,
                JS.batch_spec(jm, B, 3))
        if jcfg.vision_patches:
            sds((B, jcfg.vision_patches, jcfg.vision_embed_dim),
                jnp.bfloat16, JS.batch_spec(jm, B, 3))
    else:
        c_shape = jax.eval_shape(lambda: JT.init_cache(jcfg, B, cell.seq))
        leaves.append((c_shape, JS.cache_shardings(jcfg, c_shape, jm, B)))
        sds((B, 1), jnp.int32, JS.batch_spec(jm, B))
        sds((), jnp.int32, JS.P())
        if jcfg.is_encoder_decoder:
            enc = jax.ShapeDtypeStruct(
                (B, jcfg.encoder_seq, jcfg.d_model), jnp.bfloat16)
            sds(enc.shape, enc.dtype, JS.batch_spec(jm, B, 3))
            x_shape = jax.eval_shape(
                lambda p, e: JT.prefill_cross_caches(jcfg, p, e), p_shape,
                enc)
            leaves.append((x_shape, JS.cache_shardings(
                jcfg, x_shape, jm, B, seq_shard=False)))
    total = 0.0
    for tree, shardings in leaves:
        specs = jax.tree.leaves(shardings,
                                is_leaf=lambda x: hasattr(x, "spec")
                                or isinstance(x, JS.P))
        for leaf, sh in zip(jax.tree.leaves(tree), specs, strict=True):
            denom = 1
            for entry in jspec(sh):
                for ax in ((entry,) if isinstance(entry, str)
                           else (entry or ())):
                    denom *= jm.shape[ax]
            total += float(np.prod(leaf.shape)) * leaf.dtype.itemsize \
                / denom
    return total


@pytest.mark.parametrize("mesh_kind", ["pod", "multipod"])
def test_arg_bytes_per_device_as_the_reference_rule(mesh_kind, ref_params):
    """``analytic_args_bytes_per_device`` of every cell on both production
    meshes equals the reference's rule on the reference's specs."""
    jm, m = meshes(mesh_kind)
    for arch in ALL_ARCHS:
        cfg = get_config(arch)
        for shape in C.SHAPES:
            if C.skip_reason(cfg, shape):
                continue
            _, args, meta = C.build_cell(cfg, shape, m)
            got = D._sharded_arg_bytes(args, meta["specs"], m)
            want = ref_arg_bytes(arch, shape, jm, ref_params)
            assert got == pytest.approx(want, rel=1e-12), (arch, shape)


def test_counted_flops_match_the_reference_hlo_analyzer():
    """A reduced qwen3-1.7b forward: the port's op-by-op FLOPs on the meta
    device within 2% of the reference's analyzer on its CPU-compiled HLO
    (both count the products only)."""
    from repro.launch import hlo_analysis as HA
    jcfg, cfg = jred("qwen3-1.7b"), get_reduced("qwen3-1.7b")
    B, S_ = 2, 64
    p_shape = jax.eval_shape(lambda k: JT.init_params(jcfg, k),
                             jax.random.PRNGKey(0))
    tok = jax.ShapeDtypeStruct((B, S_), jnp.int32)
    hlo = jax.jit(lambda p, t: JT.forward(jcfg, p, {"tokens": t})[0]) \
        .lower(p_shape, tok).compile().as_text()
    want = HA.analyze(hlo).flops
    model = T.init_params(cfg, device=META)
    tokens = torch.empty((B, S_), dtype=torch.int32, device=META)
    costs = CA.analyze(T.forward, cfg, model, {"tokens": tokens},
                       device=META)
    assert want > 0 and costs.flops == pytest.approx(want, rel=0.02), \
        (costs.flops, want)


def test_live_bytes_tracker_exact_peak():
    """A hand-built allocate / view / free sequence: the peak of live
    bytes counts each new storage once, from creation to free; views and
    in-place ops allocate nothing; bytes count operands and outputs."""
    counter = CA.CostCounter()
    with counter:
        a = torch.empty(100, device=META)                # 400 live
        b = torch.empty(200, device=META)                # 1200
        v = b[50:]                                       # a view: 1200
        v.add_(1.0)                                      # in place: 1200
        del a                                            # 800
        c = v * 2.0                                      # 800 + 600
        del b                                            # v keeps b alive
        d = torch.empty(10, device=META)                 # 1440
        del v                                            # b freed: 640
        e = torch.empty(300, device=META)                # 1840
        live = counter.live_bytes
    assert counter.peak_live_bytes == 1840 and live == 1840
    del c, d, e
    assert counter.live_bytes == 0
    # add_ reads its 150 floats and writes them; the product reads 150
    # and writes 150; factories write their outputs; the view moves none
    assert counter.bytes_accessed == 400 + 800 + 2 * 600 + 2 * 600 + 40 \
        + 1200


def test_no_meta_kernel_fails_with_the_op_name():
    counter = CA.CostCounter()
    x = torch.zeros(8, dtype=torch.int64, device=META)
    with pytest.raises(NotImplementedError, match="bincount"):
        with counter:
            torch.bincount(x)


def test_link_rates_follow_the_node_layout():
    pod, pod8 = S.make_abstract_mesh((16, 16), ("data", "model")), \
        S.make_abstract_mesh((32, 8), ("data", "model"))
    assert RF.link_bw(pod, ("model",)) == RF.IB_BW          # 16 > 8
    assert RF.link_bw(pod8, ("model",)) == RF.NVLINK_BW
    assert RF.link_bw(pod8, ("data",)) == RF.IB_BW


# ---------------------------------------------------------------------------
# the stencil dry run against real exchanges
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("unroll", [1, 4])
def test_stencil_exchange_per_check_matches_real_exchanges(unroll):
    """The dry run's strips and cells a check equal what the sharded
    tier's exchange copies on a (4, 4) mesh of CPU devices (k = 1)."""
    from repro_torch.core import frames as F
    from repro_torch.sharding import GridPartition, make_mesh, scatter_grid
    mesh = make_mesh((4, 4), ("data", "model"), devices=["cpu"] * 16)
    part = GridPartition(mesh, ("data", "model"), (0, 1))
    lm, ln = 16, 32
    sspec = F.sharded_frame_spec(lm, ln, part, k=1, sweeps=unroll)
    grid = torch.arange(4 * lm * 4 * ln, dtype=torch.float32).reshape(
        4 * lm, 4 * ln)
    frames = F.make_frames_sharded(scatter_grid(grid, part), sspec, "zero")
    before = dict(F.exchange_counts)
    F.refresh_frames_sharded(frames, sspec, "zero")
    got = {k: F.exchange_counts[k] - before[k] for k in before}
    assert got == SD.exchange_per_check((4, 4), (lm, ln), k=1,
                                        unroll=unroll)


def test_stencil_dryrun_record(tmp_path):
    assert SD.main(["--out", str(tmp_path)]) == 0
    rec = json.loads((tmp_path / "stencil_16384.json").read_text())
    assert rec["block"] == [1024, 1024] and rec["chips"] == 256
    assert rec["strips_per_check"] == SD.exchange_per_check(
        (16, 16), (1024, 1024))["strips"] == 960
    sw = rec["sweep"]
    assert sw["t_memory"] == pytest.approx(2 * 1026 ** 2 * 4 / RF.HBM_BW)
    assert sw["t_collective"] == pytest.approx(4 * 1024 * 4 / RF.IB_BW)
    assert SD.plan(16384, mesh_shape=(1, 1))["sweep"]["t_memory"] == \
        pytest.approx(2 * 16386 ** 2 * 4 / RF.HBM_BW)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def test_train_and_serve_cli_on_the_cpu(capsys):
    from repro_torch.launch import serve, train
    assert train.main(["--arch", "qwen3-1.7b", "--reduced", "--steps", "2",
                       "--device", "cpu"]) == 0
    assert serve.main(["--arch", "gemma2-9b", "--reduced", "--max-new",
                       "4", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[launch.train] qwen3-1.7b: 2 steps, 0 faults" in out
    assert "[launch.serve] gemma2-9b (reduced):" in out


@pytest.mark.parametrize("cli,arch,shape", [
    ("train", "qwen3-1.7b", "train_4k"),
    ("serve", "deepseek-moe-16b", "decode_32k")])
def test_dry_run_full_width_cell(cli, arch, shape, tmp_path, monkeypatch):
    """A full-width cell end to end through the CLI's ``--dry-run``: the
    record is ok, its argument bytes are the reference rule's, the FLOPs
    of a train step sit between the model's 6·N·D and twice it, and a
    decode step's bytes cover its weights and caches."""
    import importlib
    monkeypatch.chdir(tmp_path)
    mod = importlib.import_module(f"repro_torch.launch.{cli}")
    assert mod.main(["--arch", arch, "--shape", shape, "--dry-run",
                     "--device", "cpu"]) == 0
    rec = json.loads((tmp_path / "runs" / "dryrun_cli_torch"
                      / f"{arch}__{shape}__pod.json").read_text())
    assert rec["ok"] and not rec["skipped"], rec.get("error")
    a, mem, rf = rec["analyzer"], rec["memory"], rec["roofline"]
    assert a["collective_model"] == "analytic" and a["trip_counts"] == {}
    assert a["op_count"] > 0 and mem["temp_bytes_per_device"] > 0
    counted = a["flops_per_device"] * rec["chips"]
    if shape == "train_4k":
        assert rec["meta"]["accum"] == 8
        assert rec["model_flops"] < counted < 2 * rec["model_flops"]
        assert a["per_collective"]["reduce-scatter"] > 0
    else:
        assert rf["dominant"] == "memory"
    assert rf["t_compute"] == pytest.approx(
        a["flops_per_device"] / RF.PEAK_FLOPS)
