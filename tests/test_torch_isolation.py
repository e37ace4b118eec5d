"""Isolation of the port: it imports neither JAX nor the JAX package, runs
on the card unless the caller asks for the CPU, and never falls back from
the kernel to its plain version."""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_no_jax_and_no_reference_package(path):
    for mod in imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), \
            f"{path.relative_to(ROOT)} imports {mod}"


def test_scan_covers_the_port():
    names = {p.name for p in PORT_FILES}
    assert {"pattern.py", "stencil2d.py", "multistep.py", "ops.py",
            "interop.py", "chip_smoke.py", "helmholtz.py", "swa_attention.py",
            "attention.py", "layers.py", "transformer.py", "objective.py",
            "engine.py", "base.py", "gemma2_9b.py", "streaming.py",
            "recovery.py", "faults.py", "video_restoration.py"} <= names


@pytest.fixture
def cpu_only_host(monkeypatch):
    """A host without a CUDA device, whatever this one has."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_raises_without_a_card(cpu_only_host):
    from repro_torch.core.executor import sweep_once
    from repro_torch.core.pattern import LoopOfStencilReduce
    from repro_torch.device import resolve_device
    from repro_torch.kernels import ops, ref as R
    a = np.zeros((16, 16), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.jacobi_solve(a, a)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.sobel(a)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sweep_once(a, R.sobel_taps(), backend="torch")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LoopOfStencilReduce(f=R.jacobi_taps(), cond=lambda r: True)
    assert resolve_device("cpu").type == "cpu"      # asked for: fine


def test_stream_entry_points_raise_without_a_card(cpu_only_host):
    from repro_torch.core.pattern import LoopOfStencilReduce
    from repro_torch.core.streaming import FarmEngine
    from repro_torch.examples import video_restoration as V
    from repro_torch.kernels import ref as R
    loop = LoopOfStencilReduce(f=R.restore_taps(), cond=lambda r: True,
                               device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FarmEngine(loop, lanes=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        V.main(["--frames", "1"])
    FarmEngine(loop, lanes=2, device="cpu")         # asked for: fine


def test_lm_entry_points_raise_without_a_card(cpu_only_host):
    from repro_torch.configs import get_reduced
    from repro_torch.models import transformer as T
    from repro_torch.serve import GenerateConfig, generate
    from repro_torch.train.objective import lm_loss
    cfg = get_reduced("gemma2-9b")
    tokens = np.zeros((1, 8), np.int64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.init_cache(cfg, 1, 16)
    model = T.init_params(cfg, device="cpu")        # asked for: fine
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.forward(cfg, model, {"tokens": tokens})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm_loss(cfg, model, {"tokens": tokens, "labels": tokens})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate(cfg, model, tokens, GenerateConfig(max_new_tokens=2))
    logits, _ = T.forward(cfg, model, {"tokens": tokens}, device="cpu")
    assert logits.device.type == "cpu"


def test_cuda_backend_on_cpu_tensors_raises():
    from repro_torch.core.pattern import LoopOfStencilReduce
    from repro_torch.device import resolve_backend
    from repro_torch.kernels import ops, ref as R
    cpu = torch.device("cpu")
    assert resolve_backend(None, cpu) == "torch"
    with pytest.raises(ValueError, match="needs a CUDA device"):
        resolve_backend("cuda", cpu)
    with pytest.raises(ValueError, match="needs a CUDA device"):
        LoopOfStencilReduce(f=R.jacobi_taps(), cond=lambda r: True,
                            backend="cuda", device="cpu")
    with pytest.raises(ValueError, match="needs a CUDA device"):
        ops.adaptive_median_detect(np.zeros((16, 16), np.float32),
                                   use_kernel=True, device="cpu")


def test_unregistered_lambda_raises_before_any_launch():
    from repro_torch.core.frames import frame_spec, make_frame
    from repro_torch.kernels import ref as R
    from repro_torch.kernels import stencil2d as S
    before = dict(S.launch_counts)
    with pytest.raises(ValueError, match="Registered functors"):
        S.kernel_descriptor(lambda get: get(0, 0), None, "sum", None)
    # a tensor on a device with no kernel is refused, not run plainly
    spec = frame_spec(16, 16)
    frame = make_frame(torch.zeros(16, 16), spec, "zero").to("meta")
    with pytest.raises(ValueError, match="no kernel"):
        S.stencil2d_fused_framed(frame, R.jacobi_taps(), spec)
    assert S.launch_counts == before


def test_flash_route_on_a_card_tensor_never_runs_the_plain_version(
        monkeypatch):
    """The attention's flash route hands CUDA-side tensors to the kernel
    wrapper, which launches or raises; the plain version is never
    called for them."""
    from repro_torch.kernels import swa_attention as TS
    monkeypatch.setattr(TS, "swa_attention_plain", lambda *a, **k: (
        pytest.fail("plain version called for a non-CPU tensor")))
    q = torch.zeros((2, 128, 16), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        TS.swa_attention(q, q, q)
