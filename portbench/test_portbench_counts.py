"""The yardstick's arithmetic on shapes worked by hand."""
import json

import pytest

from portbench import report, spec
from portbench.counts import lm, peaks, stencil

TINY = dict(hidden_size=8, num_attention_heads=2, num_key_value_heads=2,
            intermediate_size=16, moe_intermediate_size=4,
            n_routed_experts=4, num_experts_per_tok=2, n_shared_experts=1,
            num_hidden_layers=3, first_k_dense_replace=1, vocab_size=10)


def test_sweep_bytes():
    # a 4 x 5 float32 frame: the grid read and written, two fields read
    assert stencil.sweep_bytes(4, 5) == 2 * 20 * 4
    assert stencil.restore_sweep_bytes(4, 5) == 4 * 20 * 4
    assert stencil.restore_sweep_bytes(1080, 1920) == 16 * 1080 * 1920


def test_active_params_by_hand():
    # attention: q, o 8*2*4 each, k, v 8*2*4 each -> 256
    assert lm.layer_params(TINY, dense=False) == 256 + 32 + 192 + 96
    assert lm.layer_params(TINY, dense=True) == 256 + 3 * 8 * 16
    assert lm.active_params(TINY) == 640 + 2 * 576 + 80


def test_attention_and_request_flops_by_hand():
    # positions 0..2 attend 1 + 2 + 3 keys; 4 * heads * hd per key a layer
    assert lm.attention_flops(TINY, 0, 3) == 4 * 2 * 4 * 6 * 3
    assert lm.attention_flops(TINY, 2, 3) == 4 * 2 * 4 * 3 * 3
    # a prompt of 2 and 2 generated tokens: 3 positions through the model
    assert lm.request_flops(TINY, 2, 2) == 2 * 1872 * 3 + 576
    assert lm.request_flops(TINY, 2, 1) == 2 * 1872 * 2 \
        + lm.attention_flops(TINY, 0, 2)


def test_deepseek_active_params():
    cfg = json.loads((spec.HERE / "configs" / "deepseek-moe-16b.json")
                     .read_text())
    # 28 layers, d 2048: 27 MoE layers of 6 routed + 2 shared experts of
    # 1408, one dense layer of 10944, and the 102400-row head
    assert lm.active_params(cfg) == 2_618_818_560


def test_peaks_and_percentile():
    assert peaks.BF16_FLOPS == 989e12 and peaks.HBM_BYTES == 3.35e12
    assert report.percentile([1, 2, 3, 4, 5], 50) == 3
    assert report.percentile(range(1, 101), 95) == pytest.approx(95.05)


def test_result_line_keys_and_checks_last():
    checks = [report.check("gap", 0.1, 0.2),
              report.check("compared", 5, 1, kind="min")]
    line = report.result_line(
        correct=True, attempted=3, failed=0,
        metrics={"items_per_s": {"value": 1.5, "unit": "items/s"}},
        device={"platform": "gpu", "kind": "x", "count": 1,
                "memory_peak_bytes": 1},
        checks=checks, breakdown={"device_ops": [], "idle_gaps": []})
    d = json.loads(line)
    assert list(d) == ["correct", "attempted", "failed", "metrics",
                       "device", "breakdown", "checks"]
    assert d["checks"] == {"gap": {"value": 0.1, "limit": 0.2},
                           "compared": {"value": 5, "limit": 1}}
    assert all(report.passes(c) for c in checks)
    assert not report.passes(report.check("gap", None, 1.0))
    assert not report.passes(report.check("gap", 2.0, 1.0))
    assert report.checks_text(checks)[0].startswith("check gap = 0.1")
