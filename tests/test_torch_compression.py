"""The port's int8 error-feedback gradient compression against the JAX
package on the CPU.

The reference's ``ef_int8_psum`` runs under ``jax.vmap`` with an axis
name, whose ``psum``/``pmax`` over the mapped axis are the collectives
it takes inside ``shard_map``; the port folds the peers in mesh order.
``quantize_int8``'s payloads and scale, and the summed gradients (int8
sums times the shared scale), are held exactly; the residuals within
1e-7 of the scale (one float32 rounding of ``g - q·scale``).  The drift
bound is the reference test's: after 20 steps of 2 peers the cumulative
compressed sum is within 2% of the true one, correlation above 0.999.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train.compression import ef_int8_psum as jax_ef_int8_psum
from repro.train.compression import quantize_int8 as jax_quantize_int8
from repro_torch.train.compression import (ef_int8_payloads, ef_int8_psum,
                                           ef_int8_psum_tree,
                                           init_error_state, quantize_int8)


def jax_psum(gs, errs):
    """The reference over the peers' leading axis: (sums, residuals)."""
    return jax.vmap(lambda g, e: jax_ef_int8_psum(g, e, "pod"),
                    axis_name="pod")(jnp.asarray(gs), jnp.asarray(errs))


@pytest.mark.parametrize("peers", [1, 2, 3, 4, 200])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_quantize_int8_is_the_reference_exactly(seed, peers):
    x = (np.random.default_rng(seed).normal(size=(64,)) * 10 ** (seed - 1)
         ).astype(np.float32)
    q, scale = quantize_int8(torch.tensor(x), peers)
    jq, jscale = jax_quantize_int8(jnp.asarray(x), peers)
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(scale) == float(jscale)
    err = np.abs(q.numpy().astype(np.float32) * float(scale) - x)
    assert err.max() <= float(scale) * 0.5 + 1e-6


def test_overflow_safe_for_n_peers():
    q, _ = quantize_int8(torch.full((8,), 123.0), 2)
    assert int(q.abs().max()) <= 63                      # 127 // 2
    q, scale = quantize_int8(torch.zeros(4), 3)
    assert float(scale) == float(np.float32(1e-12))
    assert int(q.abs().max()) == 0


@pytest.mark.parametrize("peers", [2, 3, 4])
def test_ef_psum_matches_the_reference(peers):
    rng = np.random.default_rng(peers)
    gs = rng.normal(size=(peers, 3, 50)).astype(np.float32)
    errs = (rng.normal(size=(peers, 3, 50)) * 0.01).astype(np.float32)
    sums, new = jax_psum(gs, errs)
    got, got_errs = ef_int8_psum([torch.tensor(g) for g in gs],
                                 [torch.tensor(e) for e in errs])
    np.testing.assert_array_equal(got.numpy(), np.asarray(sums[0]))
    qs, scale, _ = ef_int8_payloads([torch.tensor(g) for g in gs],
                                    [torch.tensor(e) for e in errs])
    assert all(q.dtype == torch.int8 for q in qs)
    assert int(max(q.abs().max() for q in qs)) <= 127 // peers
    for p in range(peers):
        np.testing.assert_allclose(got_errs[p].numpy(), np.asarray(new[p]),
                                   rtol=0, atol=1e-7 * float(scale))


def test_error_feedback_drift_stays_bounded():
    """The reference test's property, and the reference's own sums step by
    step, over 20 steps of 2 peers."""
    rng = np.random.default_rng(0)
    gs = rng.normal(size=(2, 20, 256)).astype(np.float32)
    errs = [torch.zeros(256), torch.zeros(256)]
    jerrs = np.zeros((2, 256), np.float32)
    sums = []
    for t in range(20):
        s, errs = ef_int8_psum([torch.tensor(gs[0, t]),
                                torch.tensor(gs[1, t])], errs)
        js, jerrs = jax_psum(gs[:, t], jerrs)
        np.testing.assert_allclose(s.numpy(), np.asarray(js[0]), rtol=0,
                                   atol=1e-6)
        sums.append(s.numpy())
    cum_c = np.cumsum(np.stack(sums), axis=0)
    cum_t = np.cumsum(gs.sum(axis=0), axis=0)
    rel = np.abs(cum_c[-1] - cum_t[-1]).max() / (np.abs(cum_t[-1]).max()
                                                  + 1e-9)
    assert rel < 0.02, rel
    assert np.corrcoef(cum_c[-1], cum_t[-1])[0, 1] > 0.999


def test_tree_version_is_leaf_by_leaf():
    rng = np.random.default_rng(5)
    trees = [{"w": torch.tensor(rng.normal(size=(4, 3)).astype(np.float32)),
              "b": [torch.tensor(rng.normal(size=(3,)).astype(np.float32))]}
             for _ in range(2)]
    errs = [init_error_state(t) for t in trees]
    assert errs[0]["w"].dtype == torch.float32
    assert float(errs[0]["b"][0].abs().sum()) == 0.0
    total, new = ef_int8_psum_tree(trees, errs)
    assert sorted(total) == ["b", "w"] and len(new) == 2
    for get in (lambda t: t["w"], lambda t: t["b"][0]):
        want, want_errs = ef_int8_psum([get(t) for t in trees],
                                       [get(e) for e in errs])
        assert torch.equal(get(total), want)
        for n, w in zip(new, want_errs):
            assert torch.equal(get(n), w)
