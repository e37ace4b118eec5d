"""The port's data pipeline against the JAX package on the CPU.

``SyntheticLM`` batches must equal the reference's exactly (the same numpy
arithmetic from the same seed); ``shard_batch`` and ``Prefetcher`` place
them on a device or split them over a mesh's data axis unchanged.
"""
import numpy as np
import pytest
import torch

from repro.data import SyntheticLM as JaxSyntheticLM
from repro_torch.data import Prefetcher, SyntheticLM, shard_batch
from repro_torch.sharding.specs import make_mesh


@pytest.mark.parametrize("vocab, seq, batch, seed", [
    (736, 32, 8, 1), (151936, 64, 2, 0), (50280, 17, 3, 7), (64, 8, 4, 3)])
@pytest.mark.parametrize("step", [0, 1, 13, 1000])
def test_batches_equal_the_reference_exactly(vocab, seq, batch, seed, step):
    ref = JaxSyntheticLM(vocab_size=vocab, seq_len=seq, global_batch=batch,
                         seed=seed)
    port = SyntheticLM(vocab_size=vocab, seq_len=seq, global_batch=batch,
                       seed=seed)
    want, got = ref.batch_at(step), port.batch_at(step)
    assert sorted(got) == ["labels", "tokens"]
    for k in want:
        assert got[k].dtype == want[k].dtype == np.int32
        assert got[k].shape == (batch, seq)
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(got["tokens"][:, 1:], got["labels"][:, :-1])
    assert got["tokens"].max() < min(vocab, 4096)


def test_batches_resume_at_any_step():
    port = SyntheticLM(vocab_size=736, seq_len=16, global_batch=4, seed=2)
    ref = JaxSyntheticLM(vocab_size=736, seq_len=16, global_batch=4, seed=2)
    it, jit = port.batches(5), ref.batches(5)
    for step in range(5, 9):
        b, jb = next(it), next(jit)
        np.testing.assert_array_equal(b["tokens"], jb["tokens"])
        np.testing.assert_array_equal(b["tokens"],
                                      port.batch_at(step)["tokens"])


def test_shard_batch_on_a_device_and_over_the_data_axis():
    b = SyntheticLM(vocab_size=736, seq_len=8, global_batch=4,
                    seed=0).batch_at(0)
    placed = shard_batch(b, "cpu")
    for k in b:
        assert isinstance(placed[k], torch.Tensor)
        np.testing.assert_array_equal(placed[k].numpy(), b[k])
    mesh = make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)
    shards = shard_batch(b, mesh)
    assert len(shards) == 2
    for k in b:
        np.testing.assert_array_equal(
            torch.cat([s[k] for s in shards]).numpy(), b[k])
    with pytest.raises(ValueError, match="does not split"):
        shard_batch({"tokens": np.zeros((3, 4))},
                    make_mesh((2,), ("data",), devices=["cpu"] * 2))


def test_prefetcher_hands_out_the_batches_in_order():
    data = SyntheticLM(vocab_size=736, seq_len=8, global_batch=2, seed=4)
    src = (data.batch_at(s) for s in range(3))
    got = list(Prefetcher(src, "cpu"))
    assert len(got) == 3
    for s, b in enumerate(got):
        np.testing.assert_array_equal(b["tokens"].numpy(),
                                      data.batch_at(s)["tokens"])
