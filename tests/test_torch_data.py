"""The port's data pipeline (``repro_torch.data``) against the reference:
``batch_at(step)`` must give the reference's bits for every ``(seed,
step)``, embeddings and prefixes included; the prefetcher keeps its order,
resumes mid-stream and closes."""

import numpy as np
import pytest

from repro.data import pipeline as ref_pipeline
from repro_torch.data import DataConfig, Prefetcher, SyntheticLMDataset

CONFIGS = {
    "tokens": dict(vocab_size=100, seq_len=16, global_batch=4),
    "embeds": dict(vocab_size=512, seq_len=8, global_batch=2, embed_dim=32),
    "prefix": dict(vocab_size=300, seq_len=12, global_batch=3, embed_dim=16, prefix_len=5),
    "prefix-no-embed": dict(vocab_size=64, seq_len=6, global_batch=2, prefix_len=3),
    "skewed": dict(vocab_size=1000, seq_len=32, global_batch=2, zipf_a=2.0, repeat_p=0.8),
}


@pytest.mark.parametrize("seed", [0, 3, 12345])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_batch_at_is_the_references_bit_for_bit(name, seed):
    kw = dict(CONFIGS[name], seed=seed)
    ds = SyntheticLMDataset(DataConfig(**kw))
    ref = ref_pipeline.SyntheticLMDataset(ref_pipeline.DataConfig(**kw))
    for step in (0, 1, 7, 1000):
        got, want = ds.batch_at(step), ref.batch_at(step)
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape
            np.testing.assert_array_equal(got[key], want[key])


def test_data_determinism_and_resume():
    ds = SyntheticLMDataset(DataConfig(vocab_size=100, seq_len=16, global_batch=4, seed=3))
    b1, b2 = ds.batch_at(7), ds.batch_at(7)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    assert not np.array_equal(ds.batch_at(8)["tokens"], b1["tokens"])
    np.testing.assert_array_equal(b1["tokens"][:, 1:], b1["labels"][:, :-1])
    it = iter(ds)
    np.testing.assert_array_equal(next(it)["tokens"], ds.batch_at(0)["tokens"])
    np.testing.assert_array_equal(next(it)["tokens"], ds.batch_at(1)["tokens"])


@pytest.mark.parametrize("start", [0, 5])
def test_prefetcher_orders_resumes_and_closes(start):
    ds = SyntheticLMDataset(DataConfig(vocab_size=50, seq_len=8, global_batch=2))
    pf = Prefetcher(ds, start_step=start, depth=2)
    got = [pf.next() for _ in range(4)]
    pf.close()
    assert [s for s, _ in got] == list(range(start, start + 4))
    for step, batch in got:
        np.testing.assert_array_equal(batch["tokens"], ds.batch_at(step)["tokens"])
    assert not pf._thread.is_alive()
