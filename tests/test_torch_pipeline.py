"""The port's copy of the data pipeline against the JAX package's.

Both are numpy only, so the same seeds must give the same arrays, bit for
bit; then the checks of ``tests/test_substrate.py::TestPipeline`` on the
port's copy.
"""

import numpy as np
import pytest

from repro.data import pipeline as jpipe
from repro_torch.data import pipeline


@pytest.mark.parametrize("rows,cols,seed", [(240, 16, 0), (500, 20, 3), (64, 130, 7)])
def test_lr_dataset_bit_equal(rows, cols, seed):
    got = pipeline.make_lr_dataset(rows=rows, cols=cols, seed=seed)
    want = jpipe.make_lr_dataset(rows=rows, cols=cols, seed=seed)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n,degree,seed", [(120, 6, 1), (96, 5, 2), (300, 12, 0)])
def test_graph_and_laplacian_bit_equal(n, degree, seed):
    adj = pipeline.make_graph(n, degree, seed=seed)
    np.testing.assert_array_equal(adj, jpipe.make_graph(n, degree, seed=seed))
    np.testing.assert_array_equal(pipeline.laplacian_matrix(adj[: n // 2, : n // 2]),
                                  jpipe.laplacian_matrix(adj[: n // 2, : n // 2]))


@pytest.mark.parametrize("kw", [dict(vocab_size=100, batch=4, seq_len=8, seed=1),
                                dict(vocab_size=50, batch=2, seq_len=8, image_tokens=4,
                                     image_dim=16),
                                dict(vocab_size=300, batch=3, seq_len=5, frames=2,
                                     frame_dim=6, seed=9, cursor=17)])
def test_token_pipeline_bit_equal(kw):
    port, ref = pipeline.TokenPipeline(**kw), jpipe.TokenPipeline(**kw)
    for _ in range(3):
        got, want = port.next_batch(), ref.next_batch()
        assert got.keys() == want.keys()
        for key in want:
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key])
    assert port.state() == ref.state()


class TestPipeline:
    def test_deterministic_and_restartable(self):
        p1 = pipeline.TokenPipeline(vocab_size=100, batch=4, seq_len=8, seed=1)
        b1 = p1.next_batch()
        b2 = p1.next_batch()
        state = p1.state()
        b3 = p1.next_batch()
        p2 = pipeline.TokenPipeline(vocab_size=100, batch=4, seq_len=8, seed=1)
        p2.restore(state)
        b3r = p2.next_batch()
        np.testing.assert_array_equal(b3["tokens"], b3r["tokens"])
        assert not np.array_equal(b1["tokens"], b2["tokens"])

    def test_vlm_fields(self):
        p = pipeline.TokenPipeline(vocab_size=100, batch=2, seq_len=8, image_tokens=4,
                                   image_dim=16)
        b = p.next_batch()
        assert b["image_embeds"].shape == (2, 4, 16)

    def test_lr_dataset_learnable(self):
        a, y, w = pipeline.make_lr_dataset(rows=500, cols=20, seed=0)
        acc = ((a @ w > 0) * 2 - 1 == y).mean()
        assert acc > 0.8

    def test_graph(self):
        adj = pipeline.make_graph(64, 4, seed=0)
        lap = pipeline.laplacian_matrix(adj)
        np.testing.assert_allclose(lap.sum(1), 0.0, atol=1e-9)
