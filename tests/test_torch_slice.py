"""The whole slice on the CPU: encode → plan → assigned-chunks product → decode.

The port's ``CodedMatvec`` (device="cpu", so every kernel is its plain
version) is held against the JAX package's composition of the same steps —
``MDSCode.encode``, ``general_allocation``, ``masked_partial_products`` per
worker, then the weighted decode of ``core/coded_matmul.py:145-159`` — at
3e-3, the tolerance of ``tests/test_runtime.py:193``, and against a float64
oracle at the same tolerance.  Shapes: the quickstart's (6, 4) code with
C = 12 over 1200 × 64, and the main path's (12, 10) code with C = 20.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import coded_matmul as jcm
from repro.core import coding as jcoding
from repro.core import s2c2 as js2c2
from repro_torch.core import coded_matmul, coding, s2c2
from repro_torch.kernels import ops

torch.set_num_threads(1)   # small shapes; leave the cores to the timing-sensitive cluster tests

TOL = dict(rtol=3e-3, atol=3e-3)
CONFIGS = {"quickstart": (6, 4, 12, 1200, 64), "main_path": (12, 10, 20, 2000, 48)}
SPEEDS = {
    "equal": lambda n: np.ones(n),
    "one_slow": lambda n: np.r_[np.ones(n - 2), 0.25, 0.95],
    "two_5x_stragglers": lambda n: np.r_[np.linspace(0.8, 1.0, n - 2), 0.2, 0.2],
    "one_dead": lambda n: np.r_[0.0, np.random.default_rng(n).uniform(0.3, 1.0, n - 1)],
}


def _jax_composition(a, x, n, k, chunks, speeds):
    code = jcoding.MDSCode(n, k)
    coded = code.encode(jnp.asarray(a))
    rows = coded.shape[1]
    pad = (-rows) % chunks
    coded = jnp.pad(coded, ((0, 0), (0, pad), (0, 0)))
    rows += pad
    alloc = js2c2.general_allocation(speeds, k, chunks)
    partials = jnp.stack([
        jcm.masked_partial_products(coded[w], jnp.asarray(x), jnp.int32(alloc.begin[w]),
                                    jnp.int32(alloc.count[w]), chunks) for w in range(n)])
    weights = jnp.asarray(code.chunk_decode_weights(alloc.masks().T), jnp.float32)
    dec = jnp.einsum("ckn,ncr->ckr", weights, partials)       # (chunks, k, rpc)
    return np.asarray(jnp.swapaxes(dec, 0, 1).reshape(k * rows))


@pytest.mark.parametrize("speeds", SPEEDS)
@pytest.mark.parametrize("config", CONFIGS)
def test_slice_matches_jax_and_float64(config, speeds):
    n, k, chunks, rows, d = CONFIGS[config]
    rng = np.random.default_rng(rows + d)
    a = rng.standard_normal((rows, d)).astype(np.float32)
    x = rng.standard_normal(d).astype(np.float32)
    sp = SPEEDS[speeds](n)
    ops.reset_launch_counts()

    cm = coded_matmul.CodedMatvec(coding.MDSCode(n, k), chunks, device="cpu")
    coded = cm.shard(torch.from_numpy(a))
    alloc = s2c2.general_allocation(sp, k, chunks)
    y = cm.apply(coded, torch.from_numpy(x), *cm.plan_tables(alloc)).numpy()

    want = _jax_composition(a, x, n, k, chunks, sp)
    assert y.shape == want.shape and y.dtype == np.float32
    np.testing.assert_allclose(y, want, **TOL)
    np.testing.assert_allclose(y[:rows], coded_matmul.oracle_matvec(a, x), **TOL)
    assert ops.launch_counts() == dict.fromkeys(ops.launch_counts(), 0)


@pytest.mark.parametrize("n,k,chunks,rows", [(5, 3, 6, 120), (12, 10, 20, 3277),
                                             (4, 3, 8, 97)])
def test_apply_keeps_the_row_order_when_partitions_are_padded(n, k, chunks, rows):
    """D/k not a multiple of C (PageRank's 32,768 rows on the (12, 10) code
    and C = 20 are such a D): y[:D] is still A @ x in A's row order."""
    rng = np.random.default_rng(rows)
    a = rng.standard_normal((rows, 8)).astype(np.float32)
    x = rng.standard_normal(8).astype(np.float32)
    cm = coded_matmul.CodedMatvec(coding.MDSCode(n, k), chunks, device="cpu")
    coded = cm.shard(torch.from_numpy(a))
    assert coded.shape[1] % chunks == 0 and coded.shape[1] * k >= rows
    alloc = s2c2.general_allocation(np.linspace(0.3, 1.0, n), k, chunks)
    y = cm.apply(coded, torch.from_numpy(x), *cm.plan_tables(alloc)).numpy()
    assert y.shape == (k * coded.shape[1],)
    np.testing.assert_allclose(y[:rows], coded_matmul.oracle_matvec(a, x), **TOL)
    np.testing.assert_allclose(y[rows:], 0.0, **TOL)       # parity decodes leave rounding


def test_masked_partial_products_matches_jax():
    rng = np.random.default_rng(0)
    part = rng.standard_normal((60, 16)).astype(np.float32)
    x = rng.standard_normal(16).astype(np.float32)
    for begin, count in [(0, 6), (4, 3), (5, 0), (2, 6)]:
        got = coded_matmul.masked_partial_products(torch.from_numpy(part), torch.from_numpy(x),
                                                   begin, count, 6)
        want = jcm.masked_partial_products(jnp.asarray(part), jnp.asarray(x),
                                           jnp.int32(begin), jnp.int32(count), 6)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


def test_apply_reads_only_assigned_chunks():
    """The product is taken over the k·C assigned blocks alone: NaN in an
    unassigned chunk of a worker's partition cannot reach y."""
    n, k, chunks = 6, 4, 12
    a = torch.randn(1200, 32, generator=torch.Generator().manual_seed(0))
    cm = coded_matmul.CodedMatvec(coding.MDSCode(n, k), chunks, device="cpu")
    coded = cm.shard(a)
    alloc = s2c2.general_allocation([1.0, 1.0, 0.9, 1.0, 0.25, 0.95], k, chunks)
    rpc = coded.shape[1] // chunks
    for w in range(n):
        for c in np.flatnonzero(~alloc.masks()[w]):
            coded[w, c * rpc:(c + 1) * rpc] = float("nan")
    x = torch.randn(32, generator=torch.Generator().manual_seed(1))
    y = cm.apply(coded, x, *cm.plan_tables(alloc))
    assert torch.isfinite(y).all()
    np.testing.assert_allclose(y.numpy(), coded_matmul.oracle_matvec(a.numpy(), x.numpy()),
                               **TOL)


def test_plan_tables_layout():
    cm = coded_matmul.CodedMatvec(coding.MDSCode(6, 4), 12, device="cpu")
    alloc = s2c2.general_allocation([1.0, 1.0, 0.9, 1.0, 0.25, 0.95], 4, 12)
    begin, count, weights, responders = cm.plan_tables(alloc)
    assert begin.dtype == count.dtype == responders.dtype == torch.int64
    assert weights.shape == (12, 4, 4) and weights.dtype == torch.float32
    assert (responders.diff(dim=1) > 0).all()                    # sorted responders
    block_ids, gather = cm._index_tables(begin.numpy(), count.numpy(), responders.numpy())
    assert block_ids.shape == (4 * 12,) and gather.shape == (12, 4)
    # each gathered partial is the responder's own block of that chunk
    np.testing.assert_array_equal(block_ids[gather], responders.numpy() * 12
                                  + np.arange(12)[:, None])
    with pytest.raises(ValueError, match="does not match"):
        cm.plan_tables(s2c2.general_allocation(np.ones(6), 4, 10))
