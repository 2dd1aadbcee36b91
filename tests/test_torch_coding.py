"""The port's MDS algebra against the JAX package's.

The generators and every decode table are numpy float64 on both sides, so
they must be bit-equal.  Encoding is float32 on both sides with sums taken
in another order, held at the JAX kernel tests' float32 tolerance (2e-4).
"""

import numpy as np
import pytest
import torch

from _torch_cuda import cuda, jax_on_cpu  # noqa: F401  (fixtures)
from repro.core import coding as jcoding
from repro_torch.core import coding

pytestmark = pytest.mark.usefixtures("jax_on_cpu")   # the JAX reference on the CPU

torch.set_num_threads(1)   # small shapes; leave the cores to the timing-sensitive cluster tests

KINDS = ["systematic_cauchy", "vandermonde", "chebyshev_vandermonde"]
SHAPES = [(6, 4), (12, 10), (5, 5)]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n,k", SHAPES)
def test_generator_bit_equal(kind, n, k):
    got = coding.make_generator(n, k, kind)
    want = jcoding.make_generator(n, k, kind)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    assert coding._check_mds(got) == jcoding._check_mds(want)


def test_cauchy_parity_and_bad_arguments_match():
    np.testing.assert_array_equal(coding._cauchy_parity(12, 10), jcoding._cauchy_parity(12, 10))
    for n, k, kind in [(3, 4, "systematic_cauchy"), (4, 2, "bogus")]:
        with pytest.raises(ValueError):
            coding.make_generator(n, k, kind)
        with pytest.raises(ValueError):
            jcoding.make_generator(n, k, kind)


@pytest.mark.parametrize("n,k,rows,d", [(6, 4, 1200, 64), (12, 10, 203, 17)])
def test_encode_matches_jax(n, k, rows, d):
    import jax.numpy as jnp
    a = np.random.default_rng(rows).standard_normal((rows, d)).astype(np.float32)
    got = coding.MDSCode(n, k).encode(torch.from_numpy(a))
    want = np.asarray(jcoding.MDSCode(n, k).encode(jnp.asarray(a)))
    assert got.shape == want.shape == (n, -(-rows // k), d)   # rows padded to k
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


# the JAX package encodes any array whose leading axis is rows (a tensordot
# over axis 0): a vector, and blocks of more than two dims
BLOCK_SHAPES = [((9,), (5, 3)), ((9, 2, 2), (5, 3, 2, 2))]


@pytest.mark.parametrize("shape,coded", BLOCK_SHAPES)
def test_encode_takes_any_block_shape(shape, coded):
    import jax.numpy as jnp
    a = np.random.default_rng(len(shape)).standard_normal(shape).astype(np.float32)
    got = coding.MDSCode(5, 3).encode(torch.from_numpy(a))
    want = np.asarray(jcoding.MDSCode(5, 3).encode(jnp.asarray(a)))
    assert tuple(got.shape) == want.shape == coded
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,coded", BLOCK_SHAPES)
def test_cuda_encode_takes_any_block_shape(cuda, shape, coded):
    """The kernel's encode of the same shapes against the plain version."""
    a = torch.from_numpy(np.random.default_rng(len(shape)).standard_normal(shape)
                         .astype(np.float32))
    got = coding.MDSCode(5, 3).encode(a.to(cuda))
    want = coding.MDSCode(5, 3).encode(a)
    assert tuple(got.shape) == coded
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=2e-4, atol=2e-4)


def test_decode_matrix_bit_equal():
    code, jcode = coding.MDSCode(12, 10), jcoding.MDSCode(12, 10)
    workers = [11, 0, 3, 2, 5, 4, 7, 6, 9, 10]
    np.testing.assert_array_equal(code.decode_matrix(workers), jcode.decode_matrix(workers))


def _random_coverage(rng, n, k, chunks):
    """(chunks, n) coverage with at least k workers on every chunk."""
    cov = rng.random((chunks, n)) < 0.7
    for c in range(chunks):
        if cov[c].sum() < k:
            cov[c, rng.choice(n, size=k, replace=False)] = True
    return cov


@pytest.mark.parametrize("n,k,chunks", [(6, 4, 12), (12, 10, 20)])
def test_decode_tables_bit_equal(n, k, chunks):
    rng = np.random.default_rng(n)
    code, jcode = coding.MDSCode(n, k), jcoding.MDSCode(n, k)
    for _ in range(3):
        cov = _random_coverage(rng, n, k, chunks)
        dms, ids = code.chunk_decode_weights_compact(cov)
        jdms, jids = jcode.chunk_decode_weights_compact(cov)
        np.testing.assert_array_equal(ids, jids)
        assert (np.diff(ids, axis=1) > 0).all()          # sorted responders
        np.testing.assert_array_equal(dms, jdms)
        np.testing.assert_array_equal(code.decode_submats(ids, use_cache=False),
                                      jcode.decode_submats(jids, use_cache=False))
        np.testing.assert_array_equal(code.chunk_decode_weights(cov),
                                      jcode.chunk_decode_weights(cov))


def test_decode_weights_recover_the_blocks():
    """W[c] @ partials[:, c] gives back the data blocks, in float64."""
    code = coding.MDSCode(6, 4)
    rng = np.random.default_rng(0)
    blocks = rng.standard_normal((4, 5, 3))
    coded = np.tensordot(code.generator, blocks, axes=([1], [0]))   # (6, 5, 3)
    cov = _random_coverage(rng, 6, 4, 5)
    w = code.chunk_decode_weights(cov)
    partials = np.where(cov.T[:, :, None], coded, 0.0)              # unused zeroed
    got = np.einsum("ckn,ncr->kcr", w, partials)
    np.testing.assert_allclose(got, blocks, rtol=1e-12, atol=1e-12)


def test_undecodable_coverage_raises_like_jax():
    cov = np.ones((4, 6), bool)
    cov[2, :3] = False
    for c in (coding.MDSCode(6, 4), jcoding.MDSCode(6, 4)):
        with pytest.raises(ValueError, match="decodability violated"):
            c.chunk_decode_weights(cov)


def test_cache_statistics_match_jax():
    rng = np.random.default_rng(5)
    code, jcode = coding.MDSCode(12, 10), jcoding.MDSCode(12, 10)
    covs = [_random_coverage(rng, 12, 10, 20) for _ in range(3)]
    for cov in covs + covs[:2]:
        code.chunk_decode_weights(cov)
        jcode.chunk_decode_weights(cov)
        code.chunk_decode_weights_compact(cov)
        jcode.chunk_decode_weights_compact(cov)
        assert code.decode_cache_info() == jcode.decode_cache_info()
    info = code.decode_cache_info()
    assert info["patterns"] == 3 and info["hits"] > 0 and info["misses"] > 0
    w = code.chunk_decode_weights(covs[0])
    assert not w.flags.writeable                       # shared with the cache
    code.decode_cache_clear()
    assert code.decode_cache_info() == {"hits": 0, "misses": 0, "submats": 0, "patterns": 0}


def test_lru_caps_evict_oldest():
    code = coding.MDSCode(6, 4)
    object.__setattr__(code, "_PATTERN_CACHE_CAP", 2)
    rng = np.random.default_rng(9)
    for _ in range(4):
        code.chunk_decode_weights(_random_coverage(rng, 6, 4, 8))
    assert code.decode_cache_info()["patterns"] == 2


def test_pad_and_split_rows():
    a = torch.arange(14.0).reshape(7, 2)
    p = coding.pad_rows(a, 4)
    assert p.shape == (8, 2) and torch.equal(p[:7], a) and torch.all(p[7] == 0)
    assert coding.split_rows(p, 4).shape == (4, 2, 2)
    with pytest.raises(ValueError, match="not divisible"):
        coding.split_rows(a, 4)


# -- the rest of the coding API: decode, decode_concat, decode_from_any_k,
# coverage_counts, coded_partition_shards ------------------------------------

def test_decode_concat_every_pattern():
    """``tests/test_coding.py::TestEncodeDecode::test_roundtrip_every_pattern``
    on the port, and against the JAX package's ``decode_concat`` of the same
    partials (float32, 2e-4)."""
    import itertools

    import jax.numpy as jnp
    code, jcode = coding.MDSCode(n=6, k=4), jcoding.MDSCode(n=6, k=4)
    rng = np.random.default_rng(0)
    a = rng.standard_normal((40, 8)).astype(np.float32)
    x = rng.standard_normal((8,)).astype(np.float32)
    partials = code.encode(torch.from_numpy(a)) @ torch.from_numpy(x)      # (6, 10)
    want = a.astype(np.float64) @ x.astype(np.float64)
    for workers in itertools.combinations(range(6), 4):
        got = code.decode_concat(partials[list(workers)], list(workers))
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
        ref = jcode.decode_concat(jnp.asarray(partials[list(workers)].numpy()), list(workers))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-4)


def test_decode_matrix_operand():
    """``tests/test_coding.py::TestEncodeDecode::test_matrix_operand`` on the
    port: a coded matmul decodes from workers given out of order."""
    code = coding.MDSCode(n=5, k=3)
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.standard_normal((30, 6)).astype(np.float32))
    xm = torch.from_numpy(rng.standard_normal((6, 7)).astype(np.float32))
    partials = code.encode(a) @ xm                                          # (5, 10, 7)
    blocks = code.decode(partials[[4, 2, 0]], [4, 2, 0])
    assert blocks.shape == (3, 10, 7) and blocks.dtype == torch.float32
    got = code.decode_concat(partials[[4, 2, 0]], [4, 2, 0])
    np.testing.assert_allclose(got.numpy(), (a @ xm).numpy(), rtol=2e-4, atol=2e-4)


def test_decode_of_float64_results_is_float64():
    code, jcode = coding.MDSCode(n=5, k=3), jcoding.MDSCode(n=5, k=3)
    rng = np.random.default_rng(2)
    res = rng.standard_normal((3, 4, 2))
    got = code.decode(torch.from_numpy(res), [1, 3, 4])
    assert got.dtype == torch.float64
    want = (jcode.decode_matrix([1, 3, 4]) @ res.reshape(3, -1)).reshape(res.shape)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError):
        code.decode(torch.from_numpy(res), [1, 3])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_decode_from_any_k_matches_jax(dtype):
    """Solved in float64 for a float64 ``g_sub``, else in float32, as the
    reference chooses; with x64 off the JAX package solves in float32."""
    import jax.numpy as jnp
    code = coding.MDSCode(n=7, k=4)
    rng = np.random.default_rng(3)
    workers = [6, 1, 4, 2]
    blocks = rng.standard_normal((4, 5, 3))
    results = np.einsum("wk,krc->wrc", code.generator[workers], blocks)
    g_sub = code.generator[workers].astype(dtype)
    got = coding.decode_from_any_k(torch.from_numpy(g_sub), torch.from_numpy(results))
    assert got.dtype == torch.float64 and got.shape == results.shape
    if dtype == np.float64:
        np.testing.assert_allclose(got.numpy(), blocks, rtol=1e-10, atol=1e-10)
    else:
        want = jcoding.decode_from_any_k(jnp.asarray(g_sub), jnp.asarray(results, jnp.float32))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(got.numpy(), blocks, rtol=2e-4, atol=2e-4)


def test_coverage_counts_and_partition_shards_match_jax():
    import jax.numpy as jnp
    from repro.core import coded_matmul as jcm
    from repro.core import s2c2 as js2c2
    from repro_torch.core import coded_matmul
    from repro_torch.core import s2c2
    speeds = np.array([1.0, 0.9, 0.2, 1.0, 0.5, 0.95])
    got = s2c2.coverage_counts(s2c2.general_allocation(speeds, 4, 12))
    want = js2c2.coverage_counts(js2c2.general_allocation(speeds, 4, 12))
    np.testing.assert_array_equal(got, want)
    assert (got >= 4).all()
    a = np.random.default_rng(4).standard_normal((41, 9)).astype(np.float32)
    shards = coded_matmul.coded_partition_shards(coding.MDSCode(6, 4), torch.from_numpy(a))
    ref = jcm.coded_partition_shards(jcoding.MDSCode(6, 4), jnp.asarray(a))
    assert tuple(shards.shape) == ref.shape == (6, 11, 9)
    np.testing.assert_allclose(shards.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
def test_cuda_decode_and_partition_shards(cuda):
    """The same API on the card: the shards through the encode kernel, the
    decode on the card's tensors, against the CPU run."""
    from repro_torch.core import coded_matmul
    code = coding.MDSCode(n=6, k=4)
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.standard_normal((40, 8)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((8,)).astype(np.float32))
    on_card = coded_matmul.coded_partition_shards(code, a.to(cuda))
    on_cpu = coded_matmul.coded_partition_shards(code, a)
    np.testing.assert_allclose(on_card.cpu().numpy(), on_cpu.numpy(), rtol=2e-4, atol=2e-4)
    got = code.decode_concat((on_card @ x.to(cuda))[[5, 0, 3, 2]], [5, 0, 3, 2])
    assert got.device.type == "cuda"
    np.testing.assert_allclose(got.cpu().numpy(), (a @ x).numpy(), rtol=2e-4, atol=2e-4)
    g_sub = torch.as_tensor(code.generator[[5, 0, 3, 2]], device=cuda)
    blocks = coding.decode_from_any_k(g_sub, (on_card @ x.to(cuda))[[5, 0, 3, 2]].double())
    np.testing.assert_allclose(blocks.reshape(-1).cpu().numpy(), (a @ x).numpy(), rtol=2e-4,
                               atol=2e-4)
