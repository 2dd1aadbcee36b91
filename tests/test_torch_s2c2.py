"""The port's allocators against the JAX package's.

The host allocators are numpy on both sides and must give identical
integers.  ``general_allocation_torch`` must give exactly the integers of
``general_allocation_jax``: it does the float32 arithmetic XLA compiles
(a sequential suffix sum, the share as one fused multiply-add).  It must also keep the invariants ``TestHostJaxParity`` checks
(Σcount == k·C, 0 ≤ count ≤ C, coverage ≥ k, zero speed ⇒ zero work).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import s2c2 as js2c2
from repro_torch.core import s2c2

torch.set_num_threads(1)   # small shapes; leave the cores to the timing-sensitive cluster tests

CHUNKS = 48


def _random_cases(seed, trials, lo=0.05, hi=5.0):
    rng = np.random.default_rng(seed)
    for _ in range(trials):
        n = int(rng.integers(3, 16))
        k = int(rng.integers(1, n))
        yield rng.uniform(lo, hi, n), k


def test_general_allocation_identical_to_host_jax():
    for speeds, k in _random_cases(42, 200):
        for chunks in (CHUNKS, 20):
            got = s2c2.general_allocation(speeds, k, chunks)
            want = js2c2.general_allocation(speeds, k, chunks)
            np.testing.assert_array_equal(got.count, want.count)
            np.testing.assert_array_equal(got.begin, want.begin)
            np.testing.assert_array_equal(got.masks(), want.masks())


def test_basic_allocation_identical():
    rng = np.random.default_rng(3)
    for _ in range(50):
        n = int(rng.integers(3, 16))
        k = int(rng.integers(1, n))
        stragglers = rng.choice(n, size=int(rng.integers(0, n - k + 1)), replace=False)
        got = s2c2.basic_allocation(n, k, CHUNKS, stragglers)
        want = js2c2.basic_allocation(n, k, CHUNKS, stragglers)
        np.testing.assert_array_equal(got.count, want.count)
        np.testing.assert_array_equal(got.begin, want.begin)


def test_host_errors_and_helpers_match():
    for fn in (s2c2.general_allocation, js2c2.general_allocation):
        with pytest.raises(ValueError, match="infeasible"):
            fn([1.0, 0.0, 0.0, 0.0], k=2, chunks=4)
        with pytest.raises(ValueError, match="all speeds are zero"):
            fn([0.0, 0.0], k=1, chunks=4)
    al = s2c2.general_allocation([1.0, 1.0, 0.5, 2.0], 2, 10)
    jal = js2c2.general_allocation([1.0, 1.0, 0.5, 2.0], 2, 10)
    speeds = [0.9, 1.1, 0.4, 2.0]
    assert s2c2.expected_makespan(al, speeds, 7) == js2c2.expected_makespan(jal, speeds, 7)
    np.testing.assert_array_equal(al.coverage(), jal.coverage())
    np.testing.assert_array_equal(al.work_fraction(), jal.work_fraction())


def _compare_torch_jax(speeds, k, chunks=CHUNKS):
    begin, count = s2c2.general_allocation_torch(torch.as_tensor(speeds), k, chunks)
    jbegin, jcount = js2c2.general_allocation_jax(jnp.asarray(speeds, jnp.float32), k, chunks)
    assert begin.dtype == count.dtype == torch.int32
    np.testing.assert_array_equal(count.numpy(), np.asarray(jcount))
    np.testing.assert_array_equal(begin.numpy(), np.asarray(jbegin))
    count = count.numpy()
    assert count.sum() == k * chunks
    assert (count >= 0).all() and (count <= chunks).all()
    assert (s2c2.allocation_masks(begin.numpy(), count, chunks).sum(0) >= k).all()
    return count


def test_torch_allocator_exact_on_random_speeds():
    for speeds, k in _random_cases(7, 40):
        _compare_torch_jax(speeds, k)


def test_torch_allocator_exact_with_zero_speed_workers():
    rng = np.random.default_rng(7)
    for _ in range(20):
        n = int(rng.integers(4, 12))
        k = int(rng.integers(1, n - 1))
        speeds = rng.uniform(0.5, 2.0, n)
        dead = rng.choice(n, size=1)
        speeds[dead] = 0.0
        count = _compare_torch_jax(speeds, k)
        assert count[dead] == 0


def test_torch_allocator_exact_on_ties_and_stragglers():
    count = _compare_torch_jax(np.ones(6), k=4)
    assert count.min() == count.max() == 4 * CHUNKS // 6
    rng = np.random.default_rng(11)
    for _ in range(30):
        n = int(rng.integers(3, 10))
        _compare_torch_jax(np.round(rng.uniform(0.5, 2.0, n), 1), int(rng.integers(1, n)))
    # the paper's controlled setting: 5x-slower stragglers, main-path shape
    speeds = np.r_[rng.uniform(0.8, 1.0, 10), 0.2, 0.2]
    count = _compare_torch_jax(speeds, k=10, chunks=20)
    assert count[-2:].max() < count[:10].min()


def test_torch_allocator_within_two_chunks_of_host():
    """The remainder policies differ; per-worker counts stay within 2 chunks."""
    for speeds, k in _random_cases(3, 100, lo=0.2, hi=3.0):
        _, count = s2c2.general_allocation_torch(torch.as_tensor(speeds), k, CHUNKS)
        host = s2c2.general_allocation(speeds, k, CHUNKS)
        assert np.abs(count.numpy() - host.count).max() <= 2
