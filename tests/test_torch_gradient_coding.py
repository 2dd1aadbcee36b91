"""The port's cyclic gradient code against the JAX package's.

``B``, the decode weights and the re-balanced partition sizes are numpy
float64 made by the same calls on both sides, so they are equal bit for
bit.  ``encode_local`` is a float32 ``tensordot`` on both sides, held to
the JAX package's at 1e-6; then ``tests/test_gradient_coding.py``'s cases
on the port, with that file's tolerances.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cuda import cuda, jax_on_cpu  # noqa: F401  (fixtures)
from repro.core import gradient_coding as jgc
from repro_torch.core import gradient_coding as gc_mod
from repro_torch.core.gradient_coding import CyclicGradientCode

pytestmark = pytest.mark.usefixtures("jax_on_cpu")   # the JAX reference on the CPU

torch.set_num_threads(1)   # small shapes; leave the cores to the timing-sensitive cluster tests

CODES = [(4, 1, 0), (6, 2, 0), (8, 3, 5), (12, 2, 0), (12, 2, 7), (5, 0, 0)]


@pytest.mark.parametrize("n,s,seed", CODES)
def test_coefficients_bit_equal(n, s, seed):
    got = CyclicGradientCode(n=n, s=s, seed=seed).B
    want = jgc.CyclicGradientCode(n=n, s=s, seed=seed).B
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(gc_mod._cyclic_assignment(n, s), jgc._cyclic_assignment(n, s))


@pytest.mark.parametrize("n,s,seed", CODES)
def test_encode_local_and_decode_weights_match_jax(n, s, seed):
    port, ref = CyclicGradientCode(n=n, s=s, seed=seed), jgc.CyclicGradientCode(n=n, s=s,
                                                                               seed=seed)
    rng = np.random.default_rng(seed + 1)
    g_parts = rng.standard_normal((n, 7, 3)).astype(np.float32)
    for w in range(n):
        assert port.window(w) == ref.window(w)
        got = port.encode_local(torch.from_numpy(g_parts[port.window(w)]), w)
        want = ref.encode_local(jnp.asarray(g_parts[ref.window(w)]), jnp.int32(w))
        assert got.dtype == torch.float32 and tuple(got.shape) == (7, 3)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    for dead in list(itertools.combinations(range(n), s))[:6]:
        live = [w for w in range(n) if w not in dead]
        np.testing.assert_array_equal(port.decode_weights(live), ref.decode_weights(live))
    speeds = rng.uniform(0.2, 1.0, n)
    np.testing.assert_array_equal(port.balanced_part_sizes(speeds, 240),
                                  ref.balanced_part_sizes(speeds, 240))


@pytest.mark.parametrize("n,s", [(4, 1), (6, 2), (8, 2), (8, 3)])
def test_every_pattern_decodes(n, s):
    gc = CyclicGradientCode(n=n, s=s)
    rng = np.random.default_rng(0)
    g_parts = rng.standard_normal((n, 5))
    coded = np.stack([
        gc.encode_local(torch.from_numpy(g_parts[gc.window(w)]).float(), w).numpy()
        for w in range(n)])
    want = g_parts.sum(0)
    for dead in itertools.combinations(range(n), s):
        live = [w for w in range(n) if w not in dead]
        wts = gc.decode_weights(live)
        got = (wts[:, None] * coded).sum(0)
        # encode runs in f32; decode weights can amplify rounding by ~|a|
        amp = max(np.abs(wts).max(), 1.0)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=3e-6 * amp * (s + 1))


def test_zero_stragglers_identity():
    gc = CyclicGradientCode(n=5, s=0)
    np.testing.assert_allclose(gc.B, np.eye(5))


def test_redundancy_factor():
    """Each group computes exactly s+1 partitions (storage/compute cost)."""
    gc = CyclicGradientCode(n=8, s=2)
    assert all(len(gc.window(w)) == 3 for w in range(8))
    assert (np.count_nonzero(gc.B, axis=1) == 3).all()


def test_balanced_sizes():
    gc = CyclicGradientCode(n=6, s=1)
    speeds = np.array([1.0, 1.0, 0.2, 1.0, 1.0, 1.0])
    sizes = gc.balanced_part_sizes(speeds, batch=240)
    assert sizes.sum() == 240
    assert (sizes > 0).all()
    assert sizes[2] < max(sizes)


def test_invalid_params():
    with pytest.raises(ValueError):
        CyclicGradientCode(n=4, s=4)


@pytest.mark.cuda
def test_cuda_encode_local_matches_cpu(cuda):
    gc = CyclicGradientCode(n=12, s=2)
    g_parts = torch.from_numpy(np.random.default_rng(1).standard_normal((12, 5000))
                               .astype(np.float32))
    for w in range(12):
        got = gc.encode_local(g_parts[gc.window(w)].to(cuda), w)
        assert got.device.type == "cuda"
        np.testing.assert_allclose(got.cpu().numpy(),
                                   gc.encode_local(g_parts[gc.window(w)], w).numpy(),
                                   rtol=1e-6, atol=1e-6)
