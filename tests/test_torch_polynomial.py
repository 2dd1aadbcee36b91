"""The port's polynomial codes (§5) against the JAX package's.

The evaluation points and interpolation matrices are numpy float64 on both
sides, so they are equal bit for bit.  The products are float32 on both
sides (``tensordot`` and ``matmul``), held to each other at 1e-5 and to the
float64 product at ``tests/test_polynomial.py``'s tolerances; then that
file's cases on the port, and the latency strategies' plans and results
against the reference's.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cuda import cuda, jax_on_cpu  # noqa: F401  (fixtures)
from repro.core import polynomial as jpoly
from repro.core.simulation import LOCAL_CLUSTER as J_LOCAL
from repro_torch.core import polynomial as poly
from repro_torch.core.simulation import LOCAL_CLUSTER
from repro_torch.core.traces import controlled_traces

pytestmark = pytest.mark.usefixtures("jax_on_cpu")   # the JAX reference on the CPU

torch.set_num_threads(1)   # small shapes; leave the cores to the timing-sensitive cluster tests


def _setup(a=2, b=2, n=5, rows=24, ca=8, cb=6, seed=0):
    rng = np.random.default_rng(seed)
    am = rng.standard_normal((rows, ca)).astype(np.float32)
    bm = rng.standard_normal((rows, cb)).astype(np.float32)
    d = rng.uniform(0.5, 1.5, rows).astype(np.float32)
    return poly.PolynomialCode(n=n, a=a, b=b), jpoly.PolynomialCode(n=n, a=a, b=b), am, bm, d


def _t(*arrays):
    return [torch.from_numpy(x) for x in arrays]


@pytest.mark.parametrize("points", ["chebyshev", "integer"])
@pytest.mark.parametrize("n,a,b", [(5, 2, 2), (12, 3, 3), (7, 2, 3)])
def test_points_and_interp_matrix_bit_equal(points, n, a, b):
    pc, jpc = poly.PolynomialCode(n, a, b, points), jpoly.PolynomialCode(n, a, b, points)
    np.testing.assert_array_equal(pc.xs, jpc.xs)
    nodes = list(range(n - a * b, n))
    np.testing.assert_array_equal(pc.interp_matrix(nodes), jpc.interp_matrix(nodes))


@pytest.mark.parametrize("case", [dict(), dict(a=3, b=3, n=12, ca=9, cb=9, rows=30, seed=1),
                                  dict(a=2, b=3, n=7, ca=6, cb=9, rows=16, seed=2)])
def test_encode_and_full_product_match_jax(case):
    pc, jpc, am, bm, d = _setup(**case)
    at, bt, dt = _t(am, bm, d)
    np.testing.assert_allclose(pc.encode_a(at).numpy(), np.asarray(jpc.encode_a(jnp.asarray(am))),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(pc.encode_b(bt).numpy(), np.asarray(jpc.encode_b(jnp.asarray(bm))),
                               rtol=1e-5, atol=1e-5)
    nodes = list(range(pc.n))[-pc.m:]
    got = pc.full_product(at, bt, dt, nodes=nodes)
    want = jpc.full_product(jnp.asarray(am), jnp.asarray(bm), jnp.asarray(d), nodes=nodes)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


class TestPolynomialCode:
    """``tests/test_polynomial.py`` on the port."""

    def test_full_product_any_m_nodes(self):
        pc, _, am, bm, d = _setup()
        want = am.T @ (d[:, None] * bm)
        for nodes in itertools.combinations(range(5), 4):
            got = pc.full_product(*_t(am, bm, d), nodes=list(nodes))
            np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)

    def test_a3_b3_twelve_nodes(self):
        """The paper's Fig-12 configuration: a=b=3, n=12, any 9 decode."""
        pc, _, am, bm, d = _setup(a=3, b=3, n=12, ca=9, cb=9, rows=30, seed=1)
        want = am.T @ (d[:, None] * bm)
        got = pc.full_product(*_t(am, bm, d), nodes=[0, 2, 3, 5, 6, 7, 9, 10, 11])
        np.testing.assert_allclose(got.numpy(), want, rtol=5e-3, atol=5e-3)

    def test_not_enough_nodes_raises(self):
        with pytest.raises(ValueError):
            poly.PolynomialCode(n=3, a=2, b=2)
        pc = poly.PolynomialCode(n=5, a=2, b=2)
        with pytest.raises(ValueError):
            pc.interp_matrix([0, 1, 2])
        with pytest.raises(ValueError):
            poly.PolynomialCode(n=5, a=2, b=2, points="bogus")

    def test_integer_points_match_paper_encoding(self):
        """points="integer": node i stores A0 + i·A1 (paper §5 example)."""
        pc = poly.PolynomialCode(n=5, a=2, b=2, points="integer")
        am = np.random.default_rng(2).standard_normal((8, 4)).astype(np.float32)
        coded = pc.encode_a(torch.from_numpy(am))
        a0, a1 = np.split(am, 2, axis=1)
        np.testing.assert_allclose(coded[0].numpy(), a0, rtol=1e-6)
        np.testing.assert_allclose(coded[2].numpy(), a0 + 2 * a1, rtol=1e-5)

    def test_without_diag(self):
        pc, _, am, bm, _ = _setup()
        got = pc.full_product(*_t(am, bm), None, nodes=[1, 2, 3, 4])
        np.testing.assert_allclose(got.numpy(), am.T @ bm, rtol=2e-3, atol=2e-3)

    def test_columns_must_split_evenly(self):
        pc = poly.PolynomialCode(n=5, a=2, b=2)
        with pytest.raises(ValueError):
            pc.encode_a(torch.zeros(4, 5))


@pytest.mark.parametrize("stragglers", [0, 1, 2])
def test_strategies_plan_and_execute_like_jax(stragglers):
    """``PolyCodedStrategy`` and ``PolyS2C2Strategy``: the same allocation
    from the same predicted speeds, and the same iteration result."""
    traces = controlled_traces(12, 6, n_stragglers=stragglers, seed=3)
    for cls, jcls in ((poly.PolyCodedStrategy, jpoly.PolyCodedStrategy),
                      (poly.PolyS2C2Strategy, jpoly.PolyS2C2Strategy)):
        port, ref = cls(12, 9, 60000), jcls(12, 9, 60000)
        for it, speeds in enumerate(traces):
            plan, jplan = port.plan(traces[it - 1] if it else None), \
                ref.plan(traces[it - 1] if it else None)
            if jplan is None:
                assert plan is None
            else:
                np.testing.assert_array_equal(plan.begin, jplan.begin)
                np.testing.assert_array_equal(plan.count, jplan.count)
            got = port.execute(plan, speeds, LOCAL_CLUSTER, np.random.default_rng(it))
            want = ref.execute(jplan, speeds, J_LOCAL, np.random.default_rng(it))
            assert got.makespan == want.makespan
            np.testing.assert_array_equal(got.useful_rows, want.useful_rows)
            np.testing.assert_array_equal(got.wasted_rows, want.wasted_rows)


@pytest.mark.cuda
def test_cuda_full_product_matches_cpu(cuda):
    """The Hessian path on the card, TF32 off: the float64 product and the
    CPU run's, at ``test_a3_b3_twelve_nodes``' tolerance (the interpolation
    weights amplify float32 rounding, which differs in order between the
    two devices)."""
    pc, _, am, bm, d = _setup(a=3, b=3, n=12, ca=9, cb=9, rows=30, seed=1)
    nodes = [0, 2, 3, 5, 6, 7, 9, 10, 11]
    got = pc.full_product(*(t.to(cuda) for t in _t(am, bm, d)), nodes=nodes)
    assert got.device.type == "cuda" and got.dtype == torch.float32
    want = am.astype(np.float64).T @ (d.astype(np.float64)[:, None] * bm)
    np.testing.assert_allclose(got.cpu().numpy(), want, rtol=5e-3, atol=5e-3)
    np.testing.assert_allclose(got.cpu().numpy(), pc.full_product(*_t(am, bm, d),
                                                                  nodes=nodes).numpy(),
                               rtol=5e-3, atol=5e-3)
