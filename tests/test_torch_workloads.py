"""The paper's applications on the port, at ``tests/test_system.py``'s sizes.

Logistic regression, the SVM, PageRank and 3-hop graph filtering run
through ``repro_torch.workloads``, every matvec through the port's
``CodedMatvec`` (encode once, then ``plan_tables`` and ``apply`` under a
fresh S²C² allocation), on the CPU with the kernels' plain versions and,
in the ``cuda`` twins, on the card.  Each is held to the JAX package's
host-side coded matvec (``coded_matvec_host``) on the same data and to the
uncoded float64 iteration, with that file's tolerances; the port computes
in float32 where the host path reads float32 partitions in float64.  Last,
``TestPaperHeadlineNumbers`` on the port's simulator.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cuda import cuda, jax_on_cpu  # noqa: F401  (fixtures)
from repro.core import coding as jcoding
from repro.data import pipeline as jpipe
from repro_torch.core.coded_matmul import CodedMatvec
from repro_torch.core.coding import MDSCode
from repro_torch.core.simulation import LOCAL_CLUSTER, simulate_run
from repro_torch.core.strategies import GeneralS2C2, MDSCoded
from repro_torch.core.traces import controlled_traces
from repro_torch.data.pipeline import laplacian_matrix, make_graph, make_lr_dataset
from repro_torch.workloads import coded_gradient_descent, gd_gradient, graph_filter, pagerank
from test_system import coded_matvec_host

pytestmark = pytest.mark.usefixtures("jax_on_cpu")   # the JAX reference on the CPU

torch.set_num_threads(1)   # small shapes; leave the cores to the timing-sensitive cluster tests


class _Coded:
    """One matrix on both stacks: the port's coded state on ``device`` and
    the JAX package's coded partitions as a host array."""

    def __init__(self, mat, n, k, chunks, device):
        self.cm = CodedMatvec(MDSCode(n, k), chunks, device=device)
        self.coded = self.cm.shard(torch.as_tensor(mat, dtype=torch.float32, device=device))
        self.jcode = jcoding.MDSCode(n=n, k=k)
        self.jcoded = np.asarray(self.jcode.encode(jnp.asarray(mat)))
        self.chunks = chunks
        self.device = device

    def tensor(self, arr):
        return torch.as_tensor(arr, dtype=torch.float32, device=self.device)

    def jax(self, x, speeds):
        return coded_matvec_host(self.jcode, self.jcoded, x, speeds, self.chunks)


def _numpy(t):
    return t.cpu().double().numpy()


def _gradient_descent(device, loss):
    a, y, _ = make_lr_dataset(rows=240, cols=16, seed=0)
    c = _Coded(a, 6, 4, 12, device)
    speeds = np.array([1, 1, 0.9, 0.8, 0.3, 1.0])
    w = _numpy(coded_gradient_descent(c.cm, c.coded, c.tensor(a), c.tensor(y), loss, 30,
                                      lambda it: speeds, lr=0.5))
    w_jax, w_ref = np.zeros(16), np.zeros(16)
    lr = 0.5 / a.shape[0]

    def step(w_, ax):
        margin = y * ax
        if loss == "logistic":
            return w_ - lr * (a.T @ (-y / (1 + np.exp(margin))))
        return w_ - lr * (a.T @ (-y * (margin < 1)) + 1e-3 * w_)

    for _ in range(30):
        w_jax = step(w_jax, c.jax(w_jax, speeds)[: a.shape[0]])
        w_ref = step(w_ref, a @ w_ref)
    np.testing.assert_allclose(w, w_ref, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(w, w_jax, rtol=1e-4, atol=1e-6)
    assert ((a @ w > 0) * 2 - 1 == y).mean() > 0.8


def _pagerank(device):
    adj = make_graph(120, 6, seed=1)
    col = adj.sum(0, keepdims=True)
    m = adj / np.maximum(col, 1)
    m[:, col[0] == 0] = 1.0 / 120
    c = _Coded(m, 5, 3, 10, device)
    d = 0.85
    speeds = np.array([1, 1, 1, 0.2, 0.9])
    r = _numpy(pagerank(c.cm, c.coded, 120, 15, lambda it: speeds, damping=d))
    r_jax = r_ref = np.ones(120) / 120
    for _ in range(15):
        r_jax = (1 - d) / 120 + d * c.jax(r_jax, speeds)[:120]
        r_ref = (1 - d) / 120 + d * (m @ r_ref)
    np.testing.assert_allclose(r, r_ref, rtol=1e-3, atol=1e-7)
    np.testing.assert_allclose(r, r_jax, rtol=1e-3, atol=1e-7)
    assert r.sum() == pytest.approx(1.0, rel=1e-2)


def _graph_filter(device):
    lap = laplacian_matrix(make_graph(96, 5, seed=2))
    c = _Coded(lap, 4, 3, 8, device)
    x = np.random.default_rng(0).standard_normal(96)
    speeds = np.array([1, 1, 0.5, 1.0])
    seen = []
    got = _numpy(graph_filter(c.cm, c.coded, c.tensor(x), 3, lambda it: speeds,
                              on_iter=lambda it, x_, y_: seen.append(it)))
    assert seen == [0, 1, 2]
    got_jax = want = x
    for _ in range(3):               # 3-hop filtering
        want = lap @ want
        got_jax = c.jax(got_jax, speeds)[:96]
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(got, got_jax, rtol=1e-2, atol=1e-2)


def test_workload_data_is_the_jax_packages():
    for got, want in zip(make_lr_dataset(rows=240, cols=16, seed=0),
                         jpipe.make_lr_dataset(rows=240, cols=16, seed=0)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(make_graph(120, 6, seed=1), jpipe.make_graph(120, 6, seed=1))


def test_coded_logistic_regression():
    _gradient_descent("cpu", "logistic")


def test_coded_svm():
    _gradient_descent("cpu", "hinge")


def test_gradient_needs_a_known_loss():
    t = torch.ones(2, 2)
    with pytest.raises(ValueError, match="logistic"):
        gd_gradient("squared", t, t[0], t[0], t[0])


def test_on_iter_sees_each_iterations_input_and_product():
    """``on_iter`` gets the iteration's input and its decoded product, before
    the loop moves on: here PageRank's r and M·r, held to M @ r."""
    adj = make_graph(60, 4, seed=3)
    m = adj / np.maximum(adj.sum(0, keepdims=True), 1)
    c = _Coded(m, 4, 3, 5, "cpu")
    seen = []

    def check(it, r, mr):
        seen.append(it)
        np.testing.assert_allclose(_numpy(mr), m @ _numpy(r), rtol=1e-5, atol=1e-6)

    pagerank(c.cm, c.coded, 60, 4, lambda it: np.ones(4), on_iter=check)
    assert seen == [0, 1, 2, 3]


def test_coded_pagerank():
    _pagerank("cpu")


def test_coded_graph_filtering():
    _graph_filter("cpu")


@pytest.mark.cuda
def test_cuda_coded_logistic_regression(cuda):
    _gradient_descent(cuda, "logistic")


@pytest.mark.cuda
def test_cuda_coded_svm(cuda):
    _gradient_descent(cuda, "hinge")


@pytest.mark.cuda
def test_cuda_coded_pagerank(cuda):
    _pagerank(cuda)


@pytest.mark.cuda
def test_cuda_coded_graph_filtering(cuda):
    _graph_filter(cuda)


class TestPaperHeadlineNumbers:
    """Latency claims validated in the simulated cloud (§7.2 conditions)."""

    def test_39pct_gain_low_misprediction(self):
        tr = controlled_traces(10, 15, n_stragglers=0, nonstraggler_variation=0.05, seed=11)
        mds = simulate_run(MDSCoded(10, 7, 600000), tr, LOCAL_CLUSTER)
        s2 = simulate_run(GeneralS2C2(10, 7, 600000), tr, LOCAL_CLUSTER)
        gain = (mds.mean_time - s2.mean_time) / s2.mean_time
        assert 0.30 < gain < 0.45, gain

    def test_mds_wasted_computation_vs_s2c2(self):
        tr = controlled_traces(10, 15, n_stragglers=1, seed=5)
        mds = simulate_run(MDSCoded(10, 7, 600000), tr, LOCAL_CLUSTER)
        s2 = simulate_run(GeneralS2C2(10, 7, 600000), tr, LOCAL_CLUSTER)
        assert mds.per_worker_wasted.sum() > 1.4 * s2.per_worker_wasted.sum()
