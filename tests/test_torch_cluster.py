"""The port's cluster engine (``repro_torch.cluster``) against the JAX package's.

On the CPU the port's engine runs with ``device="cpu"``: its
``KernelBackend`` and its kernel decode then use the kernels' plain
versions.  The JAX side runs as its own tests run it: ``KernelBackend``
in interpret mode, the rest on numpy.  Tolerances:

* ``compute_chunk`` against the JAX backend, rtol 1e-5: both compute in
  float32 over d ≤ 24, in another order;
* the float64 encode and decode, bit for bit: both are the same numpy
  calls on the same arrays;
* the float32 kernel decode, 1e-5: the JAX package's own kernel decode
  test holds it to 1e-3 against float64, and the two float32 decodes
  differ only in summation order over k ≤ 4 terms;
* two engines under forced systematic coverage (parity workers
  fail-stopped, so every decode weight is 0 or 1) with integer operands,
  bit for bit: every product and sum is exact, in float32 as in float64;
* two engines under a ``TraceInjector``, 1e-9: coverage, and so the
  decode weights, may differ between runs, and float64 decodes from two
  coverage sets agree to rounding.

On a card (``cuda`` marker): the backend against its own CPU run, the
kernel decode on the card, and a 12-worker round with exact launch counts.
"""

import collections
import os
import queue
import subprocess
import sys
import threading
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_cuda import cuda  # noqa: F401  (fixture)
from repro_torch import cluster as tcl
from repro_torch.cluster import transport as ttransport
from repro_torch.cluster.worker import KernelBackend, kernel_backend
from repro_torch.core import coding as tcoding
from repro_torch.core import simulation as tsim
from repro_torch.core import strategies as tstrat
from repro_torch.core.traces import controlled_traces
from repro_torch.kernels import _build, ops
from repro_torch.kernels import coded_matvec as cmv

torch.set_num_threads(1)   # small shapes; leave the cores to the timing-sensitive cluster tests

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"


@pytest.fixture(scope="module")
def jax_pkg():
    """The JAX package's cluster, coding, simulation and strategies (absent
    where JAX is)."""
    pytest.importorskip("jax")
    import repro.cluster as jcl
    from repro.core import coding, simulation, strategies
    return types.SimpleNamespace(cluster=jcl, coding=coding, simulation=simulation,
                                 strategies=strategies)


def _rng(seed):
    return np.random.default_rng(seed)


def int_mat(rng, shape):
    """Integer-valued float64 operands: every product and sum is exact."""
    return rng.integers(-3, 4, shape).astype(np.float64)


def port_engine(n, k, injector, row_cost=1e-6, compute=None, **kw):
    return tcl.CodedExecutionEngine(
        tcl.ClusterConfig(n_workers=n, k=k, row_cost=row_cost, **kw), injector=injector,
        compute=compute if compute is not None else tcl.worker.numpy_backend, device=CPU)


def jax_engine(jcl, n, k, injector, row_cost=1e-6, **kw):
    return jcl.CodedExecutionEngine(
        jcl.ClusterConfig(n_workers=n, k=k, row_cost=row_cost, **kw), injector=injector)


def _wait_idle(eng, timeout=60.0):
    """Until every worker has nothing queued or running."""
    deadline = time.monotonic() + timeout
    while not all(w.idle() for w in eng.workers):
        assert time.monotonic() < deadline, "workers still busy"
        time.sleep(0.01)


# ---------------------------------------------------------------------------
# KernelBackend.compute_chunk against the JAX package's
# ---------------------------------------------------------------------------

# rpc = 12 rows a chunk (not a power of two); r0 on a multiple of the chunk
# and off it
CHUNKS = [(24, 36), (7, 19)]


@pytest.mark.parametrize("r0,r1", CHUNKS)
@pytest.mark.parametrize("width", [None, 3, 20])
def test_compute_chunk_matches_jax_kernel_backend(jax_pkg, width, r0, r1):
    rng = _rng(width or 1)
    shard = rng.standard_normal((60, 24))
    x = rng.standard_normal(24 if width is None else (24, width))
    got = kernel_backend(CPU).compute_chunk(0, "s", shard, r0, r1, x)
    want = jax_pkg.cluster.kernel_backend().compute_chunk(0, "s", shard, r0, r1, x)
    assert got.dtype == np.float64 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, shard[r0:r1] @ x, rtol=1e-5, atol=1e-5)


def test_wide_operand_is_cut_into_column_groups(monkeypatch):
    """B = 20 runs as two launches of at most MAX_NVEC columns each."""
    widths = []
    real = ops.coded_matvec

    def spy(a, x, ids, rows):
        widths.append(x.shape[1])
        return real(a, x, ids, rows)

    monkeypatch.setattr(ops, "coded_matvec", spy)
    shard = _rng(3).standard_normal((24, 8))
    x = _rng(4).standard_normal((8, 20))
    y = kernel_backend(CPU).compute_chunk(0, "s", shard, 12, 24, x)
    assert widths == [cmv.MAX_NVEC, 20 - cmv.MAX_NVEC]
    np.testing.assert_allclose(y, shard[12:24] @ x, rtol=1e-5, atol=1e-5)


def test_chunk_reads_the_shard_in_place(monkeypatch):
    """A chunk is a view of the resident shard with block id 0: not
    padded, not copied."""
    seen = []
    real = ops.coded_matvec

    def spy(a, x, ids, rows):
        seen.append((a.shape[0], int(ids[0]), rows, a.data_ptr()))
        return real(a, x, ids, rows)

    monkeypatch.setattr(ops, "coded_matvec", spy)
    backend = kernel_backend(CPU)
    shard = _rng(5).standard_normal((60, 8))
    x = np.ones(8)
    for r0, r1 in CHUNKS:
        backend.compute_chunk(0, "s", shard, r0, r1, x)
    with backend._lock:
        base = backend._shards[(0, "s")]
    step = 8 * base.element_size()
    assert seen == [(r1 - r0, 0, r1 - r0, base.data_ptr() + r0 * step) for r0, r1 in CHUNKS]


def test_fortran_ordered_operands_reach_the_kernel_contiguous(monkeypatch):
    """A Fortran-ordered shard or ``(d, B)`` block (``W.T``) is uploaded
    C-ordered: the kernel on the card takes contiguous operands only."""
    seen = []
    real = ops.coded_matvec

    def spy(a, x, ids, rows):
        seen.append((a.is_contiguous(), x.is_contiguous()))
        return real(a, x, ids, rows)

    monkeypatch.setattr(ops, "coded_matvec", spy)
    shard = np.asfortranarray(_rng(6).standard_normal((48, 24)))
    for width in (3, 20):
        x = _rng(width).standard_normal((width, 24)).T
        assert x.flags.f_contiguous and not x.flags.c_contiguous
        y = kernel_backend(CPU).compute_chunk(0, "s", shard, 12, 24, x)
        np.testing.assert_allclose(y, shard[12:24] @ x, rtol=1e-5, atol=1e-5)
    assert seen and all(a and b for a, b in seen)


def test_engine_computes_through_the_kernel_backend_by_default():
    """Left without ``compute``, the engine's workers run the port's
    kernel on the engine's device."""
    eng = tcl.CodedExecutionEngine(tcl.ClusterConfig(n_workers=3, k=2, row_cost=1e-6),
                                   tcl.NoSlowdown(), device=CPU)
    try:
        backends = {id(w.compute) for w in eng.workers}
        assert len(backends) == 1
        compute = eng.workers[0].compute
        assert isinstance(compute, KernelBackend) and compute.device == torch.device(CPU)
        a, x = _rng(7).standard_normal((40, 16)), _rng(8).standard_normal(16)
        out = eng.matvec(eng.load_matrix(a, chunks=4), x,
                         tstrat.GeneralS2C2(3, 2, 40, chunks=4))
        np.testing.assert_allclose(out.y, a @ x, rtol=1e-4, atol=1e-4)
        assert compute.cache_info()["shards"] > 0
    finally:
        eng.shutdown()


# ---------------------------------------------------------------------------
# CodedData: encode and decode
# ---------------------------------------------------------------------------

def _coded(rows, d, n, k, chunks, seed, pkg=None):
    """A random tenant and its CodedData in the port (or in ``pkg``)."""
    a = _rng(seed).standard_normal((rows, d))
    cl, coding = (tcl, tcoding) if pkg is None else (pkg.cluster, pkg.coding)
    return a, cl.CodedData.encode("t", a, coding.MDSCode(n, k), chunks)


def _partials(data, x, coverage):
    """(n, C, rpc[, B]) chunk results of every worker, zeros where unused."""
    rpc = data.rows_per_chunk
    out = np.zeros((data.n, data.chunks, rpc) + x.shape[1:])
    for w in range(data.n):
        for c in range(data.chunks):
            if coverage[c, w]:
                out[w, c] = data.partitions[w][c * rpc:(c + 1) * rpc] @ x
    return out


def _coverage(n, k, chunks, seed):
    rng = _rng(seed)
    cov = np.zeros((chunks, n), dtype=bool)
    for c in range(chunks):
        cov[c, rng.choice(n, size=k, replace=False)] = True
    return cov


@pytest.mark.parametrize("width", [None, 5])
def test_coded_data_matches_jax(jax_pkg, width):
    n, k, chunks = 6, 4, 5
    a, port = _coded(203, 16, n, k, chunks, seed=7)
    _, ref = _coded(203, 16, n, k, chunks, seed=7, pkg=jax_pkg)
    for p, r in zip(port.partitions, ref.partitions):
        np.testing.assert_array_equal(p, r)
    assert port.rows_per_chunk == ref.rows_per_chunk
    x = _rng(8).standard_normal(16 if width is None else (16, width))
    cov = _coverage(n, k, chunks, seed=9)
    partials = _partials(ref, x, cov)
    y64 = port.decode(cov, partials)
    np.testing.assert_array_equal(y64, ref.decode(cov, partials))
    np.testing.assert_allclose(y64, a @ x, rtol=1e-9, atol=1e-9)
    y32 = port.decode(cov, partials, use_kernel=True, device=CPU)
    np.testing.assert_allclose(y32, ref.decode(cov, partials, use_kernel=True),
                               rtol=1e-5, atol=1e-5)
    assert y32.shape == y64.shape and y32.dtype == np.float64


# ---------------------------------------------------------------------------
# One engine against the other
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("port_path", ["numpy, float64 decode", "kernels"])
def test_engines_bit_identical_under_forced_coverage(jax_pkg, port_path):
    jcl, jstrat = jax_pkg.cluster, jax_pkg.strategies
    n, k, chunks, rows, d = 6, 4, 4, 96, 12
    rng = _rng(11)
    a = int_mat(rng, (rows, d))
    xs = [int_mat(rng, d), int_mat(rng, (d, 3)), int_mat(rng, (d, 20))]
    dead = {w: 0 for w in range(k, n)}
    kernels = port_path == "kernels"
    port = port_engine(n, k, tcl.FailStopInjector(dead), row_cost=2e-5,
                       compute=kernel_backend(CPU) if kernels else None,
                       decode_with_kernel=kernels)
    ref = jax_engine(jcl, n, k, jcl.FailStopInjector(dead), row_cost=2e-5)
    try:
        dp, dr = port.load_matrix(a, chunks=chunks), ref.load_matrix(a, chunks=chunks)
        for x in xs:
            run = "matvec" if x.ndim == 1 else "matmul"
            yp = getattr(port, run)(dp, x, tstrat.MDSCoded(n, k, rows)).y
            yr = getattr(ref, run)(dr, x, jstrat.MDSCoded(n, k, rows)).y
            np.testing.assert_array_equal(yp, yr)
            np.testing.assert_array_equal(yp, a @ x)
    finally:
        port.shutdown()
        ref.shutdown()


def test_engines_agree_under_trace_injection(jax_pkg):
    jcl, jstrat = jax_pkg.cluster, jax_pkg.strategies
    n, k, chunks, rows = 8, 6, 8, 240
    rng = _rng(12)
    a = rng.standard_normal((rows, 16))
    x = rng.standard_normal(16)
    traces = controlled_traces(n, 8, n_stragglers=2, seed=5)
    port = port_engine(n, k, tcl.TraceInjector(traces), row_cost=2e-5)
    ref = jax_engine(jcl, n, k, jcl.TraceInjector(traces), row_cost=2e-5)
    try:
        dp, dr = port.load_matrix(a, chunks=chunks), ref.load_matrix(a, chunks=chunks)
        for _ in range(4):
            yp = port.matvec(dp, x, tstrat.GeneralS2C2(n, k, rows, chunks=chunks)).y
            yr = ref.matvec(dr, x, jstrat.GeneralS2C2(n, k, rows, chunks=chunks)).y
            np.testing.assert_allclose(yp, yr, rtol=1e-9, atol=1e-9)
    finally:
        port.shutdown()
        ref.shutdown()


# ---------------------------------------------------------------------------
# The simulator and its strategies
# ---------------------------------------------------------------------------

STRATEGIES = {
    "general": lambda s: s.GeneralS2C2(12, 10, 600000),
    "basic": lambda s: s.BasicS2C2(12, 10, 600000),
    "mds": lambda s: s.MDSCoded(12, 10, 600000),
    "uncoded": lambda s: s.UncodedReplication(12, 600000, replication=2),
    "over_decomposition": lambda s: s.OverDecomposition(12, 600000),
}


@pytest.mark.parametrize("name", STRATEGIES)
def test_simulate_run_matches_jax(jax_pkg, name):
    jsim, jstrat = jax_pkg.simulation, jax_pkg.strategies
    traces = controlled_traces(12, 10, n_stragglers=2, seed=3)
    got = tsim.simulate_run(STRATEGIES[name](tstrat), traces, tsim.LOCAL_CLUSTER, seed=1)
    want = jsim.simulate_run(STRATEGIES[name](jstrat), traces, jsim.LOCAL_CLUSTER, seed=1)
    for field in ("iteration_times", "per_worker_wasted", "per_worker_useful"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    assert (got.data_moved_rows, got.mispredictions) == (want.data_moved_rows,
                                                         want.mispredictions)


def test_calibrate_row_cost_on_the_host():
    cost = tsim.calibrate_row_cost(d_cols=64, rows=32, repeats=2, device=CPU)
    assert np.isfinite(cost) and cost > 0


# ---------------------------------------------------------------------------
# The JAX package's KernelBackend tests, on the port
# (tests/test_cluster.py, test_cluster_pipeline.py, test_cluster_steal.py)
# ---------------------------------------------------------------------------

def test_kernel_backend_decodes_exactly():
    """The engine drives the port's coded_matvec kernel per chunk."""
    rng = _rng(0)
    a, x = rng.standard_normal((64, 64)), rng.standard_normal(64)
    n, k, chunks = 4, 2, 4
    eng = port_engine(n, k, tcl.NoSlowdown(), compute=kernel_backend(CPU))
    try:
        data = eng.load_matrix(a, chunks=chunks)
        out = eng.matvec(data, x, tstrat.GeneralS2C2(n, k, 64, chunks=chunks))
        np.testing.assert_allclose(out.y, a @ x, rtol=1e-4, atol=1e-4)
    finally:
        eng.shutdown()


class _UploadLog(KernelBackend):
    """The port's backend, recording each shard upload by (worker, shard id)
    and each worker that computed a chunk; ``gate``, when set, holds every
    chunk until it is set."""

    def __init__(self, device):
        super().__init__(device)
        self.uploads = collections.Counter()
        self.computed = set()
        self.gate = None
        self.entered = threading.Event()

    def _store(self, key, shard):
        self.uploads[key] += 1  # at install (the master's thread) or by a chunk
        return super()._store(key, shard)

    def compute_chunk(self, worker_id, shard_id, shard, r0, r1, x):
        self.entered.set()
        if self.gate is not None:
            assert self.gate.wait(30)
        self.computed.add(worker_id)
        return super().compute_chunk(worker_id, shard_id, shard, r0, r1, x)


class TestKernelBackendCache:
    def test_shard_cache_populates_and_evicts(self):
        """Each worker uploads its shard once, when it is installed; no round
        uploads one again, and ``unload`` evicts them all.  Which workers
        compute depends on the schedule (an idle worker steals a slow one's
        queued chunks and computes them from its own shard, and the workers
        still busy when k of n cover every chunk are cancelled), so each
        count is read once every worker is idle; every worker the round's
        decode used computed."""
        backend = _UploadLog(CPU)
        assert isinstance(backend, KernelBackend)
        n, k, chunks = 4, 2, 4
        eng = port_engine(n, k, tcl.NoSlowdown(), compute=backend)
        rng = _rng(1)
        try:
            a, x = rng.standard_normal((64, 16)), rng.standard_normal(16)
            data = eng.load_matrix(a, chunks=chunks)
            installed = {(w, data.shard_id): 1 for w in range(n)}
            assert backend.uploads == installed
            assert backend.cache_info()["shards"] == n
            for _ in range(2):
                out = eng.matvec(data, x, tstrat.GeneralS2C2(n, k, 64, chunks=chunks))
                np.testing.assert_allclose(out.y, a @ x, rtol=1e-4, atol=1e-4)
                _wait_idle(eng)
                used = {w for w in range(n) if out.metrics.useful_rows[w] > 0}
                assert len(used) >= k and used <= backend.computed
                assert backend.cache_info()["shards"] == n
                # each shard uploaded once, at install; no round uploads again
                assert backend.uploads == installed
            eng.unload(data)
            _wait_idle(eng)
            assert backend.cache_info()["shards"] == 0      # evicted with the tenant
        finally:
            eng.shutdown()

    def test_shard_unloaded_mid_chunk_is_not_kept(self):
        """A chunk that uploads its shard after ``unload`` evicted it (a
        straggler mid-task while its tenant unloads) leaves nothing
        cached once its worker is idle: one upload at install, one by the
        chunk that found it evicted, none kept."""
        backend = _UploadLog(CPU)
        backend.gate = threading.Event()
        events = queue.Queue()
        worker = tcl.worker.Worker(0, events, tcl.NoSlowdown(), compute=backend)
        worker.start()
        try:
            shard = np.arange(32, dtype=np.float64).reshape(4, 8)
            worker.install_shard("t0", shard)
            worker.submit(tcl.worker.ChunkTask(0, 0, "t0", [(0, 0, 4)], np.ones(8), 1e-9,
                                               threading.Event()))
            assert backend.entered.wait(30)     # the chunk holds the shard, not yet uploaded
            worker.drop_shard("t0")             # the tenant unloads
            backend.gate.set()
            done = events.get(timeout=30)
            np.testing.assert_allclose(done.result, shard @ np.ones(8), rtol=1e-5)
            deadline = time.monotonic() + 30
            while not worker.idle():
                assert time.monotonic() < deadline, "worker still busy"
                time.sleep(0.01)
            assert backend.uploads == {(0, "t0"): 2}
            assert backend.cache_info()["shards"] == 0
        finally:
            worker.stop()
            worker.join(30)

    def test_install_uploads_the_shard_before_any_chunk(self):
        """The shard goes up when the worker installs it, so its first chunk
        computes from a resident copy (an upload inside the first chunk
        outlasted the process pool's event-silence window on the card)."""
        backend = _UploadLog(CPU)
        events = queue.Queue()
        worker = tcl.worker.Worker(0, events, tcl.NoSlowdown(), compute=backend)
        worker.start()
        try:
            shard = np.arange(32, dtype=np.float64).reshape(4, 8)
            worker.install_shard("t0", shard)
            assert backend.uploads == {(0, "t0"): 1}
            assert backend.cache_info()["shards"] == 1
            worker.submit(tcl.worker.ChunkTask(0, 0, "t0", [(0, 0, 4)], np.ones(8), 1e-9,
                                               threading.Event()))
            done = events.get(timeout=30)
            np.testing.assert_allclose(done.result, shard @ np.ones(8), rtol=1e-5)
            assert backend.uploads == {(0, "t0"): 1}
        finally:
            worker.stop()
            worker.join(30)

    def test_reinstall_replaces_the_device_copy(self):
        """A shard installed again under its id (the rejoin handshake
        reinstalls a shard whose digest failed) is computed from its new
        rows, never from the device copy of the old ones."""
        backend = kernel_backend(CPU)
        worker = tcl.worker.Worker(0, queue.Queue(), tcl.NoSlowdown(), compute=backend)
        old, new, x = np.ones((4, 8)), np.arange(32.0).reshape(4, 8), np.ones(8)
        worker.install_shard("t0", old)
        np.testing.assert_allclose(backend.compute_chunk(0, "t0", old, 0, 4, x), old @ x)
        worker.install_shard("t0", new)
        np.testing.assert_allclose(backend.compute_chunk(0, "t0", new, 0, 4, x), new @ x)
        assert backend.cache_info()["shards"] == 1

    def test_inplace_mutated_x_is_not_served_stale(self):
        backend = kernel_backend(CPU)
        a = np.arange(32, dtype=np.float64).reshape(4, 8)
        x = np.ones(8)
        y1 = backend.compute_chunk(0, "s", a, 0, 4, x)
        np.testing.assert_allclose(y1, a @ x, rtol=1e-5, atol=1e-5)
        x[:] = 2.0                      # same object, new contents
        y2 = backend.compute_chunk(0, "s", a, 0, 4, x)
        np.testing.assert_allclose(y2, a @ x, rtol=1e-5, atol=1e-5)
        assert not np.allclose(y1, y2)

    def test_odd_chunk_sizes_are_exact(self):
        """rpc = 12: the port launches on the 12 rows as they are (no
        power-of-two bucket) and the engine's results stay exact."""
        backend = kernel_backend(CPU)
        n, k, chunks = 4, 2, 5
        eng = port_engine(n, k, tcl.NoSlowdown(), compute=backend)
        rng = _rng(2)
        try:
            a, x = rng.standard_normal((120, 8)), rng.standard_normal(8)
            data = eng.load_matrix(a, chunks=chunks)
            assert data.rows_per_chunk == 12
            out = eng.matvec(data, x, tstrat.GeneralS2C2(n, k, 120, chunks=chunks))
            np.testing.assert_allclose(out.y, a @ x, rtol=1e-4, atol=1e-4)
        finally:
            eng.shutdown()


class TestDigests:
    def test_digests_hash_the_array_in_place(self):
        """``shard_digest`` and the journal's ``_array_digest`` hash the
        array's own buffer (hashlib lets go of the GIL meanwhile): a
        ``tobytes()`` copy of a 983 MB shard held the GIL past the
        heartbeat window, so every child digesting its shard for the
        rejoin handshake drew a §4.4 verdict.  The digests are unchanged."""
        import hashlib
        import tracemalloc

        from repro_torch.cluster.master import _array_digest
        from repro_torch.cluster.worker import shard_digest

        arr = np.random.default_rng(0).standard_normal((2_048, 1_024))    # 16 MB
        want = hashlib.sha256(str((arr.shape, str(arr.dtype))).encode() + arr.tobytes())
        for digest in (shard_digest, _array_digest):
            tracemalloc.start()
            try:
                got = digest(arr)
                peak = tracemalloc.get_traced_memory()[1]
            finally:
                tracemalloc.stop()
            assert got == want.hexdigest()
            assert peak < arr.nbytes // 16, (digest.__name__, peak)


class TestXCacheLRU:
    def test_alternating_vectors_both_stay_cached(self):
        backend = kernel_backend(CPU)
        a = np.arange(64, dtype=np.float64).reshape(8, 8)
        x1, x2 = np.ones(8), np.full(8, 2.0)
        for _ in range(3):      # interleaved, as two concurrent rounds do
            y1 = backend.compute_chunk(0, "s", a, 0, 8, x1)
            y2 = backend.compute_chunk(1, "s", a, 0, 8, x2)
        np.testing.assert_allclose(y1, a @ x1, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(y2, a @ x2, rtol=1e-5, atol=1e-5)
        info = backend.cache_info()
        assert info["x_entries"] == 2
        assert info["x_misses"] == 2            # one upload per vector
        assert info["x_hits"] == 4              # every later use hits
        x1[:] = 3.0                             # in-place mutation: a new key
        y3 = backend.compute_chunk(0, "s", a, 0, 8, x1)
        np.testing.assert_allclose(y3, a @ x1, rtol=1e-5, atol=1e-5)
        assert backend.cache_info()["x_entries"] == 3

    def test_x_cache_is_lru_capped(self):
        backend = kernel_backend(CPU)
        a = np.eye(4)
        for i in range(KernelBackend._X_CACHE_CAP + 5):
            backend.compute_chunk(0, "s", a, 0, 4, np.full(4, float(i)))
        assert backend.cache_info()["x_entries"] == KernelBackend._X_CACHE_CAP


# ---------------------------------------------------------------------------
# Spawned workers
# ---------------------------------------------------------------------------

def test_kernel_backend_travels_as_a_device_spec():
    spec = ttransport._compute_spec(kernel_backend(CPU))
    assert spec == "kernel:cpu"
    built = ttransport._resolve_compute(spec)
    assert isinstance(built, KernelBackend) and built.device == torch.device(CPU)


def test_spawned_workers_compute_through_the_kernel_backend():
    n, k, chunks, rows = 3, 2, 4, 96
    rng = _rng(13)
    a, x = rng.standard_normal((rows, 16)), rng.standard_normal(16)
    eng = tcl.CodedExecutionEngine(
        tcl.ClusterConfig(n_workers=n, k=k, row_cost=1e-6, starvation_timeout=30.0),
        tcl.NoSlowdown(), compute=kernel_backend(CPU),
        transport=tcl.SocketTransport(connect_timeout=60.0), device=CPU)
    try:
        assert eng.transport.kind == "proc"
        data = eng.load_matrix(a, chunks=chunks)
        for _ in range(2):
            out = eng.matvec(data, x, tstrat.GeneralS2C2(n, k, rows, chunks=chunks))
            np.testing.assert_allclose(out.y, a @ x, rtol=1e-4, atol=1e-4)
    finally:
        eng.shutdown()


# ---------------------------------------------------------------------------
# Launch counters under threads
# ---------------------------------------------------------------------------

def test_launch_counters_are_exact_under_threads(monkeypatch):
    """Many threads through the wrappers' counting path (the library's
    entry points replaced by no-ops, so CPU tensors reach it): no count is
    lost."""
    monkeypatch.setattr(_build, "library", lambda: None)
    monkeypatch.setattr(_build, "kernel", lambda name: (lambda *args: 0))
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    a, ids = torch.zeros(64, 32), torch.zeros(1, dtype=torch.int32)
    x1, x3 = torch.zeros(32), torch.zeros(32, 3)
    a_ragged, x_ragged = torch.zeros(64, 30), torch.zeros(30)     # 120-byte rows
    a_wide, x_wide = torch.zeros(64, 8200), torch.zeros(8200)     # 32,800-byte rows
    w, parts = torch.zeros(2, 3, 3), torch.zeros(6, 8)
    table = torch.arange(6, dtype=torch.int32).view(2, 3)
    threads_n, calls = 16, 300

    def work():
        out = torch.empty(2, 3, 8)
        for _ in range(calls):
            cmv.coded_matvec_cuda(a, x1, ids, 8)        # the stream design
            cmv.coded_matvec_cuda(a, x3, ids, 8)        # the multi design
            cmv.coded_matvec_cuda(a_ragged, x_ragged, ids, 8)   # the general design
            cmv.coded_matvec_cuda(a_wide, x_wide, ids, 8)       # the split-row stream
            ops._dec.mds_decode_into_cuda(w, parts, table, out)

    ops.reset_launch_counts()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(threads_n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    total = threads_n * calls
    try:
        assert ops.launch_counts() == {"coded_matvec": 4 * total, "mds_encode": 0,
                                       "mds_decode": total, "lstm_cell": 0}
        assert ops.design_counts()["coded_matvec"] == {"stream": total, "split": total,
                                                       "multi": total, "general": total}
    finally:
        ops.reset_launch_counts()


# ---------------------------------------------------------------------------
# The concurrency contracts
# ---------------------------------------------------------------------------

def test_port_cluster_keeps_the_concurrency_contracts():
    out = subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                          "src/repro_torch/cluster"],
                         capture_output=True, text=True, cwd=ROOT, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stdout + out.stderr
    assert "0 finding(s) in 11 file(s)" in out.stderr


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("width", [None, 8, 20])
def test_cuda_backend_matches_its_cpu_run(cuda, width):
    shard = _rng(20).standard_normal((600 * 4, 256))
    x = _rng(21).standard_normal(256 if width is None else (256, width))
    on_card, on_host = kernel_backend(cuda), kernel_backend(CPU)
    groups = 1 if width is None else -(-width // cmv.MAX_NVEC)
    for r0 in (1200, 0):
        ops.reset_launch_counts()
        got = on_card.compute_chunk(0, "s", shard, r0, r0 + 600, x)
        designs = ops.design_counts()["coded_matvec"]
        want = on_host.compute_chunk(0, "s", shard, r0, r0 + 600, x)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
        assert ops.launch_counts()["coded_matvec"] == groups
        if width is None:
            assert designs == {"stream": 1, "split": 0, "multi": 0, "general": 0}
        else:
            assert designs == {"stream": 0, "split": 0, "multi": groups, "general": 0}


@pytest.mark.cuda
def test_cuda_backend_unaligned_view_takes_the_general_design(cuda):
    """d = 13: a chunk that starts off a multiple of its length is a view
    whose base is not 16-byte aligned, which the general design takes."""
    shard = _rng(22).standard_normal((40, 13))
    x = _rng(23).standard_normal(13)
    ops.reset_launch_counts()
    got = kernel_backend(cuda).compute_chunk(0, "s", shard, 3, 13, x)
    assert ops.design_counts()["coded_matvec"] == {"stream": 0, "split": 0, "multi": 0,
                                                   "general": 1}
    np.testing.assert_allclose(got, kernel_backend(CPU).compute_chunk(0, "s", shard, 3, 13, x),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [None, 20])
def test_cuda_kernel_decode(cuda, width):
    n, k, chunks = 12, 10, 20
    a, port = _coded(1200 * 10, 32, n, k, chunks, seed=24)
    x = _rng(25).standard_normal(32 if width is None else (32, width))
    cov = _coverage(n, k, chunks, seed=26)
    partials = _partials(port, x, cov)
    ops.reset_launch_counts()
    got = port.decode(cov, partials, use_kernel=True, device=cuda)
    assert ops.launch_counts()["mds_decode"] == 1
    np.testing.assert_allclose(got, port.decode(cov, partials, use_kernel=True, device=CPU),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, a @ x, rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [None, 8, 20])
def test_cuda_engine_round_launch_counts(cuda, width):
    """A 12-worker round: one coded_matvec launch per chunk and column
    group, one mds_decode launch.  The float32 round is held to 1e-3 of
    the float64 product's largest entry, as ``chip_smoke.py`` holds it: a
    parity chunk's decode weights scale float32 rounding by a few units,
    so an entry near 0 can be off by more than 1e-3 of itself."""
    n, k, chunks, rows = 12, 10, 20, 12_000
    rng = _rng(27)
    a = rng.standard_normal((rows, 64))
    x = rng.standard_normal(64 if width is None else (64, width))
    backend = kernel_backend(cuda)
    eng = tcl.CodedExecutionEngine(
        tcl.ClusterConfig(n_workers=n, k=k, row_cost=1e-6, decode_with_kernel=True),
        tcl.TraceInjector(controlled_traces(n, 4, n_stragglers=2, seed=7)), compute=backend,
        device=cuda)
    try:
        data = eng.load_matrix(a, chunks=chunks)
        run = eng.matvec if width is None else eng.matmul
        strat = tstrat.GeneralS2C2(n, k, rows, chunks=chunks)
        run(data, x, strat)                       # uploads the shards
        _wait_idle(eng)
        before = backend.cache_info()
        ops.reset_launch_counts()
        out = run(data, x, strat)
        _wait_idle(eng)                           # cancelled chunks finish too
        info = backend.cache_info()
        counts = ops.launch_counts()
        computed = info["x_hits"] + info["x_misses"] - before["x_hits"] - before["x_misses"]
        groups = 1 if width is None else -(-width // cmv.MAX_NVEC)
        assert counts["coded_matvec"] == computed * groups
        assert counts["mds_decode"] == 1
        want = a @ x
        assert np.abs(out.y - want).max() <= 1e-3 * np.abs(want).max()
    finally:
        eng.shutdown()


@pytest.mark.cuda
def test_cuda_default_engine_matmul_of_a_transposed_block(cuda):
    """A default engine computes on the card's ``KernelBackend``, and a
    Fortran-ordered ``(d, B)`` operand (``W.T``) is exact through it."""
    n, k, chunks, rows = 6, 4, 8, 4_800
    rng = _rng(28)
    a = rng.standard_normal((rows, 256))
    eng = tcl.CodedExecutionEngine(tcl.ClusterConfig(n_workers=n, k=k, row_cost=1e-7),
                                   tcl.NoSlowdown())
    try:
        compute = eng.workers[0].compute
        assert isinstance(compute, KernelBackend) and compute.device.type == "cuda"
        data = eng.load_matrix(a, chunks=chunks)
        for width in (8, 20):
            w = rng.standard_normal((width, 256))
            out = eng.matmul(data, w.T, tstrat.GeneralS2C2(n, k, rows, chunks=chunks))
            want = a @ w.T
            assert np.abs(out.y - want).max() <= 1e-3 * np.abs(want).max()
    finally:
        eng.shutdown()
