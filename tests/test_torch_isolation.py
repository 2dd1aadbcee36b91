"""The port stands alone and hides no fallback.

1. No file of ``src/repro_torch/``, nor ``chip_smoke.py``, imports ``jax``
   or anything of the JAX package ``repro`` (an AST scan).
2. Importing the port's modules leaves ``jax`` and ``repro`` out of
   ``sys.modules`` (a fresh interpreter).
3. An entry point left at its default device raises where there is no card.
4. A CUDA tensor that reaches ``ops`` without a built kernel library raises;
   it is never handed to the plain version.
5. A run on the CPU launches no kernel: every counter stays at 0.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build, ops

torch.set_num_threads(1)   # small shapes; leave the cores to the timing-sensitive cluster tests

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_port_file_imports_jax_or_repro():
    assert len(PORT_FILES) >= 15
    bad = {str(p.relative_to(ROOT)): sorted(_imported_roots(p) & set(FORBIDDEN))
           for p in PORT_FILES}
    assert not {k: v for k, v in bad.items() if v}


def test_importing_the_port_loads_neither_jax_nor_repro():
    modules = sorted("repro_torch." + ".".join(p.relative_to(ROOT / "src" / "repro_torch")
                                                .with_suffix("").parts)
                     for p in PORT_FILES[:-1])
    modules = [m.removesuffix(".__init__") for m in modules]
    prog = ("import sys\n"
            f"for m in {modules!r}: __import__(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "print('LOADED', bad)\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True, text=True,
                         env=env, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LOADED []" in out.stdout, out.stdout


def test_default_device_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable here")
    from repro_torch.cluster import ClusterConfig, CodedExecutionEngine, NoSlowdown
    from repro_torch.cluster.worker import Worker, kernel_backend
    from repro_torch.convert import load_params
    from repro_torch.core.coded_matmul import CodedMatvec
    from repro_torch.core.coding import MDSCode
    from repro_torch.core.predictor import SpeedPredictor
    from repro_torch.core.simulation import calibrate_row_cost
    for make in (lambda: CodedMatvec(MDSCode(6, 4), 12), lambda: SpeedPredictor(6),
                 load_params, kernel_backend, calibrate_row_cost,
                 lambda: CodedExecutionEngine(ClusterConfig(n_workers=3, k=2), NoSlowdown()),
                 lambda: Worker(0, None, NoSlowdown())):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


def test_cuda_tensor_without_library_raises(monkeypatch):
    """Fake CUDA tensors (shapes and dtypes only) reach every kernel wrapper;
    with no nvcc the build raises, and the plain versions are never called."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import coded_matvec, lstm_cell, mds_decode, mds_encode
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "_nvcc", lambda: None)
    monkeypatch.setattr(_build, "BUILD_ROOT", _build.BUILD_ROOT.parent / "no-such-build")

    def forbidden(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached a plain version")

    for mod, name in [(coded_matvec, "coded_matvec_plain"), (mds_encode, "mds_encode_plain"),
                      (mds_decode, "mds_decode_plain"), (lstm_cell, "lstm_cell_plain"),
                      (lstm_cell, "lstm_sequence_plain")]:
        monkeypatch.setattr(mod, name, forbidden)
    with FakeTensorMode(allow_non_fake_inputs=True):
        cuda = torch.device("cuda")
        calls = [
            lambda: ops.coded_matvec(torch.empty(64, 32, device=cuda),
                                     torch.empty(32, 1, device=cuda),
                                     torch.zeros(2, dtype=torch.int32, device=cuda), 8),
            lambda: ops.mds_encode(torch.empty(6, 4, device=cuda),
                                   torch.empty(4, 8, 16, device=cuda)),
            lambda: ops.mds_decode(torch.empty(3, 4, 4, device=cuda),
                                   torch.empty(3, 4, 10, device=cuda)),
            lambda: ops.lstm_cell(*(torch.empty(s, device=cuda) for s in
                                    [(5, 1), (5, 4), (5, 4), (16, 1), (16, 4), (16,)])),
            lambda: ops.lstm_sequence(*(torch.empty(s, device=cuda) for s in
                                        [(3, 5, 1), (16, 1), (16, 4), (16,), (1, 4), (1,)])),
        ]
        for call in calls:
            with pytest.raises(RuntimeError, match="nvcc not found"):
                call()
    assert ops.launch_counts() == dict.fromkeys(ops.launch_counts(), 0)
    assert ops.design_counts() == {"coded_matvec": {"stream": 0, "general": 0},
                                   "lstm_cell": {"sequence": 0, "cell": 0}}


def test_cpu_run_launches_no_kernel():
    from repro_torch.convert import load_params
    from repro_torch.core.coded_matmul import CodedMatvec
    from repro_torch.core.coding import MDSCode
    from repro_torch.core.predictor import SpeedPredictor
    from repro_torch.core.s2c2 import general_allocation
    from repro_torch.core.traces import controlled_traces
    ops.reset_launch_counts()
    cm = CodedMatvec(MDSCode(12, 10), 20, device="cpu")
    coded = cm.shard(torch.randn(2000, 16, generator=torch.Generator().manual_seed(0)))
    sp = SpeedPredictor(12, load_params(device="cpu"), device="cpu")
    traces = controlled_traces(12, 5, n_stragglers=2, seed=7)
    for it in range(5):
        y = cm.apply(coded, torch.ones(16), *cm.plan_tables(general_allocation(sp.predict(),
                                                                             10, 20)))
        assert np.isfinite(y.numpy()).all()
        sp.observe(traces[it])
    assert ops.launch_counts() == {"coded_matvec": 0, "mds_encode": 0, "mds_decode": 0,
                                   "lstm_cell": 0}
    assert ops.design_counts() == {"coded_matvec": {"stream": 0, "general": 0},
                                   "lstm_cell": {"sequence": 0, "cell": 0}}
