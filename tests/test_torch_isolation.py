"""The port stands alone and hides no fallback.

1. No file of ``src/repro_torch/``, nor ``chip_smoke.py``, nor a script of
   the port (``scripts/torch_*.py``), imports ``jax`` or anything of the
   JAX package ``repro`` (an AST scan).
2. Importing the port's modules leaves ``jax`` and ``repro`` out of
   ``sys.modules`` (a fresh interpreter).
3. An entry point left at its default device raises where there is no card
   (serving and training alike), and the serving entry point refuses the
   encoder-decoder with ``SystemExit``, as the JAX package's does.
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


def test_no_port_script_imports_jax_or_repro():
    scripts = sorted((ROOT / "scripts").glob("torch_*.py"))
    assert ROOT / "scripts" / "torch_chaos_demo.py" in scripts
    bad = {p.name: sorted(_imported_roots(p) & set(FORBIDDEN)) for p in scripts}
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


def test_serving_modules_are_scanned():
    """The serving slice's modules are among the files and modules that the
    two scans above cover."""
    names = {str(p.relative_to(ROOT / "src")) for p in PORT_FILES[:-1]}
    assert {"repro_torch/configs/base.py", "repro_torch/configs/registry.py",
            "repro_torch/configs/mistral_nemo_12b.py", "repro_torch/models/params.py",
            "repro_torch/models/layers.py", "repro_torch/models/lm.py",
            "repro_torch/runtime/serve_loop.py", "repro_torch/launch/serve.py"} <= names
    archs = [p for p in (ROOT / "src" / "repro_torch" / "configs").glob("*.py")
             if p.stem not in ("__init__", "base", "registry")]
    assert len(archs) == 10


def test_serving_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable here")
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import main
    from repro_torch.models import LM, build_model
    from repro_torch.runtime.serve_loop import CodedLMHead, Request, ServeConfig, serve
    cfg = get_config("mistral-nemo-12b").reduced()
    cpu_model = LM(cfg, device="cpu")
    reqs = [Request(rid=0, prompt=np.arange(1, 4, dtype=np.int32), max_new=2)]
    for make in (lambda: LM(cfg), lambda: build_model(cfg),
                 lambda: CodedLMHead(torch.ones(8, 32), n=6, k=4, chunks=2),
                 lambda: serve(cpu_model, reqs, ServeConfig()),
                 lambda: main(["--reduced"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


def test_training_entry_point_defaults_to_the_card(tmp_path):
    """``launch.train.main`` left at its default device raises where there
    is no card, before it builds or writes anything."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable here")
    from repro_torch.launch.train import main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--reduced", "--steps", "1", "--ckpt-dir", str(tmp_path / "ckpt")])
    assert not (tmp_path / "ckpt").exists()


def test_training_modules_load_neither_jax_nor_repro():
    """The training slice's modules are scanned above, and importing them
    alone leaves ``jax`` and ``repro`` out of ``sys.modules``."""
    names = {str(p.relative_to(ROOT / "src")) for p in PORT_FILES[:-1]}
    modules = ["repro_torch.optim.optimizer", "repro_torch.checkpoint.checkpoint",
               "repro_torch.runtime.train_loop", "repro_torch.launch.train"]
    assert {m.replace(".", "/") + ".py" for m in modules} <= names
    prog = ("import sys\n"
            f"for m in {modules!r}: __import__(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "print('LOADED', bad)\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True, text=True,
                         env=env, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LOADED []" in out.stdout, out.stdout


@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2"])
def test_families_not_ported_raise(arch):
    """Every family is ported: the encoder-decoder's constructors build, at
    full size on ``meta`` and reduced on the CPU, and the serving entry point
    refuses the arch with ``SystemExit``, as the JAX package's does; no
    other model runs in its place."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import main
    from repro_torch.models import EncDecLM, build_model
    assert isinstance(EncDecLM(get_config(arch), device="meta"), EncDecLM)
    assert isinstance(build_model(get_config(arch).reduced(), device="cpu"), EncDecLM)
    for argv in (["--arch", arch], ["--arch", arch, "--reduced", "--device", "cpu"]):
        with pytest.raises(SystemExit, match="targets decoder LMs"):
            main(argv)


def test_port_examples_import_neither_jax_nor_repro():
    examples = sorted((ROOT / "examples").glob("torch_*.py"))
    assert len(examples) >= 3
    bad = {p.name: sorted(_imported_roots(p) & set(FORBIDDEN)) for p in examples}
    assert not {k: v for k, v in bad.items() if v}


def test_workload_entry_points_default_to_the_card():
    """The entry points this slice adds that place tensors default to the
    card; the polynomial and gradient codes compute on their operands'
    device and take none."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable here")
    from repro_torch.core.predictor import LSTMParams, init_lstm, train_predictor
    from repro_torch.core.traces import controlled_traces
    traces = controlled_traces(4, 20, n_stragglers=1, seed=0)
    for make in (lambda: init_lstm(LSTMParams(), torch.Generator()),
                 lambda: train_predictor(traces, epochs=1)):
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
            lambda: ops.coded_matvec(torch.empty(64, 32, device=cuda),
                                     torch.empty(32, 3, device=cuda),
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
    assert ops.design_counts() == {"coded_matvec": {"stream": 0, "split": 0, "multi": 0,
                                                    "general": 0},
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
    assert ops.design_counts() == {"coded_matvec": {"stream": 0, "split": 0, "multi": 0,
                                                    "general": 0},
                                   "lstm_cell": {"sequence": 0, "cell": 0}}


def test_mesh_modules_load_neither_jax_nor_repro():
    """The mesh slice's modules are scanned above, and importing them alone
    leaves ``jax`` and ``repro`` out of ``sys.modules``."""
    names = {str(p.relative_to(ROOT / "src")) for p in PORT_FILES[:-1]}
    modules = ["repro_torch.launch.mesh", "repro_torch.launch.partition",
               "repro_torch.launch.sharding", "repro_torch.launch.steps",
               "repro_torch.core.coded_matmul", "repro_torch.models.params"]
    assert {m.replace(".", "/") + ".py" for m in modules} <= names
    prog = ("import sys\n"
            f"for m in {modules!r}: __import__(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "print('LOADED', bad)\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True, text=True,
                         env=env, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LOADED []" in out.stdout, out.stdout


MESH_MISUSE = """
import pytest, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.core.coded_matmul import CodedMatvec
from repro_torch.core.coding import MDSCode
from repro_torch.launch.mesh import make_production_mesh, make_worker_mesh
for make, n in [(make_production_mesh, 256), (lambda: make_production_mesh(multi_pod=True), 512),
                (lambda: make_worker_mesh(4), 4)]:
    with pytest.raises(ValueError, match=f"needs {n} ranks; there is no initialised"):
        make()
dist.init_process_group("fake", store=FakeStore(), rank=1, world_size=3)
for make, n in [(make_production_mesh, 256), (lambda: make_production_mesh(multi_pod=True), 512),
                (lambda: make_worker_mesh(4), 4)]:
    with pytest.raises(ValueError, match=f"needs {n} ranks; the process group has 3"):
        make()
mesh = make_worker_mesh(3)
with pytest.raises(ValueError, match="has size 3 but code.n=4"):
    CodedMatvec(MDSCode(4, 3), 6, device="cpu", mesh=mesh)
with pytest.raises(ValueError, match="no axis 'rows'"):
    CodedMatvec(MDSCode(3, 2), 6, device="cpu", mesh=mesh, axis="rows")
assert CodedMatvec(MDSCode(3, 2), 6, device="cpu", mesh=mesh).rank == 1
dist.destroy_process_group()
print("MISUSE_OK")
"""


def test_mesh_builders_and_coded_matvec_refuse_a_wrong_group():
    """No group, or a group of another size, raises ``ValueError`` naming
    both numbers, for the production and worker meshes (no smaller mesh, no
    single process in its place); a ``CodedMatvec`` whose mesh axis is not
    ``code.n`` wide raises.  A fresh interpreter: the group is global."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", MESH_MISUSE], capture_output=True, text=True,
                         env=env, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "MISUSE_OK" in out.stdout
