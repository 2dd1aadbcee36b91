"""The port across a mesh of processes on ``torch.distributed``, on the CPU
(and one twin on the card).

* **The worker-mesh ``CodedMatvec``** (``mesh=make_worker_mesh(4)``) on 4
  gloo processes, (n, k) = (4, 3), C = 6, A (90, 16), under the three
  speed vectors of ``tests/test_runtime.py::TestDistributedCodedMatvec``:
  every rank's y against the JAX package's ``shard_map`` path (run in a
  subprocess on 4 forced host devices, as that test runs it) on A's rows
  at 3e-3, against a float64 product at ``F64_TOL`` of its largest value,
  and against the port's single-device ``apply`` at ``SINGLE_TOL``.  The
  ``cuda`` twin runs the same 4 ranks over gloo, each holding its
  partition on the one card, and requires each kernel to launch on every
  rank.
* A 2 × 2 train step on DTensors is ``tests/test_torch_mesh_train.py``'s.
* **``chip_smoke.py``'s phase 11** end to end on the CPU at its reduced
  sizes, in a process of its own.

The JAX package runs only in its own subprocess here.  Every rank is a
process of its own (``tests/_torch_ranks.py``) with a time
limit (``TIMEOUT``), rendezvous through a file under the test's
``tmp_path``, so that a hung rendezvous fails one test and no two tests
share a port.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_cuda import cuda  # noqa: F401  (fixture)
from _torch_ranks import run_ranks
from repro_torch.core.coded_matmul import CodedMatvec
from repro_torch.core.coding import MDSCode
from repro_torch.core.s2c2 import general_allocation

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 120        # seconds, every subprocess
WORLD, N, K, CHUNKS = 4, 4, 3, 6
SPEEDS = [[1, 1, 1, 1], [1, 1, 1, 0.2], [2, 1, 1, 1]]
JAX_TOL = 3e-3       # tests/test_runtime.py's, on the same inputs
F64_TOL = 1e-5       # of the product's largest value: float32 sums over d = 16
SINGLE_TOL = 1e-6    # the single-device apply: the same float32 operations

JAX_SHARD_MAP = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np, jax, jax.numpy as jnp
    from repro.core.coding import MDSCode
    from repro.core.coded_matmul import CodedMatvec
    from repro.core.s2c2 import general_allocation
    from repro.launch.mesh import make_worker_mesh
    data = np.load(sys.argv[1])
    cm = CodedMatvec(MDSCode(n=4, k=3), chunks=6, mesh=make_worker_mesh(4))
    coded = cm.shard(jnp.asarray(data["a"]))
    out = [np.asarray(cm.apply(coded, jnp.asarray(data["x"]),
                               *cm.plan_tables(general_allocation(s, 3, 6)))).tolist()
           for s in data["speeds"]]
    print(json.dumps(out))
""")


def _coded_inputs() -> dict:
    rng = np.random.default_rng(0)
    a = rng.standard_normal((90, 16)).astype(np.float32)
    x = rng.standard_normal((16,)).astype(np.float32)
    return {"a": a, "x": x, "nk": np.array([N, K]), "chunks": np.array(CHUNKS),
            "speeds": np.array(SPEEDS, dtype=np.float64)}


@pytest.fixture(scope="module")
def coded_runs(tmp_path_factory):
    """(the inputs, every rank's outputs, the JAX package's y per speed vector)."""
    tmp = tmp_path_factory.mktemp("coded")
    inputs = _coded_inputs()
    ranks = run_ranks(tmp, "coded", inputs, WORLD, timeout=TIMEOUT)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}
    ref = subprocess.run([sys.executable, "-c", JAX_SHARD_MAP, str(tmp / "in.npz")],
                         capture_output=True, text=True, env=env, timeout=TIMEOUT)
    assert ref.returncode == 0, ref.stderr[-3000:]
    return inputs, ranks, [np.asarray(y) for y in json.loads(ref.stdout.strip().splitlines()[-1])]


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("which", range(len(SPEEDS)), ids=[str(s) for s in SPEEDS])
def test_worker_mesh_matches_jax_shard_map(coded_runs, which):
    inputs, ranks, jax_ys = coded_runs
    want = jax_ys[which]
    for r, out in enumerate(ranks):
        got = out[f"y{which}"][:want.shape[0]]
        assert np.allclose(got, want, rtol=JAX_TOL, atol=JAX_TOL), (r, SPEEDS[which])


@pytest.mark.parametrize("which", range(len(SPEEDS)), ids=[str(s) for s in SPEEDS])
def test_worker_mesh_matches_float64(coded_runs, which):
    inputs, ranks, _ = coded_runs
    want = inputs["a"].astype(np.float64) @ inputs["x"].astype(np.float64)
    for r, out in enumerate(ranks):
        y = out[f"y{which}"]
        assert y.shape == (90,) and y.dtype == np.float32
        assert _rel(y[:90], want) <= F64_TOL, (r, SPEEDS[which])


@pytest.mark.parametrize("which", range(len(SPEEDS)), ids=[str(s) for s in SPEEDS])
def test_worker_mesh_matches_the_single_device_apply(coded_runs, which):
    inputs, ranks, _ = coded_runs
    cm = CodedMatvec(MDSCode(N, K), CHUNKS, device="cpu")
    coded = cm.shard(torch.from_numpy(inputs["a"]))
    want = cm.apply(coded, torch.from_numpy(inputs["x"]),
                    *cm.plan_tables(general_allocation(SPEEDS[which], K, CHUNKS))).numpy()
    for r, out in enumerate(ranks):
        assert int(out["rows"]) == coded.shape[1]
        assert _rel(out[f"y{which}"], want) <= SINGLE_TOL, (r, SPEEDS[which])


def test_worker_mesh_on_the_cpu_launches_no_kernel(coded_runs):
    _, ranks, _ = coded_runs
    for out in ranks:
        assert out["launches"].tolist() == [0, 0, 0]


@pytest.mark.cuda
def test_worker_mesh_on_one_card_over_gloo(cuda, tmp_path):
    """The ``cuda`` twin: 4 gloo ranks share the card, each partition on it;
    every rank launches ``mds_encode`` once a chunk (C) and ``coded_matvec``
    and ``mds_decode`` once per apply."""
    inputs = _coded_inputs()
    ranks = run_ranks(tmp_path, "coded", inputs, WORLD, device="cuda", timeout=TIMEOUT)
    want = inputs["a"].astype(np.float64) @ inputs["x"].astype(np.float64)
    for r, out in enumerate(ranks):
        for which in range(len(SPEEDS)):
            assert _rel(out[f"y{which}"][:90], want) <= F64_TOL, (r, which)
        cmv, enc, dec = out["launches"].tolist()
        assert enc == CHUNKS and dec == len(SPEEDS) and 0 < cmv <= len(SPEEDS), (r, cmv, enc,
                                                                                 dec)


PHASE_ELEVEN = textwrap.dedent("""
    import json, sys
    import torch
    sys.path.insert(0, sys.argv[1])
    import chip_smoke
    if __name__ == "__main__":
        launches, record = chip_smoke.mesh_steps_phase(torch.device("cpu"), reduced=True)
        print(json.dumps({"launches": launches, "record": record}))
""")


def test_chip_smoke_phase_eleven_on_the_cpu(tmp_path):
    """``chip_smoke.py``'s phase 11 end to end on the CPU at its reduced
    sizes, in a process of its own (it makes process groups and spawns the
    worker mesh's ranks): (a) 4 ranks of a (4, 3) code within 1e-3 of
    float64, (b) two finite train steps, (c) the step builders bit for bit
    the model's own calls, and the same tokens on a (1, 1) mesh, (d) three
    families' serving (the MoE's among them) on a (2, 2) mesh of 4 gloo
    ranks against the unsharded run, in float32 and bfloat16, (e) a train
    step on that mesh: every rank's loss, gradient norm and parameters
    after it, and the unsharded float32 step's, within 1e-4 of the same
    step in float64; the CPU launches no kernel."""
    script = tmp_path / "phase11.py"
    script.write_text(PHASE_ELEVEN)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    out = subprocess.run([sys.executable, str(script), str(ROOT)], capture_output=True,
                         text=True, env=env, timeout=TIMEOUT)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["launches"] == {"coded_matvec": 0, "mds_encode": 0, "mds_decode": 0,
                               "lstm_cell": 0}
    mesh = got["record"]["mesh"]
    assert mesh["ranks"] == 4 and mesh["worst_rel_err"] <= 1e-3
    assert len(mesh["rank0_iter_ms"]) == mesh["iters"]
    train = got["record"]["train_step"]
    assert len(train["losses"]) == 2 and all(np.isfinite(train["losses"] + train["grad_norms"]))
    serve = got["record"]["serve_steps"]
    assert serve["tokens_equal"] and serve["mesh_prefill_logits_max_abs_err"] == 0.0
    assert "phase 11 (c): build_prefill_step + build_decode_step" in out.stdout
    sharded = got["record"]["mesh_serve"]
    for arch in ("zamba2-1.2b", "seamless-m4t-large-v2", "phi3.5-moe-42b-a6.6b"):
        for dtype in ("float32", "bfloat16"):
            rec = sharded[arch][dtype]
            assert rec["first_tokens_equal"], (arch, dtype)
            assert all(e <= lim for e, lim in zip(rec["rel_err_by_step"], rec["limit_by_step"]))
    trained = got["record"]["mesh_train"]
    assert trained["arch"].startswith("zamba2-1.2b") and trained["optimizer"] == "sgdm"
    assert trained["shape"] == [2, 2] and trained["params_held"] > 0
    # the unsharded float32 step and every rank against the float64 witness
    for key in ("loss", "grad_norm"):
        want = trained["witness"][key]
        assert np.isfinite(want)
        for got_v in trained[f"{key}_by_rank"] + [trained["unsharded"][key]]:
            assert abs(got_v - want) <= 1e-4 * abs(want), (key, got_v, want)
    # every parameter, those that start at zero too, within 1e-4 of the
    # witness's update (the half ulp of its value aside)
    errs = trained["update_rel_err"]
    assert len(errs) == 5 and all(e <= 1e-4 for e in errs.values()), errs
    assert trained["reckoned_peak_gb"] > 0
