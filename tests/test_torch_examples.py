"""The port's examples run end to end on the CPU (``--device cpu``), each in
a fresh interpreter, with the assertions their JAX counterparts make."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _run(name: str, *args: str) -> str:
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    out = subprocess.run([sys.executable, str(ROOT / "examples" / name), "--device", "cpu",
                          *args], capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    return out.stdout


@pytest.mark.parametrize("name", ["torch_quickstart.py", "torch_pagerank.py",
                                  "torch_serve_lm.py", "torch_cluster_demo.py"])
def test_example_runs_and_asserts(name):
    assert _run(name).splitlines()[-1] == "OK"


def test_coded_regression_example_runs():
    out = _run("torch_coded_regression.py")
    for loss in ("logistic", "hinge"):
        line = next(ln for ln in out.splitlines() if ln.startswith(f"[{loss}] coded GD on cpu"))
        assert float(line.rsplit("accuracy=", 1)[1]) > 0.8
    assert "general-s2c2" in out


def test_train_lm_example_runs_and_the_loss_improves(tmp_path):
    """``examples/torch_train_lm.py`` for 12 steps (group 3 dead from step
    10), into a fresh checkpoint directory: it runs to the end and the loss
    improves, as ``examples/train_lm.py``'s does."""
    out = _run("torch_train_lm.py", "--steps", "12", "--ckpt-dir", str(tmp_path / "ckpt"))
    assert "[train] loss_improved=True" in out.splitlines()
    assert "dead=[3]" in out and (tmp_path / "ckpt" / "step_00000011").is_dir()


def test_train_precision_example_holds_float32_to_the_float64_witness():
    """``examples/torch_train_precision.py`` at the reduced size: the float32
    step at 1 and 4 microbatches, every leaf within 1e-4 of the float64
    witness's update (the half ulp of its value aside), the losses within
    1e-6 of the witness's, relative."""
    rec = json.loads(_run("torch_train_precision.py", "--reduced", "--accum", "1",
                          "4").splitlines()[-1])
    assert set(rec["runs"]) == {"1", "4"}
    for run in rec["runs"].values():
        want = rec["witness"]["loss"]
        assert run["finite"] and abs(run["loss"] - want) <= 1e-6 * abs(want), (run, want)
        for kind in ("zero_start", "others"):
            assert run[kind]["update_rel_err"] <= 1e-4, (kind, run[kind])
