"""The port's dry-run (``python -m repro_torch.launch.dryrun``) and
``chip_smoke.py``'s phase 12, on the CPU.

* Two cells at full width on the pod mesh, each ``python -m
  repro_torch.launch.dryrun`` in a subprocess of its own with a time limit
  (process groups are global state): a prefill (zamba2-1.2b ×
  ``prefill_32k``) and a decode (xlstm-125m × ``decode_32k``), each on a
  ``fake`` group of 256 ranks.  Each record ends ``ok`` with the JAX
  package's keys and a positive count of every term, and the JAX
  package's unedited ``scripts/render_roofline_md.py`` renders it.
* ``chip_smoke.py``'s phase 12 at its reduced sizes, in a process of its
  own: the dry-run of its CPU cell, the roofline of phase 11's steps on
  the reduced configs, and the cluster demo on the CPU with its launches
  kept and held against their plain versions; the CPU launches no
  kernel.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
CELLS = {("zamba2-1.2b", "prefill_32k"): 900, ("xlstm-125m", "decode_32k"): 300}   # s
KEYS = {"arch", "shape", "mesh", "chips", "compile_s", "memory", "cost", "roofline", "status"}
MEMORY = {"argument_bytes", "output_bytes", "temp_bytes", "generated_code_bytes",
          "peak_resident_bytes"}


@pytest.mark.parametrize("arch,shape", list(CELLS))
def test_dryrun_cell_ends_ok_and_renders(arch, shape, tmp_path):
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                          "--shape", shape, "--mesh", "pod", "--out", str(tmp_path)],
                         capture_output=True, text=True, env=ENV, cwd=ROOT,
                         timeout=CELLS[arch, shape])
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    rec = json.loads((tmp_path / f"{arch}__{shape}__pod.json").read_text())
    assert rec["status"] == "ok" and KEYS <= set(rec) and set(rec["memory"]) == MEMORY
    assert rec["chips"] == 256 and rec["memory"]["generated_code_bytes"] == 0
    assert rec["memory"]["peak_resident_bytes"] == (rec["memory"]["argument_bytes"]
                                                    + rec["memory"]["temp_bytes"])
    rl = rec["roofline"]
    assert rl["flops_per_chip"] == rec["cost"]["flops"] > 0
    assert rl["bytes_per_chip"] == rec["cost"]["bytes accessed"] > 0
    assert rl["coll_bytes_per_chip"] > 0 and rl["model_flops_total"] > 0
    table = subprocess.run([sys.executable, "scripts/render_roofline_md.py", str(tmp_path)],
                           capture_output=True, text=True, cwd=ROOT, timeout=60)
    assert table.returncode == 0, table.stderr
    row = next(line for line in table.stdout.splitlines() if line.startswith(f"| {arch} |"))
    assert f"| {shape} | pod |" in row and f"| {rl['dominant']} |" in row


PHASE_TWELVE = textwrap.dedent("""
    import json, sys, tempfile
    from pathlib import Path
    import torch
    sys.path.insert(0, sys.argv[1])
    import chip_smoke

    def compare(name, got, want, tol):
        assert got.shape == want.shape and torch.allclose(got, want, rtol=tol, atol=tol), name
        return float((got - want).abs().max())

    if __name__ == "__main__":
        measured = {"train_step": {"step_s": [1.0, 2.0]}, "serve_steps": {"step_ms": [10.0]}}
        with tempfile.TemporaryDirectory() as tmp:
            started = chip_smoke.dryrun_start(chip_smoke.DRYRUN_CELLS_REDUCED, Path(tmp))
            launches, record = chip_smoke.roofline_phase(torch.device("cpu"), compare, measured,
                                                         (started, Path(tmp)), reduced=True)
        print(json.dumps({"launches": launches, "record": record}))
""")


def test_chip_smoke_phase_twelve_on_the_cpu(tmp_path):
    script = tmp_path / "phase12.py"
    script.write_text(PHASE_TWELVE)
    out = subprocess.run([sys.executable, str(script), str(ROOT)], capture_output=True,
                         text=True, env=ENV, timeout=600)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["launches"] == {"coded_matvec": 0, "mds_encode": 0, "mds_decode": 0,
                               "lstm_cell": 0, "coded_matvec (multi design)": 0}
    (dry,) = got["record"]["dryrun"]
    assert dry["status"] == "ok" and dry["arch"] == "xlstm-125m"
    steps = got["record"]["steps"]
    for kind, measured_s in (("train", 1.5), ("decode", 0.01)):
        assert steps[kind]["flops_per_chip"] > 0 and steps[kind]["chips"] == 1
        assert steps[kind]["measured_over_bound"] == pytest.approx(
            measured_s / steps[kind]["bound_time"])
    assert steps["decode_dryrun_memory"]["peak_resident_bytes"] > 0
    demo = got["record"]["demo"]
    assert set(demo["held_max_abs_err"]) == {"stream", "multi", "sequence"}
    assert max(demo["held_max_abs_err"].values()) == 0.0      # the plain version twice
    assert set(demo["held_max_abs_plain"]) == {"stream", "multi", "sequence"}
    assert min(demo["held_max_abs_plain"].values()) > 0.0     # each limit scales a value
    assert "phase 12 (c): examples/torch_cluster_demo.py on cpu: exit 0" in out.stdout
