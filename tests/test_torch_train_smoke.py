"""``chip_smoke.py``'s phase 10 (training through ``launch.train.main``)
end to end on the CPU, on the reduced configs and fewer steps, with the CUDA
events, synchronisation and memory calls stubbed: xlstm-125m trained with
group 3 killed at step 10, then restarted from its checkpoint; zamba2-1.2b
for three steps beside its memory reckoning; the sLSTM scan's backward
against float64 and at a long sequence; every kernel counter at 0; a
microbatch of each arch run where the card's profiler would time it.
Then the reckoning at full size on ``meta``, and the ``cuda`` twins: the
training entry point on the card launches none of the four kernels.
"""

import importlib.util
from pathlib import Path

import pytest
import torch

from _torch_cuda import cuda  # noqa: F401  (fixture)
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.launch.train import main
from repro_torch.models import build_model

torch.set_num_threads(1)


class _Event:
    """A stand-in for ``torch.cuda.Event`` on the CPU: every span 1 ms."""

    def __init__(self, *args, **kwargs):
        pass

    def record(self):
        pass

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return 1.0


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _compare(name, got, want, tol):
    assert torch.allclose(got, want, rtol=tol, atol=tol), name
    return float((got - want).abs().max())


def test_chip_smoke_phase_ten_on_the_cpu(monkeypatch, capsys):
    smoke = _chip_smoke()
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *args: None)
    monkeypatch.setattr(smoke, "device_kernel_ms", lambda fn, steps: fn() and None)
    launches, record = smoke.train_phase(torch.device("cpu"), _compare, reduced=True)
    assert launches == dict.fromkeys(launches, 0)      # training reaches no kernel
    steps, more, _, _ = smoke.TRAIN_STEPS_REDUCED
    xl = record["xlstm"]
    assert len(xl["losses"]) == steps and len(xl["restart_losses"]) == more - steps
    assert xl["loss_improved"] and len(xl["step_s"]) == steps   # each up to the final checkpoint
    assert len(record["zamba2"]["losses"]) == len(record["zamba2"]["step_s"]) == smoke.BIG_STEPS
    assert set(record["slstm_backward"]["rel_err"]) == {"dr", "db", "dxw"}
    assert sorted(record["slstm_backward"]["runs"]) == [smoke.SLSTM_BS[1], smoke.SLSTM_LONG_S[True]]
    assert record["zamba2"]["microbatch"] == {"kernel_ms": None}
    out = capsys.readouterr().out
    assert "[train] loss_improved=True" in out and "dead=[3]" in out
    assert "phase 10 (b): zamba2-1.2b peak memory" in out


def test_zamba2_training_reckoning_at_full_size():
    """The reckoned peak of zamba2-1.2b's coded AdamW training: 1.17 B
    parameters, 2.34 GB in bfloat16, about 61 GB in all with 8 groups."""
    smoke = _chip_smoke()
    model = build_model(get_config("zamba2-1.2b"), device="meta")
    got = smoke.coded_training_reckoning(model, 8)
    assert 2.3 < got["parameters"] < 2.4 and 37 < got["coded_trees"] < 38
    assert 60 < got["total"] < 62


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["xlstm-125m", "zamba2-1.2b", "seamless-m4t-large-v2"])
def test_cuda_training_launches_no_kernel(cuda, tmp_path, capsys, arch):  # noqa: F811
    ops.reset_launch_counts()
    assert main(["--arch", arch, "--reduced", "--coded-dp", "--steps", "2", "--batch", "8",
                 "--seq", "16", "--ckpt-dir", str(tmp_path)]) == 0
    assert ops.launch_counts() == dict.fromkeys(ops.launch_counts(), 0)
    assert "[train] loss_improved=" in capsys.readouterr().out
