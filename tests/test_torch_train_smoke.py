"""``chip_smoke.py``'s phase 10 (training through ``launch.train``) end to
end on the CPU, on the reduced configs and fewer steps, with the CUDA
events, synchronisation and memory calls stubbed: xlstm-125m trained with
group 3 killed at step 10, then restarted from its checkpoint; zamba2-1.2b
for BIG_STEPS steps beside its memory reckoning; the sLSTM scan's backward
against float64 and at a long sequence; every kernel counter at 0; a
microbatch of each arch run where the card's profiler would time it; (f)
seamless-m4t-large-v2 whole, phi3.5-moe, gemma3 and mistral-large at one
layer through ``launch.train.run``, each held to its float64 witness.  Then the
reckonings at full size on ``meta``, the entry point's split (``main`` is
``run(args, build(args))``; ``run`` trains the model it is given), and the
``cuda`` twins: the training entry point on the card launches none of the
four kernels.
"""

import dataclasses
import importlib.util
import math
from pathlib import Path

import pytest
import torch

from _torch_cuda import cuda  # noqa: F401  (fixture)
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.launch import train as launch_train
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
    assert list(record["families"]) == list(smoke.TRAIN_FAMILIES)
    for arch, fam in record["families"].items():
        cfg = smoke.family_config(arch, True)
        assert fam["layers"] == cfg.num_layers == smoke.TRAIN_LAYERS.get(arch, 4)
        assert len(fam["losses"]) == len(fam["step_s"]) == smoke.BIG_STEPS
        assert all(math.isfinite(v) for v in fam["losses"])
        assert fam["flags"][fam["flags"].index("--groups") + 1] == str(fam["groups"])
        assert fam["reckoned_gb"]["in_place"] < fam["reckoned_gb"]["total"]
        assert fam["microbatch"] == {"kernel_ms": None}
        wit = fam["witness"]
        assert wit["float32_ops"] == {}
        for key in ("loss", "grad_norm"):
            want = wit[f"witness_{key}"]
            assert abs(wit[key] - want) <= smoke.MESH_TRAIN_TOL * want
        assert wit["worst_leaf_rel_err"] <= smoke.MESH_TRAIN_UPDATE_TOL
        assert wit["leaves"] == len(list(build_model(cfg, device="meta").parameters()))
    assert record["families"]["phi3.5-moe-42b-a6.6b"]["witness"]["routed_otherwise"] == 0
    # the dense family's backward: GQA attention, SwiGLU, RMSNorm and an untied head
    large = record["families"]["mistral-large-123b"]
    assert large["layers"] == 1 and (large["groups"], large["tolerate"]) == (4, 1)
    assert len(large["losses"]) == 1 and math.isfinite(large["losses"][0])
    assert large["witness"]["float32_ops"] == {}
    assert large["witness"]["worst_leaf_rel_err"] <= smoke.MESH_TRAIN_UPDATE_TOL
    assert record["launches"] == dict.fromkeys(record["launches"], 0)
    out = capsys.readouterr().out
    assert "[train] loss_improved=True" in out and "dead=[3]" in out
    assert "phase 10 (b): zamba2-1.2b peak memory" in out
    assert "phase 10 (d): launches over (a)-(f)" in out
    # gemma3's sequence passes its reduced window, so the witness holds the mask
    gemma = smoke.family_config("gemma3-27b", True)
    flags = smoke.TRAIN_FLAGS_REDUCED["gemma3-27b"]
    assert int(flags[flags.index("--seq") + 1]) > gemma.sliding_window
    assert gemma.attn_layer_is_local(0)


def test_zamba2_training_reckoning_at_full_size():
    """The reckoned peak of zamba2-1.2b's coded AdamW training: 1.17 B
    parameters, 2.34 GB in bfloat16, about 61 GB in all with 8 groups."""
    smoke = _chip_smoke()
    model = build_model(get_config("zamba2-1.2b"), device="meta")
    got = smoke.coded_training_reckoning(model, 8)
    assert 2.3 < got["parameters"] < 2.4 and 37 < got["coded_trees"] < 38
    assert 60 < got["total"] < 62
    assert 51 < got["in_place"] < 52


@pytest.mark.parametrize("arch, groups, params, total, in_place", [
    ("seamless-m4t-large-v2", 8, 1.633, 84.9, 71.9),
    ("phi3.5-moe-42b-a6.6b", 4, 1.565, 56.3, 43.8),
    ("gemma3-27b", 4, 1.843, 66.3, 51.6),
    ("mistral-large-123b", 4, 2.189, 78.8, 61.3),
])
def test_family_training_reckoning_at_full_size(arch, groups, params, total, in_place):
    """Phase 10 (f)'s archs at full width and TRAIN_LAYERS' depth, at the
    groups of TRAIN_FLAGS: their parameters (billions) and their coded
    AdamW reckonings, in all and in place (GB), to their last digit."""
    smoke = _chip_smoke()
    flags = smoke.TRAIN_FLAGS[arch]
    assert int(flags[flags.index("--groups") + 1]) == groups
    model = build_model(smoke.family_config(arch, False), device="meta")
    assert sum(p.numel() for p in model.parameters()) / 1e9 == pytest.approx(params, abs=5e-4)
    got = smoke.coded_training_reckoning(model, groups)
    assert got["total"] == pytest.approx(total, abs=0.05)
    assert got["in_place"] == pytest.approx(in_place, abs=0.05)
    assert got["in_place"] == pytest.approx(got["total"] - got["decoded_and_scaled"])


def test_run_trains_the_model_it_is_given(tmp_path, monkeypatch, capsys):
    """``main(argv)`` gives the losses of ``run(args, build(args))``; ``run``
    trains a model built at a cut depth at that depth."""
    metrics = []
    real = launch_train.train
    monkeypatch.setattr(launch_train, "train",
                        lambda *a, **k: metrics.append(real(*a, **k)) or metrics[-1])
    argv = ["--arch", "gemma3-27b", "--reduced", "--coded-dp", "--groups", "4", "--tolerate",
            "1", "--steps", "2", "--batch", "4", "--seq", "24", "--device", "cpu"]
    assert main(argv + ["--ckpt-dir", str(tmp_path / "main")]) == 0
    args = launch_train.parse_args(argv + ["--ckpt-dir", str(tmp_path / "run")])
    assert launch_train.run(args, launch_train.build(args)) == 0
    assert len(metrics[0]["losses"]) == 2 and metrics[0]["losses"] == metrics[1]["losses"]
    cfg = dataclasses.replace(get_config("gemma3-27b").reduced(), num_layers=1)
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    args = launch_train.parse_args(argv + ["--ckpt-dir", str(tmp_path / "cut")])
    assert launch_train.run(args, model) == 0
    assert len(model.layers) == 1 and len(metrics) == 3
    assert metrics[2]["losses"] != metrics[1]["losses"]
    assert all(not torch.equal(before[n], p) for n, p in model.named_parameters())
    out = capsys.readouterr().out
    n_cut = sum(p.numel() for p in model.parameters()) / 1e6
    assert f"[train] arch={cfg.name} params={n_cut:.1f}M on cpu" in out
    with pytest.raises(ValueError, match="not on --device"):
        launch_train.run(args, build_model(cfg, device="meta"))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["xlstm-125m", "zamba2-1.2b", "seamless-m4t-large-v2",
                                  "phi3.5-moe-42b-a6.6b", "gemma3-27b"])
def test_cuda_training_launches_no_kernel(cuda, tmp_path, capsys, arch):  # noqa: F811
    ops.reset_launch_counts()
    assert main(["--arch", arch, "--reduced", "--coded-dp", "--steps", "2", "--batch", "8",
                 "--seq", "16", "--ckpt-dir", str(tmp_path)]) == 0
    assert ops.launch_counts() == dict.fromkeys(ops.launch_counts(), 0)
    assert "[train] loss_improved=" in capsys.readouterr().out
