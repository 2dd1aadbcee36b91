"""The port's forward and train step on a ``("data", "model")`` mesh of
``(1, 4)``, 4 gloo processes on the CPU, where the model axis does not
divide every head count.

On that mesh each reduced config's 64-column K and V projections (2 KV
heads × 32) split 16 columns a rank, half a head: a head view of such a
projection needs the heads whole on each rank (the JAX package's GSPMD
reshards the reshape).  For one reduced float32 config of each family,
the parameters placed by ``launch.steps.shard_model``, the SGDM state by
``train_state_shardings`` and the batch by ``batch_shardings``, every
rank runs ``build_prefill_step`` and then one ``build_train_step``; the
prefill's last-position logits, the loss, the gradient norm and every
parameter after the step (gathered) are held to the unsharded port step
on the same weights and batch within ``TOL`` of each quantity's largest
value: the same float32 arithmetic summed in another order.  The xLSTM's
parameters are held at ``tests/test_torch_mesh_train.py``'s parity
tolerance instead (``PARAM_TOL``): its sLSTM biases start at zero, so
after one step they are the gradient itself, which the recurrence
conditions badly.  A perturbation of the unsharded weights by half a
float32 ulp moves ``b_gates`` after the step by 9.2e-6 of its largest
value; the sharded step differs from the unsharded one by 3.4e-5 there,
and by at most 4.6e-7 in every other parameter.  Every rank is a process
of its own (``tests/_torch_ranks.py``) with a time limit.
"""

import numpy as np
import pytest
import torch

from _torch_ranks import run_ranks
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import group
from repro_torch.launch.steps import build_prefill_step, build_train_step
from repro_torch.models import build_model
from repro_torch.optim.optimizer import make_optimizer

torch.set_num_threads(1)

TIMEOUT = 120        # seconds, every rank
MESH, B, S, LR = (1, 4), 4, 16, 1e-2
TOL = 1.5e-5         # relative to the largest value of each quantity
PARAM_TOL = {"xlstm-125m": 1e-4}
ARCHS = ["mistral-nemo-12b", "gemma3-27b", "internvl2-26b", "phi3.5-moe-42b-a6.6b",
         "zamba2-1.2b", "xlstm-125m", "seamless-m4t-large-v2"]


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.abs(got - want).max() / max(float(np.abs(want).max()), 1e-30))


def _batch(cfg) -> dict:
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    out = {"tokens": toks, "labels": toks}
    if cfg.frontend == "vit_stub":
        out["image_embeds"] = rng.standard_normal(
            (B, cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32)
    if cfg.is_encdec:
        out["frames"] = rng.standard_normal((B, S // 2, cfg.frontend_dim)).astype(np.float32)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_model_axis_that_splits_heads_matches_unsharded(arch, tmp_path):
    cfg = get_config(arch).reduced()
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    batch = _batch(cfg)
    inputs = {"arch": np.array(arch), "lr": np.array(LR), "mesh": np.array(MESH),
              "prefill": np.array(1),
              **{f"b:{k}": v for k, v in batch.items()},
              **{f"p:{n}": p.detach().numpy() for n, p in model.named_parameters()}}
    ranks = run_ranks(tmp_path, "train", inputs, int(np.prod(MESH)), timeout=TIMEOUT)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    logits, _ = build_prefill_step(cfg)(model, {k: v for k, v in tbatch.items()
                                                if k != "labels"})
    opt = make_optimizer("sgdm", lr=LR)
    step = build_train_step(cfg, ShapeConfig("smoke", S, B, "train"), opt=opt)
    metrics = step(model, opt.init(group(dict(model.named_parameters()), model)), 0, tbatch)
    for r, out in enumerate(ranks):
        assert _rel(out["logits"], logits.detach().numpy()) <= TOL, (r, "logits")
        for key in ("loss", "grad_norm"):
            got, want = float(out[key]), float(metrics[key])
            assert abs(got - want) <= TOL * abs(want), (r, key, got, want)
        for name, p in model.named_parameters():
            assert _rel(out[f"p:{name}"], p.detach().numpy()) <= PARAM_TOL.get(arch, TOL), (r, name)
