"""A train step on DTensors across a 2 × 2 ``("data", "model")`` mesh of 4
gloo processes, on the CPU.

For a reduced float32 config of each family (``attn_mlp`` with global and
with local/global attention, ``vit_stub``, ``attn_moe``, Mamba-2 with the
shared attention block, the xLSTM, the encoder-decoder), the parameters
are placed by ``launch.steps.shard_model`` (``train_state_shardings``'
rules), the SGDM state by ``train_state_shardings`` and the batch by
``batch_shardings``, and ``build_train_step(mesh=...)`` takes one step
under ``with mesh:``.  Every rank's loss, ``grad_norm`` and every
parameter after the step (gathered) are held to the unsharded port step on
the same weights and batch, and to the JAX package's ``build_train_step``
(jitted, ``mesh=None``) at ``TOL``.  The unsharded step is the same
float32 arithmetic summed in another order: ``SHARDED_TOL`` for the dense
family (measured 1.7e-7), the parity tolerance ``TOL`` for the others (the
xLSTM's sequential recurrence carries the reordering furthest: 1.5e-5
measured, zamba2's 4.8e-6).  Every rank is a process of its own
(``tests/_torch_ranks.py``) with a time limit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cuda import jax_on_cpu  # noqa: F401  (fixture)
from _torch_ranks import run_ranks
from repro.configs import get_config as jax_config
from repro.configs.base import ShapeConfig as JaxShape
from repro.launch import steps as JS
from repro.models import build_model as jax_build
from repro.models.params import initialize as jax_initialize
from repro.optim.optimizer import make_optimizer as jax_optimizer
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import group, lm_params_from_jax, unstack
from repro_torch.launch.steps import build_train_step
from repro_torch.models import build_model
from repro_torch.optim.optimizer import make_optimizer

pytestmark = pytest.mark.usefixtures("jax_on_cpu")   # the JAX reference on the CPU

torch.set_num_threads(1)

TIMEOUT = 120        # seconds, every rank
WORLD, B, S, LR = 4, 4, 16, 1e-2
TOL = 1e-4           # a train step against the JAX package's (tests/test_torch_steps.py)
SHARDED_TOL = 1e-5   # the dense family's sharded step against its unsharded one
ARCHS = {"mistral-nemo-12b": SHARDED_TOL, "gemma3-27b": TOL, "internvl2-26b": TOL,
         "phi3.5-moe-42b-a6.6b": TOL, "zamba2-1.2b": TOL, "xlstm-125m": TOL,
         "seamless-m4t-large-v2": TOL}


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


@pytest.mark.parametrize("arch", list(ARCHS))
def test_sharded_train_step_matches_unsharded_and_jax(arch, tmp_path):
    cfg = get_config(arch).reduced()
    jmodel = jax_build(jax_config(arch).reduced())
    jparams = jax_initialize(jmodel.specs(), jax.random.PRNGKey(0))
    model = lm_params_from_jax(jax.tree.map(np.asarray, jparams),
                               build_model(cfg, device="cpu"))
    batch = _batch(cfg)
    inputs = {"arch": np.array(arch), "lr": np.array(LR),
              **{f"b:{k}": v for k, v in batch.items()},
              **{f"p:{n}": p.detach().numpy() for n, p in model.named_parameters()}}
    ranks = run_ranks(tmp_path, "train", inputs, WORLD, timeout=TIMEOUT)
    # the unsharded port step
    opt = make_optimizer("sgdm", lr=LR)
    step = build_train_step(cfg, ShapeConfig("smoke", S, B, "train"), opt=opt)
    metrics = step(model, opt.init(group(dict(model.named_parameters()), model)), 0,
                   {k: torch.from_numpy(v) for k, v in batch.items()})
    # the JAX package's
    jopt = jax_optimizer("sgdm", lr=LR)
    jstep = jax.jit(JS.build_train_step(jmodel.cfg, JaxShape("smoke", S, B, "train"),
                                        mesh=None, opt=jopt))
    jparams, _, jmetrics = jstep(jparams, jopt.init(jparams), 0, jax.tree.map(jnp.asarray, batch))
    jwant = unstack(jax.tree.map(np.asarray, jparams), model)
    sharded_tol = ARCHS[arch]
    for r, out in enumerate(ranks):
        for key in ("loss", "grad_norm"):
            got, want, jwant_v = float(out[key]), float(metrics[key]), float(jmetrics[key])
            assert abs(got - want) <= sharded_tol * abs(want), (r, key, got, want)
            assert abs(got - jwant_v) <= TOL * abs(jwant_v), (r, key, got, jwant_v)
        for name, p in model.named_parameters():
            got = out[f"p:{name}"]
            assert _rel(got, p.detach().numpy()) <= sharded_tol, (r, name)
            assert _rel(got, jwant[name]) <= TOL, (r, name)
