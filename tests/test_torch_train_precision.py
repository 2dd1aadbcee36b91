"""How far a float32 train step's gradient lies from float64, in the port and
in the JAX package, on the CPU.

``chip_smoke.py`` phase 11 (e) and ``examples/torch_train_precision.py``
hold the port's float32 train step of zamba2-1.2b to the same step in
float64 (``chip_smoke.float64_witness``).  Here, on the reduced zamba2-1.2b
with the JAX package's weights carried over (``lm_params_from_jax``), 4 ×
16 tokens at 1, 2 and 4 microbatches: the port's ``build_train_step`` in
float64 under the witness gives the reference gradient; the port's step in
float32 and the JAX package's ``build_train_step`` in float32 (``jax.grad``
on the CPU) are each held to it.  Each step's optimizer is a stub that
keeps the averaged gradient, so both packages' own accumulation runs.
The measure is ``chip_smoke.update_rel_err``'s, on the first SGDM update
−lr·g (lr = ``MESH_TRAIN_LR``): a leaf's largest error over the witness's
largest update of it, less half a float32 ulp of its largest value after
the step; a run's distance is its worst leaf's.  Held: the witness made no
float32 tensor, and at each microbatch count the port's distance is at
most ``JAX_RATIO`` times the JAX package's.
"""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cuda import jax_on_cpu  # noqa: F401  (fixture)
from repro.configs import get_config as jax_config
from repro.configs.base import ShapeConfig as JaxShape
from repro.launch import steps as JS
from repro.models import build_model as jax_build
from repro.models.params import initialize as jax_initialize
from repro_torch.configs import get_config, shape_by_name
from repro_torch.convert import jax_layout, lm_params_from_jax, unstack
from repro_torch.launch.steps import build_train_step
from repro_torch.models import build_model

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as CS  # noqa: E402

pytestmark = pytest.mark.usefixtures("jax_on_cpu")   # the JAX reference on the CPU

torch.set_num_threads(1)

ARCH = CS.MESH_TRAIN_ARCH
B, S = CS.MESH_TRAIN_TRAFFIC_REDUCED
LR = CS.MESH_TRAIN_LR
JAX_RATIO = 2.0


class _KeepGrads:
    """An optimizer whose update keeps the averaged gradient (and, for the
    JAX package's step, returns it in place of the parameters)."""

    def update(self, grads, state, params, step):
        self.grads = grads
        return grads, state


def _port_grads(model, accum: int, tokens: np.ndarray, witness=None) -> dict:
    """The port's averaged gradient by parameter name, float64."""
    cfg = dataclasses.replace(model.cfg, grad_accum_train=accum)
    shape = dataclasses.replace(shape_by_name("train_4k"), seq_len=S, global_batch=B)
    keep = _KeepGrads()
    batch = {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(tokens)}
    with witness if witness is not None else torch.enable_grad():
        build_train_step(cfg, shape, opt=keep)(model, None, 0, batch)
    return {name: (keep.grads[key] if index is None else keep.grads[key][index]).double()
            for name, (key, index, _) in jax_layout(model).items()}


def _jax_grads(jmodel, jparams, accum: int, tokens: np.ndarray, model) -> dict:
    cfg = dataclasses.replace(jmodel.cfg, grad_accum_train=accum)
    shape = JaxShape(name="train", seq_len=S, global_batch=B, kind="train")
    step = jax.jit(JS.build_train_step(cfg, shape, opt=_KeepGrads()))
    grads, _, _ = step(jparams, None, 0, {"tokens": jnp.asarray(tokens),
                                          "labels": jnp.asarray(tokens)})
    return {n: torch.from_numpy(np.asarray(g, np.float64))
            for n, g in unstack(jax.tree.map(np.asarray, grads), model).items()}


def _distance(got: dict, want: dict, start: dict) -> tuple:
    """(the worst leaf's ``update_rel_err`` of the update −LR·got against
    −LR·want, that leaf)."""
    rel = {}
    for name, g in want.items():
        after = start[name] - LR * g
        held = (LR * float((got[name] - g).abs().max()), LR * float(g.abs().max()),
                float(after.abs().max()), bool(torch.isfinite(got[name]).all()))
        assert held[3], name
        rel[name] = CS.update_rel_err(held)
    worst = max(rel, key=rel.get)
    return rel[worst], worst


def test_float32_gradient_as_near_float64_as_the_jax_package():
    cfg = get_config(ARCH).reduced()
    jmodel = jax_build(jax_config(ARCH).reduced())
    jparams = jax_initialize(jmodel.specs(), jax.random.PRNGKey(0))
    model = lm_params_from_jax(jax.tree.map(np.asarray, jparams), build_model(cfg, device="cpu"))
    model64 = lm_params_from_jax(jax.tree.map(np.asarray, jparams),
                                 build_model(cfg, device="cpu")).double()
    start = {n: p.detach().double() for n, p in model.named_parameters()}
    tokens = np.random.default_rng(7).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    seen = {}
    for accum in (1, 2, 4):
        witness = CS.float64_witness()
        want = _port_grads(model64, accum, tokens, witness)
        assert not witness.float32, dict(witness.float32)
        port = _distance(_port_grads(model, accum, tokens), want, start)
        ref = _distance(_jax_grads(jmodel, jparams, accum, tokens, model), want, start)
        seen[accum] = (port, ref)
    assert all(port[0] <= JAX_RATIO * ref[0] for port, ref in seen.values()), (
        "microbatches: ((port, its worst leaf), (JAX package, its worst leaf)) " + str(seen))
