"""The unsharded port's bfloat16 serving run held to the JAX package's on
another draw than the mesh test's: phi3.5-moe-42b-a6.6b's reduced config
at draw 11, as ``tests/_torch_bf16_parting.py`` defines a draw (weights
from ``PRNGKey(11)`` in bfloat16, upcast for float32; the prompt and the
decode tokens from ``default_rng(11)``).

At the prefill and at each decode step, the port's bfloat16 logits are no
farther from its float32 run's than ``BF16_JAX_RATIO`` times the JAX
package's bfloat16 run, compiled without excess precision
(``tests/_torch_jax_declared.py``), is from its float32 run.  It is the
witness that the port's activations round as the JAX package's program
rounds them: with ``F.silu``, which rounds once, the two runs part in the
prefill's first MoE and the port lands 8.8 times the JAX package's
distance at the first step.  A file of its own, so that xdist places it on
a worker of its own.
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_mesh_serve as T
from _torch_cuda import jax_on_cpu  # noqa: F401  (fixture)
from _torch_jax_declared import declared_serve
from repro.configs import get_config as jax_config
from repro.models import build_model as jax_build
from repro.models.params import initialize as jax_initialize
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.models import build_model

pytestmark = pytest.mark.usefixtures("jax_on_cpu")   # the JAX reference on the CPU

torch.set_num_threads(1)

ARCH = "phi3.5-moe-42b-a6.6b"
BF16_JAX_RATIO = 2.0       # tests/test_torch_mesh_serve_bf16.py's
DECLARED_TIMEOUT = 300     # seconds, the declared-rounding JAX process


@pytest.mark.parametrize("seed", [11])
def test_bfloat16_as_near_float32_as_the_jax_package_on_a_draw(seed, tmp_path):
    cfg = get_config(ARCH).reduced()
    half = dataclasses.replace(cfg, dtype="bfloat16")
    prompt = {"tokens": np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (T.B, T.S)).astype(np.int32)}
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                (T.B, T.STEPS)).astype(np.int32)
    with ThreadPoolExecutor(1) as pool:
        declared = pool.submit(declared_serve, tmp_path, ARCH, prompt, toks, T.S, seed=seed,
                               timeout=DECLARED_TIMEOUT)
        jcfg = dataclasses.replace(jax_config(ARCH).reduced(), dtype="bfloat16")
        jhalf = jax_initialize(jax_build(jcfg).specs(), jax.random.PRNGKey(seed))
        jfull = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), jhalf)
        model = lm_params_from_jax(jfull, build_model(cfg, device="cpu"))
        model16 = build_model(half, device="cpu")
        with torch.no_grad():
            for w, p in zip(model16.parameters(), model.parameters()):
                w.copy_(p)
        prefill, logits, _ = T._port_serve(model, cfg, prompt, toks, T.S)
        prefill16, logits16, _ = T._port_serve(model16, half, prompt, toks, T.S)
        jd = declared.result()
    port = T._step_rel(prefill16, logits16, prefill, logits)
    rounded = T._step_rel(jd["prefill16"], jd["logits16"], jd["prefill"], jd["logits"])
    assert port.max() > 0 and (port <= BF16_JAX_RATIO * rounded).all(), (
        f"prefill then each step: port {port}, JAX package without excess precision {rounded}")
