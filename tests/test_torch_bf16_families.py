"""The unsharded port's bfloat16 serving run held to the JAX package's for
the decoder architectures that ``test_torch_mesh_serve_bf16`` does not
hold: gemma3-27b (local/global attention, rotating caches, the logit
softcap, GeGLU), internvl2-26b (the ``vit_stub`` projector and its image
embeddings), mixtral-8x22b (a sliding window on every layer, 8 experts
top-2), nemotron-4-340b (squared ReLU, LayerNorm), mistral-nemo-12b and
mistral-large-123b (global attention, SwiGLU, RMSNorm) and xlstm-125m
(mLSTM and sLSTM blocks).

Each reduced config, drawn from ``PRNGKey(0)`` in bfloat16 and upcast for
float32, prefills ``test_torch_mesh_serve``'s prompt (internvl2's with its
image embeddings, rounded to bfloat16) and takes its decode steps; the
prompt and the steps pass the reduced window of 16, so the local layers
of the archs with a window decode from rotating caches.  At the prefill and at each step the port's
bfloat16 logits are no farther from its float32 run's than
``BF16_JAX_RATIO`` times the JAX package's bfloat16 run, compiled without
excess precision (``tests/_torch_jax_declared.py``), is from its float32
run.  The witness for ``chip_smoke.py`` phase 8's bfloat16 limits on
these archs.
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

ARCHS = ("gemma3-27b", "internvl2-26b", "mixtral-8x22b", "nemotron-4-340b",
         "mistral-nemo-12b", "mistral-large-123b", "xlstm-125m")
BF16_JAX_RATIO = 2.0       # tests/test_torch_mesh_serve_bf16.py's
DECLARED_TIMEOUT = 300     # seconds, the declared-rounding JAX process


@pytest.mark.parametrize("arch", ARCHS)
def test_bfloat16_as_near_float32_as_the_jax_package(arch, tmp_path):
    cfg = get_config(arch).reduced()
    half = dataclasses.replace(cfg, dtype="bfloat16")
    prompt = {k: (v if k == "tokens" else np.asarray(jnp.asarray(v, jnp.bfloat16), np.float32))
              for k, v in T._prompt(cfg).items()}
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size,
                                             (T.B, T.STEPS)).astype(np.int32)
    total = T.S + (cfg.frontend_tokens if cfg.frontend == "vit_stub" else 0)
    if cfg.attn_pattern in ("sliding", "local_global"):
        assert total + T.STEPS > cfg.sliding_window   # local layers decode from rotating caches
    with ThreadPoolExecutor(1) as pool:
        declared = pool.submit(declared_serve, tmp_path, arch, prompt, toks, total,
                               timeout=DECLARED_TIMEOUT)
        jcfg = dataclasses.replace(jax_config(arch).reduced(), dtype="bfloat16")
        jhalf = jax_initialize(jax_build(jcfg).specs(), jax.random.PRNGKey(0))
        jfull = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), jhalf)
        model = lm_params_from_jax(jfull, build_model(cfg, device="cpu"))
        model16 = build_model(half, device="cpu")
        with torch.no_grad():
            for w, p in zip(model16.parameters(), model.parameters()):
                w.copy_(p)
        prefill, logits, _ = T._port_serve(model, cfg, prompt, toks, total)
        prefill16, logits16, _ = T._port_serve(model16, half, prompt, toks, total)
        jd = declared.result()
    port = T._step_rel(prefill16, logits16, prefill, logits)
    rounded = T._step_rel(jd["prefill16"], jd["logits16"], jd["prefill"], jd["logits"])
    print(f"{arch}, prefill then each step: port {port}, JAX package without excess precision "
          f"{rounded}")
    assert port.max() > 0 and (port <= BF16_JAX_RATIO * rounded).all(), (
        f"prefill then each step: port {port}, JAX package without excess precision {rounded}")
