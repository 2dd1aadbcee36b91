"""bfloat16 serving on a ``("data", "model")`` mesh of 4 gloo processes, on
the CPU, held against float32 and against the JAX package: the witness, at
reduced depth, for ``chip_smoke.py`` phase 11 (d)'s bfloat16 limit on the
card (zamba2-1.2b, seamless-m4t-large-v2 and phi3.5-moe).

The JAX package's side is its compiled program without excess precision
(``tests/_torch_jax_declared.py``): XLA's CPU compiler may keep bfloat16
intermediates in float32, which is the compiler's license and not the
program's; the port runs eagerly, on the CPU as on the card, and rounds
where its dtypes say to.  The JAX package's run with XLA's defaults is
still reckoned and shown in the assertion's message, beside the port's
and the declared-rounding run's distances.  The helpers and the sizes are
``tests/test_torch_mesh_serve.py``'s.
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
from _torch_ranks import run_ranks
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.models import build_model

pytestmark = pytest.mark.usefixtures("jax_on_cpu")   # the JAX reference on the CPU

torch.set_num_threads(1)

# bfloat16 against float32 (chip_smoke.py phase 11 (d)'s three models): the
# unsharded port's distance at the prefill and at each step at most
# BF16_JAX_RATIO times the declared-rounding JAX run's there, the mesh's at
# most BF16_MESH_RATIO (chip_smoke.MESH_BF16_RATIO) times the unsharded port's
BF16_ARCHS = ("zamba2-1.2b", "seamless-m4t-large-v2", "phi3.5-moe-42b-a6.6b")
BF16_JAX_RATIO, BF16_MESH_RATIO = 2.0, 1.5
DECLARED_TIMEOUT = 300   # seconds, the declared-rounding JAX process


@pytest.mark.parametrize("arch", BF16_ARCHS)
def test_sharded_bfloat16_as_near_float32_as_unsharded_and_jax(arch, tmp_path):
    """In bfloat16, on the same weights (drawn in bfloat16, upcast for
    float32) and tokens: the unsharded port's logits, at the prefill and at
    each decode step, no farther from its float32 run's than BF16_JAX_RATIO
    times the JAX package's bfloat16 run, compiled without excess
    precision, is from its float32 run at that point; each rank of the
    2 × 2 mesh no farther from the float32 run than BF16_MESH_RATIO times
    the unsharded bfloat16 run, and every greedy token it picks (the
    prefill's and each step's) the argmax of the logits it holds there.

    A rank's first tokens are not held to the unsharded bfloat16 run's: the
    two runs sum in other orders and lie as far apart as each lies from
    float32, so which of two near-equal logits wins is their rounding's
    toss.  Where they differ, the unsharded run's gap between the two
    tokens and the row's largest logit difference are printed."""
    cfg = get_config(arch).reduced()
    half = dataclasses.replace(cfg, dtype="bfloat16")
    rng = np.random.default_rng(5)
    prompt = {k: (v if k == "tokens" else np.asarray(jnp.asarray(v, jnp.bfloat16), np.float32))
              for k, v in T._prompt(cfg).items()}
    toks = rng.integers(0, cfg.vocab_size, (T.B, T.STEPS)).astype(np.int32)
    total = T.S + (cfg.frontend_tokens if cfg.frontend == "vit_stub" else 0)
    with ThreadPoolExecutor(1) as pool:
        declared = pool.submit(declared_serve, tmp_path / "declared", arch, prompt, toks, total,
                               timeout=DECLARED_TIMEOUT)
        jhalf, jprefill16, jlogits16, _, _ = T._jax_serve(arch, prompt, toks, total, "bfloat16")
        jfull = jax.tree.map(lambda a: a.astype(jnp.float32), jhalf)
        _, jprefill, jlogits, _, _ = T._jax_serve(arch, prompt, toks, total, "float32", jfull)
        model = lm_params_from_jax(jax.tree.map(np.asarray, jfull), build_model(cfg, device="cpu"))
        model16 = build_model(half, device="cpu")
        with torch.no_grad():
            for w, p in zip(model16.parameters(), model.parameters()):
                w.copy_(p)
        prefill, logits, _ = T._port_serve(model, cfg, prompt, toks, total)
        prefill16, logits16, _ = T._port_serve(model16, half, prompt, toks, total)
        inputs = {"arch": np.array(arch), "dtype": np.array("bfloat16"), "decode": toks,
                  **{f"b:{k}": v for k, v in prompt.items()},
                  **{f"p:{n}": p.detach().numpy() for n, p in model.named_parameters()}}
        ranks = run_ranks(tmp_path, "serve", inputs, 4, timeout=T.TIMEOUT)
        jd = declared.result()
    compiled = T._step_rel(jprefill16, jlogits16, jprefill, jlogits)
    rounded = T._step_rel(jd["prefill16"], jd["logits16"], jd["prefill"], jd["logits"])
    port = T._step_rel(prefill16, logits16, prefill, logits)
    assert port.max() > 0 and (port <= BF16_JAX_RATIO * rounded).all(), (
        f"prefill then each step: port {port}, JAX package without excess precision "
        f"{rounded}, with XLA's defaults {compiled}")
    port_off = float(port.max())
    first = np.argmax(logits16[0], axis=-1)
    for r, out in enumerate(ranks):
        mesh_off = T._run_rel(out["prefill"], out["logits"], prefill, logits)
        assert mesh_off <= BF16_MESH_RATIO * port_off, (r, mesh_off, port_off)
        held = np.argmax(np.concatenate([out["prefill"][None], out["logits"]]), -1).T
        picked = np.concatenate([out["first"], out["next"]], 1)
        assert (picked == held).all(), (r, picked, held)
        for i in np.flatnonzero(out["next"][:, 0] != first):
            mine, row = out["next"][i, 0], logits16[0, i]
            print(f"rank {r}, row {i}: first token {mine}, unsharded {first[i]}; the unsharded "
                  f"logit gap {row[first[i]] - row[mine]:.6g} beside the row's largest "
                  f"difference {np.abs(out['logits'][0, i] - row).max():.6g}")
