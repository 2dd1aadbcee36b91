"""Serving on DTensors across a ``("data", "model")`` mesh of 4 gloo
processes, on the CPU: a prefill and decode steps with every cache and
recurrent state sharded as ``launch.sharding.cache_sharding_rules`` places
it.

For a reduced float32 config of each family (``attn_mlp`` with global and
with local/global attention, ``vit_stub``, ``attn_moe``, Mamba-2 with the
shared attention block, the xLSTM, the encoder-decoder), on a 2 × 2 mesh
(and mistral-nemo-12b also on 1 × 4, where the 2 KV heads do not divide
the model axis and the caches split head_dim instead), the weights are
placed by ``launch.steps.shard_model`` with ``serve_rules`` (as the dry-run
places a serving cell's), ``build_prefill_step`` prefills a prompt of
``S`` tokens with room for ``STEPS`` more, and ``build_decode_step`` takes
``STEPS`` steps on fixed tokens.  Every rank's prefill logits, each step's
logits, and every cache after the last step (gathered) are held at ``TOL``
to the unsharded port's same calls and to the JAX package's
(``build_prefill_step`` for the prompt's logits, ``decode_step`` with a
prefill sized for the steps); each step's greedy token is the argmax of
the JAX package's logits (its ``build_decode_step``'s token); after the
prefill and after every step each cache is a DTensor placed by
``cache_sharding_rules``.  Every rank is a process of its own
(``tests/_torch_ranks.py``) with a time limit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cuda import jax_on_cpu  # noqa: F401  (fixture)
from _torch_ranks import run_ranks
from repro.configs import get_config as jax_config
from repro.launch import steps as JS
from repro.models import build_model as jax_build
from repro.models.params import initialize as jax_initialize
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.launch.steps import build_prefill_step
from repro_torch.models import build_model

pytestmark = pytest.mark.usefixtures("jax_on_cpu")   # the JAX reference on the CPU

torch.set_num_threads(1)

TIMEOUT = 120        # seconds, every rank
B, S, STEPS = 4, 16, 4
TOL = 1e-4           # relative to the largest value of each quantity
CASES = [("mistral-nemo-12b", (2, 2)), ("mistral-nemo-12b", (1, 4)), ("gemma3-27b", (2, 2)),
         ("internvl2-26b", (2, 2)), ("phi3.5-moe-42b-a6.6b", (2, 2)), ("zamba2-1.2b", (2, 2)),
         ("xlstm-125m", (2, 2)), ("seamless-m4t-large-v2", (2, 2))]


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.abs(got - want).max() / max(float(np.abs(want).max()), 1e-30))


def _prompt(cfg) -> dict:
    rng = np.random.default_rng(3)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.frontend == "vit_stub":
        out["image_embeds"] = rng.standard_normal(
            (B, cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32)
    if cfg.is_encdec:
        out["frames"] = rng.standard_normal((B, S // 2, cfg.frontend_dim)).astype(np.float32)
    return out


def _flat(caches) -> dict:
    return {f"c:{i}:{kind}:{name}": np.asarray(c.float() if isinstance(c, torch.Tensor) else c,
                                               dtype=np.float32)
            for i, entry in enumerate(caches) for kind, state in entry.items()
            for name, c in state.items()}


def _jax_serve(arch: str, prompt: dict, toks: np.ndarray, total: int, dtype: str = "float32",
               jparams=None):
    """The JAX package's (params, prefill logits, step logits, step tokens,
    caches), its reduced config in ``dtype``, with ``jparams`` (drawn from
    seed 0 when None)."""
    jmodel = jax_build(dataclasses.replace(jax_config(arch).reduced(), dtype=dtype))
    if jparams is None:
        jparams = jax_initialize(jmodel.specs(), jax.random.PRNGKey(0))
    jb = jax.tree.map(jnp.asarray, prompt)
    prefill_logits, _ = jax.jit(JS.build_prefill_step(jmodel.cfg))(jparams, jb)
    extra = {"image_embeds": jb["image_embeds"]} if "image_embeds" in jb else {}
    if jmodel.cfg.is_encdec:
        _, caches = jmodel.prefill(jparams, jb["frames"], jb["tokens"], max_seq=total + STEPS)
    else:
        _, caches = jmodel.prefill(jparams, jb["tokens"], max_seq=total + STEPS, **extra)
    step, greedy = jax.jit(jmodel.decode_step), jax.jit(JS.build_decode_step(jmodel.cfg))
    logits, nexts = [], []
    for t in range(STEPS):
        batch = {"token": jnp.asarray(toks[:, t:t + 1]), "caches": caches,
                 "pos": jnp.int32(total + t)}
        nexts.append(np.asarray(greedy(jparams, batch)[0]))
        lg, caches = step(jparams, batch["token"], caches, batch["pos"])
        logits.append(np.asarray(lg))
    return (jparams, np.asarray(prefill_logits, np.float32),
            np.stack(logits).astype(np.float32), np.concatenate(nexts, 1),
            _flat(jax.tree.map(np.asarray, caches)))


def _port_serve(model, cfg, prompt: dict, toks: np.ndarray, total: int):
    """The unsharded port's (prefill logits, each step's logits from
    ``decode_step``, which ``build_decode_step`` calls, caches)."""
    batch = {k: torch.from_numpy(v) for k, v in prompt.items()}
    logits, caches = build_prefill_step(cfg)(model, batch, max_seq=total + STEPS)
    seen = []
    for t in range(STEPS):
        lg, caches = model.decode_step(torch.from_numpy(toks[:, t:t + 1]), caches, total + t)
        seen.append(lg.float().numpy())
    return logits.float().numpy(), np.stack(seen), _flat(caches)


@pytest.mark.parametrize("arch,mesh", CASES, ids=[f"{a}-{m[0]}x{m[1]}" for a, m in CASES])
def test_sharded_serving_matches_unsharded_and_jax(arch, mesh, tmp_path):
    cfg = get_config(arch).reduced()
    prompt = _prompt(cfg)
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (B, STEPS)).astype(np.int32)
    total = S + (cfg.frontend_tokens if cfg.frontend == "vit_stub" else 0)
    jparams, jprefill, jlogits, jnext, jcaches = _jax_serve(arch, prompt, toks, total)
    model = lm_params_from_jax(jax.tree.map(np.asarray, jparams), build_model(cfg, device="cpu"))
    inputs = {"arch": np.array(arch), "mesh": np.array(mesh), "decode": toks,
              **{f"b:{k}": v for k, v in prompt.items()},
              **{f"p:{n}": p.detach().numpy() for n, p in model.named_parameters()}}
    ranks = run_ranks(tmp_path, "serve", inputs, int(np.prod(mesh)), timeout=TIMEOUT)
    prefill, logits, caches = _port_serve(model, cfg, prompt, toks, total)
    assert _rel(prefill, jprefill) <= TOL and _rel(logits, jlogits) <= TOL
    assert set(caches) == set(jcaches)
    for r, out in enumerate(ranks):
        assert out["placed"].tolist() == [True] * (STEPS + 1), (r, out["placed"])
        assert _rel(out["prefill"], prefill) <= TOL, (r, "prefill")
        assert _rel(out["prefill"], jprefill) <= TOL, (r, "prefill, JAX")
        assert _rel(out["logits"], logits) <= TOL, (r, "logits")
        assert _rel(out["logits"], jlogits) <= TOL, (r, "logits, JAX")
        assert (out["next"] == jnext).all(), (r, out["next"], jnext)
        for name, want in caches.items():
            assert _rel(out[name], want) <= TOL, (r, name)
            assert _rel(out[name], jcaches[name]) <= TOL, (r, name, "JAX")


def _step_rel(prefill, logits, ref_prefill, ref_logits) -> np.ndarray:
    """A run's largest logit error at the prefill and at each decode step,
    each over the reference run's largest logit (prefill and steps)."""
    scale = max(float(np.abs(ref_prefill).max()), float(np.abs(ref_logits).max()))
    return np.array([float(np.abs(prefill - ref_prefill).max())] +
                    [float(np.abs(a - b).max()) for a, b in zip(logits, ref_logits)]) / scale


def _run_rel(prefill, logits, ref_prefill, ref_logits) -> float:
    """A run's largest logit error (the prefill's and the steps') over the
    reference run's largest logit."""
    return float(_step_rel(prefill, logits, ref_prefill, ref_logits).max())
