"""The port's step builders (``launch/steps.py``) held to the JAX package's,
on the CPU, at reduced float32 configs with the same weights
(``convert.lm_params_from_jax``).

* ``build_train_step`` against the JAX package's, jitted with
  ``mesh=None``, for one arch of each family (``attn_mlp``, ``attn_moe``,
  Mamba-2 with the shared attention block, the xLSTM, the
  encoder-decoder), with one microbatch and with two
  (``REPRO_GRAD_ACCUM=2``, which both packages read): two SGDM steps, each
  step's loss and ``grad_norm`` within ``TOL`` of the reference's, and
  then every parameter within ``TOL`` of its leaf's largest value (SGDM,
  linear in the gradient, so that a wrongly scaled gradient shows; as
  ``tests/test_torch_train.py`` holds ``train``).
* ``build_prefill_step`` (the decoder, the ``vit_stub`` and the
  encoder-decoder branches) against the JAX package's: the last
  position's logits within ``TOL`` of their largest value; then
  ``build_decode_step`` over ``STEPS`` greedy steps from the caches of a
  prefill with room for them, in both packages: the same tokens, and the
  final caches within ``TOL``.
"""


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
from repro.optim.optimizer import make_optimizer as jax_optimizer
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import group, lm_params_from_jax, unstack
from repro_torch.launch import steps as S
from repro_torch.models import build_model
from repro_torch.optim.optimizer import make_optimizer

pytestmark = pytest.mark.usefixtures("jax_on_cpu")   # the JAX reference on the CPU

torch.set_num_threads(1)   # small shapes; leave the cores to the timing-sensitive cluster tests

TRAIN_ARCHS = ["mistral-nemo-12b", "phi3.5-moe-42b-a6.6b", "zamba2-1.2b", "xlstm-125m",
               "seamless-m4t-large-v2"]
SERVE_ARCHS = TRAIN_ARCHS + ["internvl2-26b"]
TOL = 1e-4          # the forward and gradient parity's (tests/test_torch_train.py)
LR = 1e-2
B, SEQ, STEPS = 4, 16, 4


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _pair(arch: str):
    """(the port's model, the JAX model, its parameters) with the same weights."""
    jmodel = jax_build(jax_config(arch).reduced())
    jparams = jax_initialize(jmodel.specs(), jax.random.PRNGKey(0))
    model = lm_params_from_jax(jax.tree.map(np.asarray, jparams),
                               build_model(get_config(arch).reduced(), device="cpu"))
    return model, jmodel, jparams


def _batch(cfg, kind: str, seed: int = 0) -> dict:
    """A numpy batch of the cell's keys (tokens int32, as abstract_inputs
    makes them; frames and image embeds float32)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, SEQ)).astype(np.int32)
    out = {"tokens": toks}
    if kind == "train":
        out["labels"] = toks
    if cfg.frontend == "vit_stub":
        out["image_embeds"] = rng.standard_normal(
            (B, cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32)
    if cfg.is_encdec:
        out["frames"] = rng.standard_normal((B, SEQ // 2, cfg.frontend_dim)).astype(np.float32)
    return out


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.abs(got - want).max() / max(float(np.abs(want).max()), 1e-30))


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_step_matches_jax(arch, accum, monkeypatch):
    monkeypatch.setenv("REPRO_GRAD_ACCUM", str(accum))
    model, jmodel, jparams = _pair(arch)
    cfg = model.cfg
    shape = ShapeConfig("smoke", SEQ, B, "train")
    assert S.grad_accum_for(cfg, shape) == accum
    jopt, opt = jax_optimizer("sgdm", lr=LR), make_optimizer("sgdm", lr=LR)
    jstep = jax.jit(JS.build_train_step(jmodel.cfg, JaxShape("smoke", SEQ, B, "train"),
                                        mesh=None, opt=jopt))
    step = S.build_train_step(cfg, shape, opt=opt)
    jstate = jopt.init(jparams)
    state = opt.init(group(dict(model.named_parameters()), model))
    for i in range(2):
        batch = _batch(cfg, "train", seed=i)
        jparams, jstate, jmetrics = jstep(jparams, jstate, i, jax.tree.map(jnp.asarray, batch))
        metrics = step(model, state, i, {k: torch.from_numpy(v) for k, v in batch.items()})
        for key in ("loss", "grad_norm"):
            got, want = float(metrics[key]), float(jmetrics[key])
            assert metrics[key].dtype == torch.float32
            assert abs(got - want) <= TOL * abs(want), (i, key, got, want)
    want = unstack(jax.tree.map(np.asarray, jparams), model)
    errors = {name: _rel(_np(p), want[name]) for name, p in model.named_parameters()}
    assert max(errors.values()) <= TOL, max(errors.items(), key=lambda kv: kv[1])


def _jax_cache_leaves(caches) -> list:
    return [np.asarray(v) for v in jax.tree.leaves(caches)]


def _cache_leaves(caches) -> list:
    """The port's caches in the JAX package's flattening order (keys sorted)."""
    if isinstance(caches, dict):
        return [v for k in sorted(caches) for v in _cache_leaves(caches[k])]
    if isinstance(caches, list):
        return [v for c in caches for v in _cache_leaves(c)]
    return [_np(caches)]


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_prefill_and_decode_steps_match_jax(arch):
    model, jmodel, jparams = _pair(arch)
    cfg = model.cfg
    batch = _batch(cfg, "prefill")
    jbatch = jax.tree.map(jnp.asarray, batch)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    jlogits, _ = jax.jit(JS.build_prefill_step(jmodel.cfg))(jparams, jbatch)
    prefill = S.build_prefill_step(cfg)
    logits, _ = prefill(model, tbatch)
    assert logits.shape == (B, cfg.padded_vocab) and logits.dtype == torch.float32
    assert _rel(_np(logits), np.asarray(jlogits)) <= TOL
    # greedy steps from a prefill with room for them
    total = SEQ + (cfg.frontend_tokens if cfg.frontend == "vit_stub" else 0)
    max_seq = total + STEPS
    extra = {"image_embeds": jbatch["image_embeds"]} if "image_embeds" in jbatch else {}
    if cfg.is_encdec:
        jlogits, jcaches = jmodel.prefill(jparams, jbatch["frames"], jbatch["tokens"],
                                          max_seq=max_seq)
    else:
        jlogits, jcaches = jmodel.prefill(jparams, jbatch["tokens"], max_seq=max_seq, **extra)
    logits, caches = prefill(model, tbatch, max_seq=max_seq)
    jdecode = jax.jit(JS.build_decode_step(jmodel.cfg))
    decode = S.build_decode_step(cfg)
    jtok = jnp.argmax(jlogits, -1).astype(jnp.int32)[:, None]
    tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
    for i in range(STEPS):
        assert np.array_equal(_np(tok), np.asarray(jtok)), i
        jtok, jcaches = jdecode(jparams, {"token": jtok, "caches": jcaches,
                                          "pos": jnp.int32(total + i)})
        tok, caches = decode(model, {"token": tok, "caches": caches,
                                     "pos": torch.tensor(total + i, dtype=torch.int32)})
        assert tok.dtype == torch.int32 and tok.shape == (B, 1)
    assert np.array_equal(_np(tok), np.asarray(jtok))
    got, want = _cache_leaves(caches), _jax_cache_leaves(jcaches)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _rel(g, w.astype(np.float32)) <= TOL
