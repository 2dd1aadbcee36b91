"""The port's decoder LM held to the JAX package's, on the CPU.

For the reduced (float32) config of each of the five ``attn_mlp`` archs,
the JAX package's parameters (``initialize(model.specs(), PRNGKey(0))``)
are carried into the port's ``LM`` by ``lm_params_from_jax``; then
``forward_train``, ``loss_fn`` and 16 ``decode_step`` calls must give the
JAX package's logits at rtol = atol = 1e-4 (float32 sums in another
order), and ``init_cache`` its shapes.  ``prefill`` then ``decode_step``
mirrors ``tests/test_models.py::test_prefill_matches_decode_handoff`` at
its 2e-3; the attention cores mirror ``TestBlockwiseAttention``'s cases;
the full-size parameter counts are taken on the ``meta`` device.  The JAX
reference runs on the CPU (``jax_on_cpu``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cuda import cuda, jax_on_cpu  # noqa: F401  (fixtures)
from repro.configs import get_config as jax_config
from repro.models import build_model as jax_build
from repro.models import layers as JL
from repro.models.params import initialize as jax_initialize
from repro.models.params import param_count as jax_param_count
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.models import LM, build_model
from repro_torch.models import layers as L
from repro_torch.models.params import ParamSpec, initialize, param_count, tree_bytes

pytestmark = pytest.mark.usefixtures("jax_on_cpu")   # the JAX reference on the CPU

torch.set_num_threads(1)   # small shapes; leave the cores to the timing-sensitive cluster tests

ATTN_MLP = ["mistral-nemo-12b", "mistral-large-123b", "nemotron-4-340b", "gemma3-27b",
            "internvl2-26b"]
TOL = 1e-4          # float32 logits of a 4-layer model, sums in another order
HANDOFF_TOL = 2e-3  # tests/test_models.py::test_prefill_matches_decode_handoff
STEPS = 16


class _Pair:
    """One reduced arch on both stacks, with the same parameters."""

    def __init__(self, arch: str, device="cpu"):
        self.cfg = get_config(arch).reduced()
        self.jmodel = jax_build(jax_config(arch).reduced())
        self.jparams = jax_initialize(self.jmodel.specs(), jax.random.PRNGKey(0))
        self.model = lm_params_from_jax(jax.tree.map(np.asarray, self.jparams),
                                        build_model(self.cfg, device=device))
        self.device = device

    def batch(self, b: int, s: int, seed: int = 0):
        """The same batch for both: (JAX's, the port's)."""
        rng = np.random.default_rng(seed)
        toks = rng.integers(0, self.cfg.vocab_size, (b, s)).astype(np.int32)
        jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
        tb = {"tokens": torch.as_tensor(toks, dtype=torch.long, device=self.device)}
        tb["labels"] = tb["tokens"]
        if self.cfg.frontend == "vit_stub":
            img = rng.standard_normal((b, self.cfg.frontend_tokens,
                                       self.cfg.frontend_dim)).astype(np.float32)
            jb["image_embeds"] = jnp.asarray(img)
            tb["image_embeds"] = torch.as_tensor(img, device=self.device)
        return jb, tb


@pytest.fixture(scope="module", params=ATTN_MLP)
def pair(request, jax_on_cpu):  # noqa: F811  (the JAX side is made on the CPU too)
    return _Pair(request.param)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def test_forward_train_and_loss_match_jax(pair):
    jb, tb = pair.batch(2, 32)
    jm = pair.jmodel
    want, want_loss = jax.jit(lambda p, b: (jm.forward_train(p, b), jm.loss_fn(p, b)))(
        pair.jparams, jb)
    with torch.no_grad():
        got = pair.model.forward_train(tb)
        loss = float(pair.model.loss_fn(tb))
    assert got.dtype == torch.float32 and got.shape[-1] == pair.cfg.padded_vocab
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(loss, float(want_loss), rtol=TOL)


def _decode_both(pair, b: int, steps: int, device="cpu"):
    """Logits of ``steps`` decode steps from scratch, (JAX's, the port's)."""
    toks = np.random.default_rng(1).integers(0, pair.cfg.vocab_size, (b, steps))
    jcache, tcache = pair.jmodel.init_cache(b, steps), pair.model.init_cache(b, steps)
    step = jax.jit(pair.jmodel.decode_step)
    want, got = [], []
    for t in range(steps):
        lg, jcache = step(pair.jparams, jnp.asarray(toks[:, t:t + 1], jnp.int32), jcache,
                          jnp.int32(t))
        want.append(np.asarray(lg))
        lg, tcache = pair.model.decode_step(
            torch.as_tensor(toks[:, t:t + 1], device=device), tcache, t)
        got.append(_np(lg))
    return np.stack(want), np.stack(got)


def test_decode_step_matches_jax(pair):
    want, got = _decode_both(pair, 2, STEPS)
    assert got.shape == (STEPS, 2, pair.cfg.padded_vocab)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("max_seq", [STEPS, 40])
def test_init_cache_has_the_reference_shapes(pair, max_seq):
    """Full-length caches, and window-sized ones for local layers once
    max_seq passes the window (gemma's reduced window is 16)."""
    want = [{name: tuple(a.shape) for name, a in c["attn"].items()}
            for c in pair.jmodel.init_cache(2, max_seq)]
    got = pair.model.init_cache(2, max_seq)
    assert [{name: tuple(a.shape) for name, a in c["attn"].items()} for c in got] == want
    assert all(a.dtype == torch.float32 for c in got for a in c["attn"].values())


@pytest.mark.parametrize("arch,s", [("mistral-nemo-12b", 12), ("gemma3-27b", 20)])
def test_prefill_then_decode_matches_jax(arch, s):
    """prefill(S tokens) then decode_step(S): against JAX's same two calls,
    and against the port's decode from scratch.  Gemma's S = 20 passes its
    reduced window of 16, so its local layers hand over a rotated cache."""
    p = _Pair(arch)
    b = 1
    toks = np.random.default_rng(2).integers(0, p.cfg.vocab_size, (b, s + 1))
    jt, tt = jnp.asarray(toks, jnp.int32), torch.as_tensor(toks)
    jlp, jcache = jax.jit(p.jmodel.prefill, static_argnames="max_seq")(
        p.jparams, jt[:, :s], max_seq=s + 1)
    jla, _ = jax.jit(p.jmodel.decode_step)(p.jparams, jt[:, s:s + 1], jcache, jnp.int32(s))
    tlp, tcache = p.model.prefill(tt[:, :s], max_seq=s + 1)
    assert [{n: tuple(a.shape) for n, a in c["attn"].items()} for c in tcache] == \
        [{n: tuple(a.shape) for n, a in c["attn"].items()} for c in jcache]
    tla, _ = p.model.decode_step(tt[:, s:s + 1], tcache, s)
    scratch = p.model.init_cache(b, s + 1, dtype=torch.float32)
    for t in range(s + 1):
        tlb, scratch = p.model.decode_step(tt[:, t:t + 1], scratch, t)
    np.testing.assert_allclose(_np(tlp), np.asarray(jlp), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(_np(tla), np.asarray(jla), rtol=HANDOFF_TOL, atol=HANDOFF_TOL)
    np.testing.assert_allclose(_np(tla), _np(tlb), rtol=HANDOFF_TOL, atol=HANDOFF_TOL)


class TestAttentionCores:
    """``TestBlockwiseAttention``'s cases, the port against the JAX package."""

    @staticmethod
    def _qkv(b, s, h, kvh, hd, scale=1.0, seed=0):
        rng = np.random.default_rng(seed)
        return [rng.standard_normal(shape).astype(np.float32) * sc
                for shape, sc in [((b, s, h, hd), scale), ((b, s, kvh, hd), scale),
                                  ((b, s, kvh, hd), 1.0)]]

    @pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 8), (True, 24)])
    def test_blockwise_matches_jax(self, causal, window):
        q, k, v = self._qkv(2, 64, 4, 2, 16)
        want = JL.blockwise_attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                                      window=window, q_block=16, kv_block=16)
        got = L.blockwise_attention(*map(torch.as_tensor, (q, k, v)), causal=causal,
                                    window=window, q_block=16, kv_block=16)
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5, atol=1e-5)

    def test_blockwise_softcap_matches_jax(self):
        q, k, v = self._qkv(1, 32, 2, 2, 8, scale=5.0)
        want = JL.blockwise_attention(*map(jnp.asarray, (q, k, v)), causal=True,
                                      softcap=10.0, q_block=8, kv_block=8)
        got = L.blockwise_attention(*map(torch.as_tensor, (q, k, v)), causal=True,
                                    softcap=10.0, q_block=8, kv_block=8)
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("pos,window,softcap,rotating", [
        (5, 0, 0.0, False), (20, 8, 0.0, False), (11, 0, 30.0, False), (3, 0, 0.0, True),
        (29, 0, 0.0, True)])
    def test_decode_attention_matches_jax(self, pos, window, softcap, rotating):
        rng = np.random.default_rng(pos)
        q = rng.standard_normal((2, 1, 8, 16)).astype(np.float32)
        k = rng.standard_normal((2, 24, 2, 16)).astype(np.float32)
        v = rng.standard_normal((2, 24, 2, 16)).astype(np.float32)
        want = JL.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   jnp.int32(pos), window=window, softcap=softcap,
                                   rotating=rotating)
        got = L.decode_attention(*map(torch.as_tensor, (q, k, v)), pos, window=window,
                                 softcap=softcap, rotating=rotating)
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mlp_type", ["swiglu", "geglu", "squared_relu", "gelu"])
def test_mlp_apply_matches_jax(mlp_type):
    cfg = dataclasses.replace(get_config("mistral-nemo-12b").reduced(), mlp_type=mlp_type)
    jcfg = dataclasses.replace(jax_config("mistral-nemo-12b").reduced(), mlp_type=mlp_type)
    rng = np.random.default_rng(3)
    params = {name: rng.standard_normal(spec.shape).astype(np.float32) * 0.1
              for name, spec in L.mlp_specs(cfg).items()}
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    want = JL.mlp_apply({n: jnp.asarray(a) for n, a in params.items()}, jnp.asarray(x), jcfg)
    got = L.mlp_apply({n: torch.as_tensor(a) for n, a in params.items()}, torch.as_tensor(x),
                      cfg)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("norm_type", ["rmsnorm", "layernorm"])
def test_norm_and_rope_match_jax(norm_type):
    cfg = dataclasses.replace(get_config("mistral-nemo-12b").reduced(), norm_type=norm_type)
    rng = np.random.default_rng(4)
    p = {name: rng.standard_normal(spec.shape).astype(np.float32)
         for name, spec in L.norm_spec(cfg).items()}
    x = (rng.standard_normal((2, 3, cfg.d_model)) * 3 + 1).astype(np.float32)
    np.testing.assert_allclose(
        _np(L.apply_norm({n: torch.as_tensor(a) for n, a in p.items()}, torch.as_tensor(x))),
        np.asarray(JL.apply_norm({n: jnp.asarray(a) for n, a in p.items()}, jnp.asarray(x))),
        rtol=1e-5, atol=1e-5)
    for hd in (32, 33):          # an odd head_dim's tail passes through
        xr = rng.standard_normal((2, 7, 3, hd)).astype(np.float32)
        positions = np.arange(5, 12)
        np.testing.assert_allclose(
            _np(L.rope(torch.as_tensor(xr), torch.as_tensor(positions), 1e6)),
            np.asarray(JL.rope(jnp.asarray(xr), jnp.asarray(positions), 1e6)),
            rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ATTN_MLP)
def test_full_size_param_count_on_meta_matches_jax(arch):
    """The full configs, counted without allocation on ``meta``; bfloat16
    weights with float32 norms, as the JAX package's ``cast_specs`` keeps."""
    model = LM(get_config(arch), device="meta")
    want = jax_param_count(jax_build(jax_config(arch)).specs())
    assert param_count(model.specs()) == want
    assert sum(p.numel() for p in model.parameters()) == want
    assert all(p.device.type == "meta" for p in model.parameters())
    dtypes = {name.split(".")[-1]: p.dtype for name, p in model.named_parameters()}
    assert dtypes["scale"] == torch.float32 and dtypes["wq"] == torch.bfloat16
    assert tree_bytes(model.specs()) == sum(p.numel() * p.dtype.itemsize
                                            for p in model.parameters())


def test_mistral_nemo_full_size():
    """The slice's configuration: 40 layers at d_model 5,120, about 12.2 B
    parameters and 24.5 GB in bfloat16."""
    model = LM(get_config("mistral-nemo-12b"), device="meta")
    assert len(model.layers) == 40
    assert model.embed["head"].shape == (5120, 131072)
    assert model.layers[0]["attn"]["wk"].shape == (5120, 1024)
    assert 12.2e9 < param_count(model.specs()) < 12.3e9
    assert 24.4e9 < tree_bytes(model.specs()) < 24.6e9


def test_initialize_follows_the_init_rules():
    """"normal" × scale, "scaled_normal" by fan-in = shape[-2], ones and
    zeros, drawn from the generator (the same seed, the same tensors)."""
    specs = {"a": ParamSpec((400, 300), ("embed", "mlp")),
             "b": ParamSpec((2, 900, 100), ("layers", "embed", "mlp"), init="scaled_normal"),
             "c": ParamSpec((7,), ("embed",), torch.float32, "ones"),
             "d": ParamSpec((7,), ("embed",), torch.float32, "zeros")}
    out = initialize(specs, torch.Generator().manual_seed(0), "cpu")
    assert out["a"].dtype == torch.bfloat16
    assert abs(float(out["a"].float().std()) - 0.02) < 0.001
    assert abs(float(out["b"].float().std()) - 900 ** -0.5) < 0.001
    assert torch.equal(out["c"], torch.ones(7)) and torch.equal(out["d"], torch.zeros(7))
    again = initialize(specs, torch.Generator().manual_seed(0), "cpu")
    assert all(torch.equal(out[k], again[k]) for k in specs)


def test_converter_raises_on_a_missing_name_or_a_shape():
    cfg = get_config("mistral-nemo-12b").reduced()
    jparams = jax.tree.map(np.asarray, jax_initialize(
        jax_build(jax_config("mistral-nemo-12b").reduced()).specs(), jax.random.PRNGKey(0)))
    model = build_model(cfg, device="cpu")
    missing = {**jparams, "embed": {"embedding": jparams["embed"]["embedding"]}}
    with pytest.raises(KeyError, match="embed/head"):
        lm_params_from_jax(missing, model)
    wrong = {**jparams, "final_norm": {"scale": np.ones(cfg.d_model + 1, np.float32)}}
    with pytest.raises(ValueError, match="final_norm/scale"):
        lm_params_from_jax(wrong, model)
    extra = {**jparams, "projector": {"w": np.ones((4, cfg.d_model), np.float32)}}
    with pytest.raises(KeyError, match="projector/w"):
        lm_params_from_jax(extra, model)


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "phi3.5-moe-42b-a6.6b", "xlstm-125m",
                                  "zamba2-1.2b", "seamless-m4t-large-v2"])
def test_families_left_out_raise(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP.md §1 item 1"):
        build_model(get_config(arch).reduced(), device="cpu")


@pytest.mark.cuda
def test_cuda_decode_matches_jax(cuda):
    """The reduced nemo in float32 on the card against the JAX package."""
    p = _Pair("mistral-nemo-12b", device=cuda)
    want, got = _decode_both(p, 2, STEPS, device=cuda)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    jb, tb = p.batch(2, 32)
    with torch.no_grad():
        np.testing.assert_allclose(_np(p.model.forward_train(tb)),
                                   np.asarray(p.jmodel.forward_train(p.jparams, jb)),
                                   rtol=TOL, atol=TOL)
