"""The port's decoder LM held to the JAX package's, on the CPU.

For the reduced (float32) config of each of the nine decoder archs (five
``attn_mlp``, two MoE, the hybrid and the xLSTM),
the JAX package's parameters (``initialize(model.specs(), PRNGKey(0))``)
are carried into the port's ``LM`` by ``lm_params_from_jax``; then
``forward_train``, ``loss_fn`` and 16 ``decode_step`` calls must give the
JAX package's logits at rtol = atol = 1e-4 (float32 sums in another
order), and ``init_cache`` its shapes and dtypes.  ``prefill`` then
``decode_step`` mirrors ``tests/test_models.py::
test_prefill_matches_decode_handoff`` at its 2e-3, and decode against the
training forward mirrors ``test_decode_matches_forward`` on the port
alone; the attention cores mirror ``TestBlockwiseAttention``'s cases;
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
ARCHS = ATTN_MLP + ["mixtral-8x22b", "phi3.5-moe-42b-a6.6b", "zamba2-1.2b", "xlstm-125m"]
TOL = 1e-4          # float32 logits of a 4-layer model, sums in another order
HANDOFF_TOL = 2e-3  # tests/test_models.py::test_prefill_matches_decode_handoff
STEPS = 16


class _Pair:
    """One reduced arch on both stacks, with the same parameters and the
    same ``overrides`` of its config."""

    def __init__(self, arch: str, device="cpu", **overrides):
        self.cfg = dataclasses.replace(get_config(arch).reduced(), **overrides)
        self.jmodel = jax_build(dataclasses.replace(jax_config(arch).reduced(), **overrides))
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


@pytest.fixture(scope="module", params=ARCHS)
def pair(request, jax_on_cpu):  # noqa: F811  (the JAX side is made on the CPU too)
    return _Pair(request.param)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _layout(caches):
    """Each layer's cache entries as {kind: {name: (shape, dtype name)}}."""
    return [{kind: {name: (tuple(a.shape), str(a.dtype).split(".")[-1])
                    for name, a in state.items()}
             for kind, state in entry.items()} for entry in caches]


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
    max_seq passes the window (gemma's and mixtral's reduced window is 16);
    the shared attention block's own cache before each layer that runs it,
    and the recurrent states, in float32."""
    want = _layout(pair.jmodel.init_cache(2, max_seq))
    assert _layout(pair.model.init_cache(2, max_seq)) == want
    assert all(dtype == "float32" for entry in want for state in entry.values()
               for _, dtype in state.values())


@pytest.mark.parametrize("arch,s", [("mistral-nemo-12b", 12), ("gemma3-27b", 20),
                                    ("mixtral-8x22b", 12), ("zamba2-1.2b", 12),
                                    ("xlstm-125m", 12)])
def test_prefill_then_decode_matches_jax(arch, s):
    """prefill(S tokens) then decode_step(S): against JAX's same two calls,
    and against the port's decode from scratch.  Gemma's S = 20 passes its
    reduced window of 16, so its local layers hand over a rotated cache;
    mixtral's prefill runs the segmented MoE (capacity factor 8.0, as
    tests/test_models.py's decode test, so that the prefill drops no pair
    that one-token decode keeps); zamba2 hands over the shared block's
    caches and the Mamba-2 states, xlstm the mLSTM and sLSTM states."""
    p = _Pair(arch, moe_capacity_factor=8.0)
    b = 1
    toks = np.random.default_rng(2).integers(0, p.cfg.vocab_size, (b, s + 1))
    jt, tt = jnp.asarray(toks, jnp.int32), torch.as_tensor(toks)
    jlp, jcache = jax.jit(p.jmodel.prefill, static_argnames="max_seq")(
        p.jparams, jt[:, :s], max_seq=s + 1)
    jla, _ = jax.jit(p.jmodel.decode_step)(p.jparams, jt[:, s:s + 1], jcache, jnp.int32(s))
    tlp, tcache = p.model.prefill(tt[:, :s], max_seq=s + 1)
    assert _layout(tcache) == _layout(jcache)
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


@pytest.mark.parametrize("arch", ["gemma3-27b", "mixtral-8x22b", "zamba2-1.2b", "xlstm-125m"])
def test_decode_matches_forward(arch):
    """Token-by-token decode reproduces the training forward's logits, on
    the port alone: ``tests/test_models.py::test_decode_matches_forward``'s
    cases, with capacity drops disabled (factor 8) and its rel < 1e-4."""
    cfg = dataclasses.replace(get_config(arch).reduced(), moe_capacity_factor=8.0)
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    b, s = 1, 16
    tokens = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, (b, s)))
    with torch.no_grad():
        full = model.forward_train({"tokens": tokens})
    caches = model.init_cache(b, s)
    dec = torch.stack([model.decode_step(tokens[:, t:t + 1], caches, t)[0] for t in range(s)],
                      dim=1)
    rel = float((full - dec).abs().max() / (full.abs().max() + 1e-9))
    assert rel < 1e-4, rel


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "xlstm-125m"])
def test_bfloat16_decode_drifts_as_the_jax_package_does(arch):
    """bfloat16 against float32 of the same weights, 8 decode steps at
    B = 4: the JAX package's own bfloat16 decode drifts from its float32
    twin by more than 1e-2 of the largest logit (the recurrent states
    compound each step's rounding), and the port's by at most twice as
    much (measured: within 0.7-1.1 of JAX's on three seeds)."""
    cfg = get_config(arch).reduced()
    j32, j16 = (jax_build(dataclasses.replace(jax_config(arch).reduced(), dtype=d))
                for d in ("float32", "bfloat16"))
    p16 = jax.tree.map(lambda a, s: a.astype(s.dtype), jax_initialize(
        j32.specs(), jax.random.PRNGKey(0)), j16.specs())
    p32 = jax.tree.map(lambda a: a.astype(jnp.float32), p16)           # the same weights
    carried = jax.tree.map(np.asarray, p32)
    t16, t32 = (lm_params_from_jax(carried, build_model(dataclasses.replace(cfg, dtype=d),
                                                        device="cpu"))
                for d in ("bfloat16", "float32"))
    toks = np.random.default_rng(0).integers(1, cfg.vocab_size, (4, 8)).astype(np.int32)

    def drift(step16, step32, c16, c32, as_token, as_np):
        worst = 0.0
        for t in range(toks.shape[1]):
            l16, c16 = step16(as_token(toks[:, t:t + 1]), c16, t)
            l32, c32 = step32(as_token(toks[:, t:t + 1]), c32, t)
            l16, l32 = as_np(l16).astype(np.float64), as_np(l32)
            worst = max(worst, float(np.abs(l16 - l32).max() / np.abs(l32).max()))
        return worst

    s16, s32 = jax.jit(j16.decode_step), jax.jit(j32.decode_step)
    jax_drift = drift(lambda tk, c, t: s16(p16, tk, c, jnp.int32(t)),
                      lambda tk, c, t: s32(p32, tk, c, jnp.int32(t)),
                      j16.init_cache(4, 8), j32.init_cache(4, 8), jnp.asarray,
                      lambda a: np.asarray(a.astype(jnp.float32)))
    port_drift = drift(t16.decode_step, t32.decode_step, t16.init_cache(4, 8),
                       t32.init_cache(4, 8), lambda a: torch.as_tensor(a).long(),
                       lambda t: _np(t.float()))
    assert jax_drift > 1e-2
    assert port_drift <= 2 * jax_drift, (port_drift, jax_drift)


@pytest.mark.parametrize("arch", ARCHS)
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


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


# the card's free memory before a build, read on one H100 80GB HBM3 by
# chip_smoke.py's phase 10 (f) (0.08 GB still allocated)
CARD_FREE = 84.10e9


def test_phase_eight_full_sizes():
    """The slice's configurations on ``meta``: phi3.5-moe at 2.60 GB a layer
    in bfloat16 (16 experts of d_ff 6,400), so 28 of its 32 layers take
    73.3 GB; zamba2-1.2b's 38 Mamba-2 layers with 7 applications of one
    shared attention block, each with its own KV cache; xlstm-125m's 9
    mLSTM and 3 sLSTM layers; mistral-large-123b at 2.768 GB a layer and
    1.611 GB of embeddings, so that FAMILY_LAYERS' 26 layers leave
    FREE_AFTER_BUILD of the card's free memory and 27 do not."""
    phi = LM(get_config("phi3.5-moe-42b-a6.6b"), device="meta")
    layer = sum(p.numel() * p.dtype.itemsize for p in phi.layers[0].parameters())
    embed = sum(p.numel() * p.dtype.itemsize for p in phi.embed.parameters())
    assert phi.layers[0]["moe"]["wg"].shape == (16, 4096, 6400)
    assert 2.59e9 < layer < 2.61e9 and 0.52e9 < embed < 0.53e9
    assert 73.2e9 < 28 * layer + embed < 73.4e9 < 83.7e9 < 32 * layer + embed < 83.8e9
    zamba = LM(get_config("zamba2-1.2b"), device="meta")
    caches = zamba.init_cache(4, 16)
    assert [i for i, entry in enumerate(caches) if "shared" in entry] == [0, 6, 12, 18, 24, 30,
                                                                          36]
    assert all(set(entry) - {"shared"} == {"mamba"} for entry in caches)
    assert zamba.shared_attn["mlp"]["wg"].shape == (2048, 8192)
    xlstm = LM(get_config("xlstm-125m"), device="meta")
    assert [slot.kind for slot in xlstm.slots] == ["mlstm"] * 3 + ["slstm"] + ["mlstm"] * 3 + [
        "slstm"] + ["mlstm"] * 3 + ["slstm"]
    smoke = _chip_smoke()
    large = LM(get_config("mistral-large-123b"), device="meta")
    layer = sum(p.numel() * p.dtype.itemsize for p in large.layers[0].parameters())
    embed = sum(p.numel() * p.dtype.itemsize for p in large.embed.parameters())
    assert large.layers[0]["attn"]["wk"].shape == (12288, 1024)
    assert large.embed["head"].shape == (12288, 32768)
    assert 2.768e9 < layer < 2.769e9 and 1.610e9 < embed < 1.611e9
    depth = smoke.FAMILY_LAYERS["mistral-large-123b"]
    cut = dataclasses.replace(get_config("mistral-large-123b"), num_layers=depth)
    need = sum(p.numel() * p.dtype.itemsize for p in LM(cut, device="meta").parameters())
    assert 73.58e9 < need < 73.59e9 and need == pytest.approx(depth * layer + embed, abs=1e6)
    assert need + smoke.FREE_AFTER_BUILD <= CARD_FREE < need + layer + smoke.FREE_AFTER_BUILD


def test_converter_carries_the_shared_attention_block():
    """zamba2's top-level ``shared_attn/...`` leaves land in the port's one
    shared block, and a tree without them is refused by name."""
    p = _Pair("zamba2-1.2b")
    want = jax.tree.map(np.asarray, p.jparams["shared_attn"])
    got = {group: {name: _np(t) for name, t in params.items()}
           for group, params in p.model.shared_attn.items()}
    assert sorted(got) == ["attn", "mlp", "norm", "norm2"]
    for group in got:
        for name, value in got[group].items():
            np.testing.assert_array_equal(value, want[group][name])
    without = {k: v for k, v in jax.tree.map(np.asarray, p.jparams).items() if k != "shared_attn"}
    with pytest.raises(KeyError, match="shared_attn/"):
        lm_params_from_jax(without, build_model(p.cfg, device="cpu"))


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


@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2"])
def test_families_left_out_raise(arch):
    """No family is left out any more: ``build_model`` gives the
    encoder-decoder its own model (``tests/test_torch_encdec.py`` holds it
    to the JAX package), and ``LM`` refuses the config."""
    from repro_torch.models import EncDecLM

    model = build_model(get_config(arch).reduced(), device="cpu")
    assert isinstance(model, EncDecLM) and model.device == torch.device("cpu")
    with pytest.raises(ValueError, match="EncDecLM"):
        LM(get_config(arch).reduced(), device="cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mistral-nemo-12b", "phi3.5-moe-42b-a6.6b", "zamba2-1.2b",
                                  "xlstm-125m"])
def test_cuda_decode_matches_jax(cuda, arch):
    """The reduced config in float32 on the card against the JAX package."""
    p = _Pair(arch, device=cuda)
    want, got = _decode_both(p, 2, STEPS, device=cuda)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    jb, tb = p.batch(2, 32)
    with torch.no_grad():
        np.testing.assert_allclose(_np(p.model.forward_train(tb)),
                                   np.asarray(p.jmodel.forward_train(p.jparams, jb)),
                                   rtol=TOL, atol=TOL)
