"""The port's encoder-decoder (seamless-m4t-large-v2) held to the JAX
package's, on the CPU.

On the reduced (float32) config, and on the same config with grouped-query
attention (2 KV heads of 4), the JAX package's parameters
(``initialize(model.specs(), PRNGKey(0))``) are carried into the port's
``EncDecLM`` by ``lm_params_from_jax``; then ``forward_train`` and
``loss_fn`` (``tests/test_models.py::TestArchSmoke``'s encdec forward,
frames of (b, s // 2, frontend_dim)), ``prefill`` and several decode steps
after it must give the JAX package's logits at rtol = atol = 1e-4, and the
prefill → decode handoff at 2e-3; ``init_cache(2, 16, enc_len=8)`` has the
JAX package's shapes and dtypes and a ``decode_step`` from it keeps its
layout (``test_decode_step_shapes``).  The cross-attention functions are
held to the reference's, ``cross_attn_decode`` to the reference's inline
decode-step code.  On the port alone: decoding token by token after a
one-token prefill reproduces ``forward_train``; the converter refuses a
missing or misshapen stack leaf; the full-size count on ``meta`` is the JAX
package's.  ``chip_smoke.py``'s phase 9 runs end to end on the reduced
config on the CPU.  The JAX reference runs on the CPU (``jax_on_cpu``).
"""

import dataclasses
import importlib.util
from pathlib import Path

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
from repro_torch.kernels import coded_matvec as cmv
from repro_torch.models import EncDecLM, build_model
from repro_torch.models import layers as L
from repro_torch.models.params import param_count, tree_bytes

pytestmark = pytest.mark.usefixtures("jax_on_cpu")   # the JAX reference on the CPU

torch.set_num_threads(1)   # small shapes; leave the cores to the timing-sensitive cluster tests

ARCH = "seamless-m4t-large-v2"
TOL = 1e-4          # float32 logits of a 2 + 4 layer model, sums in another order
HANDOFF_TOL = 2e-3  # tests/test_models.py::test_prefill_matches_decode_handoff
STEPS = 6


class _Pair:
    """The reduced encoder-decoder on both stacks, with the same parameters
    and the same ``overrides`` of its config."""

    def __init__(self, device="cpu", **overrides):
        self.cfg = dataclasses.replace(get_config(ARCH).reduced(), **overrides)
        self.jmodel = jax_build(dataclasses.replace(jax_config(ARCH).reduced(), **overrides))
        self.jparams = jax_initialize(self.jmodel.specs(), jax.random.PRNGKey(0))
        self.model = lm_params_from_jax(jax.tree.map(np.asarray, self.jparams),
                                        build_model(self.cfg, device=device))
        self.device = device

    def inputs(self, b: int, s: int, seed: int = 0, n_frames=None):
        """tokens (b, s) and frames (b, s // 2, frontend_dim) for both:
        ((JAX's tokens, frames), (the port's))."""
        rng = np.random.default_rng(seed)
        toks = rng.integers(0, self.cfg.vocab_size, (b, s)).astype(np.int32)
        frames = rng.standard_normal((b, n_frames or s // 2, self.cfg.frontend_dim))
        frames = frames.astype(np.float32)
        return ((jnp.asarray(toks), jnp.asarray(frames)),
                (torch.as_tensor(toks, dtype=torch.long, device=self.device),
                 torch.as_tensor(frames, device=self.device)))


@pytest.fixture(scope="module", params=[{}, {"num_kv_heads": 2}], ids=["mha", "gqa"])
def pair(request, jax_on_cpu):  # noqa: F811  (the JAX side is made on the CPU too)
    return _Pair(**request.param)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _layout(caches):
    return [{kind: {name: (tuple(a.shape), str(a.dtype).split(".")[-1])
                    for name, a in state.items()}
             for kind, state in entry.items()} for entry in caches]


def test_build_model_gives_the_encoder_decoder(pair):
    model = pair.model
    assert isinstance(model, EncDecLM) and model.device == torch.device("cpu")
    assert len(model.enc) == pair.cfg.enc_layers == 2 and len(model.dec) == 4
    assert sorted(model.dec[0]) == ["cross_attn", "mlp", "norm1", "norm2", "norm_x",
                                    "self_attn"]
    assert sorted(model.enc[0]) == ["attn", "mlp", "norm1", "norm2"]
    assert model.frontend_proj.shape == (pair.cfg.frontend_dim, pair.cfg.d_model)
    assert model.cache_dtype() == torch.float32


def test_forward_train_and_loss_match_jax(pair):
    (jt, jf), (tt, tf) = pair.inputs(2, 32)
    jm = pair.jmodel
    jb = {"tokens": jt, "labels": jt, "frames": jf}
    want, want_loss = jax.jit(lambda p, b: (jm.forward_train(p, b), jm.loss_fn(p, b)))(
        pair.jparams, jb)
    tb = {"tokens": tt, "labels": tt, "frames": tf}
    with torch.no_grad():
        got = pair.model.forward_train(tb)
        loss = float(pair.model.loss_fn(tb))
    assert got.dtype == torch.float32 and got.shape == (2, 32, pair.cfg.padded_vocab)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(loss, float(want_loss), rtol=TOL)


def test_init_cache_and_decode_step_shapes(pair):
    """``init_cache(2, 16, enc_len=8)``'s shapes and dtypes are the JAX
    package's; a decode step from it gives finite logits of the padded
    vocabulary (the JAX package's at 1e-4) and keeps the cache layout."""
    want = _layout(pair.jmodel.init_cache(2, 16, enc_len=8))
    caches = pair.model.init_cache(2, 16, enc_len=8)
    assert _layout(caches) == want
    assert [sorted(entry) for entry in caches] == [["cross", "self"]] * pair.cfg.num_layers
    jlg, jcaches = jax.jit(pair.jmodel.decode_step)(
        pair.jparams, jnp.zeros((2, 1), jnp.int32), pair.jmodel.init_cache(2, 16, enc_len=8),
        jnp.int32(0))
    logits, caches2 = pair.model.decode_step(torch.zeros((2, 1), dtype=torch.long), caches, 0)
    assert logits.shape == (2, pair.cfg.padded_vocab) and torch.isfinite(logits).all()
    assert _layout(caches2) == _layout(jcaches) == want
    np.testing.assert_allclose(_np(logits), np.asarray(jlg), rtol=TOL, atol=TOL)


def test_prefill_and_handoff_match_jax(pair):
    """prefill(frames, S tokens): the JAX package's logits at 1e-4 and its
    cache layout; then decode_step(S): JAX's same two calls at 2e-3, and the
    port's prefill of S + 1 tokens at 2e-3."""
    s = 12
    (jt, jf), (tt, tf) = pair.inputs(1, s + 1, seed=2, n_frames=8)
    prefill = jax.jit(pair.jmodel.prefill, static_argnames="max_seq")
    jlp, jcache = prefill(pair.jparams, jf, jt[:, :s], max_seq=s + 1)
    jla, _ = jax.jit(pair.jmodel.decode_step)(pair.jparams, jt[:, s:], jcache, jnp.int32(s))
    tlp, tcache = pair.model.prefill(tf, tt[:, :s], max_seq=s + 1)
    assert _layout(tcache) == _layout(jcache)
    tla, _ = pair.model.decode_step(tt[:, s:], tcache, s)
    full, _ = pair.model.prefill(tf, tt)
    np.testing.assert_allclose(_np(tlp), np.asarray(jlp), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(_np(tla), np.asarray(jla), rtol=HANDOFF_TOL, atol=HANDOFF_TOL)
    np.testing.assert_allclose(_np(tla), _np(full), rtol=HANDOFF_TOL, atol=HANDOFF_TOL)


def _decode_after_prefill(pair, b, s, steps, device="cpu"):
    """Logits of ``steps`` decode steps after a prefill of ``s`` tokens and
    ``s`` frames, (JAX's, the port's)."""
    (jt, jf), (tt, tf) = pair.inputs(b, s + steps, seed=1, n_frames=s)
    _, jcache = jax.jit(pair.jmodel.prefill, static_argnames="max_seq")(
        pair.jparams, jf, jt[:, :s], max_seq=s + steps)
    _, tcache = pair.model.prefill(tf.to(device), tt[:, :s].to(device), max_seq=s + steps)
    step = jax.jit(pair.jmodel.decode_step)
    want, got = [], []
    for t in range(s, s + steps):
        lg, jcache = step(pair.jparams, jt[:, t:t + 1], jcache, jnp.int32(t))
        want.append(np.asarray(lg))
        lg, tcache = pair.model.decode_step(tt[:, t:t + 1].to(device), tcache, t)
        got.append(_np(lg))
    return np.stack(want), np.stack(got)


def test_decode_steps_after_prefill_match_jax(pair):
    want, got = _decode_after_prefill(pair, 2, 8, STEPS)
    assert got.shape == (STEPS, 2, pair.cfg.padded_vocab)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_decode_writes_the_self_cache_at_pos_and_never_the_cross_cache(pair):
    (_, _), (tt, tf) = pair.inputs(2, 5, seed=3, n_frames=6)
    _, caches = pair.model.prefill(tf, tt[:, :4], max_seq=8)
    before = [{kind: {n: t.clone() for n, t in entry[kind].items()} for kind in entry}
              for entry in caches]
    _, after = pair.model.decode_step(tt[:, 4:], caches, 4)
    assert after is caches
    for old, new in zip(before, caches):
        for name in ("k", "v"):
            assert torch.equal(old["cross"][name], new["cross"][name])
            assert torch.equal(old["self"][name][:, :4], new["self"][name][:, :4])
            assert not torch.equal(old["self"][name][:, 4], new["self"][name][:, 4])
            assert torch.equal(old["self"][name][:, 5:], new["self"][name][:, 5:])


def _cross_inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    params = {name: (rng.standard_normal(spec.shape) * 0.2).astype(np.float32)
              for name, spec in L.cross_attn_specs(cfg).items()}
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    enc_out = rng.standard_normal((2, 7, cfg.d_model)).astype(np.float32)
    return params, x, enc_out


@pytest.mark.parametrize("kv_heads", [4, 2], ids=["mha", "gqa"])
def test_cross_kv_and_cross_attn_apply_match_jax(kv_heads):
    cfg = dataclasses.replace(get_config(ARCH).reduced(), num_kv_heads=kv_heads)
    jcfg = dataclasses.replace(jax_config(ARCH).reduced(), num_kv_heads=kv_heads)
    params, x, enc_out = _cross_inputs(cfg, kv_heads)
    jp = {n: jnp.asarray(a) for n, a in params.items()}
    tp = {n: torch.as_tensor(a) for n, a in params.items()}
    jk, jv = JL.cross_kv(jp, jnp.asarray(enc_out), jcfg)
    tk, tv = L.cross_kv(tp, torch.as_tensor(enc_out), cfg)
    assert tk.shape == (2, 7, kv_heads, cfg.head_dim)
    np.testing.assert_allclose(_np(tk), np.asarray(jk), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(tv), np.asarray(jv), rtol=1e-5, atol=1e-5)
    want = JL.cross_attn_apply(jp, jnp.asarray(x), jk, jv, jcfg)
    got = L.cross_attn_apply(tp, torch.as_tensor(x), tk, tv, cfg)
    assert got.shape == (2, 5, cfg.d_model)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kv_heads", [4, 2], ids=["mha", "gqa"])
def test_cross_attn_decode_matches_the_reference_inline_step(kv_heads):
    """``src/repro/models/encdec.py``'s decode-step cross-attention, written
    out from its layers: q from ``wq``, ``decode_attention`` at
    ``pos = enc_len - 1`` with no window and no softcap (the config's
    softcap set, to show it is not passed), then ``wo``."""
    cfg = dataclasses.replace(get_config(ARCH).reduced(), num_kv_heads=kv_heads,
                              logit_softcap=5.0, sliding_window=3)
    params, x, enc_out = _cross_inputs(cfg, 10 + kv_heads)
    jp = {n: jnp.asarray(a) for n, a in params.items()}
    k, v = JL.cross_kv(jp, jnp.asarray(enc_out), cfg)
    hx = jnp.asarray(x[:, :1])
    q = (hx @ jp["wq"]).reshape(2, 1, cfg.num_heads, cfg.head_dim)
    att = JL.decode_attention(q, k, v, pos=jnp.int32(k.shape[1] - 1))
    want = att.reshape(2, 1, cfg.q_dim) @ jp["wo"]
    cache = {"k": torch.as_tensor(np.array(k)), "v": torch.as_tensor(np.array(v))}
    kept = {name: t.clone() for name, t in cache.items()}
    got = L.cross_attn_decode({n: torch.as_tensor(a) for n, a in params.items()},
                              torch.as_tensor(x[:, :1]), cfg, cache)
    assert got.shape == (2, 1, cfg.d_model)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert all(torch.equal(cache[name], kept[name]) for name in cache)


def test_decode_matches_forward():
    """A one-token prefill, then the rest decoded token by token,
    reproduces the training forward's logits at every position, on the port
    alone (``tests/test_models.py::test_decode_matches_forward``'s rel <
    1e-4)."""
    cfg = get_config(ARCH).reduced()
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    b, s = 2, 16
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, s)))
    frames = torch.as_tensor(rng.standard_normal((b, 8, cfg.frontend_dim)), dtype=torch.float32)
    with torch.no_grad():
        full = model.forward_train({"tokens": tokens, "frames": frames})
    first, caches = model.prefill(frames, tokens[:, :1], max_seq=s)
    dec = [first] + [model.decode_step(tokens[:, t:t + 1], caches, t)[0] for t in range(1, s)]
    dec = torch.stack(dec, dim=1)
    rel = float((full - dec).abs().max() / (full.abs().max() + 1e-9))
    assert rel < 1e-4, rel


@pytest.fixture(scope="module")
def carried(jax_on_cpu):  # noqa: F811
    cfg = get_config(ARCH).reduced()
    jparams = jax.tree.map(np.asarray, jax_initialize(jax_build(jax_config(ARCH).reduced())
                                                      .specs(), jax.random.PRNGKey(0)))
    return cfg, jparams


def _replace_leaf(tree, path, value):
    head, *rest = path
    if not rest:
        return {**{k: v for k, v in tree.items() if k != head},
                **({} if value is None else {head: value})}
    return {**tree, head: _replace_leaf(tree[head], rest, value)}


@pytest.mark.parametrize("path,shape,error,match", [
    (("enc", "attn", "wq"), None, KeyError, "enc/attn/wq"),
    (("dec", "cross_attn", "wk"), None, KeyError, "dec/cross_attn/wk"),
    (("dec", "mlp", "wi"), (3, 128, 256), ValueError, "dec/mlp/wi.*not 4 stacked"),
    (("enc", "norm1", "scale"), (2, 129), ValueError, "enc/norm1/scale"),
    (("frontend_proj",), (65, 128), ValueError, "frontend_proj"),
], ids=["missing-enc", "missing-dec-cross", "stack-count", "enc-shape", "frontend"])
def test_converter_refuses_a_missing_or_misshapen_leaf(carried, path, shape, error, match):
    cfg, jparams = carried
    bad = _replace_leaf(jparams, path, None if shape is None else np.ones(shape, np.float32))
    with pytest.raises(error, match=match):
        lm_params_from_jax(bad, build_model(cfg, device="cpu"))


def test_converter_carries_every_leaf(carried):
    cfg, jparams = carried
    model = lm_params_from_jax(jparams, build_model(cfg, device="cpu"))
    np.testing.assert_array_equal(_np(model.frontend_proj), jparams["frontend_proj"])
    np.testing.assert_array_equal(_np(model.enc[1]["attn"]["wv"]), jparams["enc"]["attn"]["wv"][1])
    np.testing.assert_array_equal(_np(model.dec[3]["cross_attn"]["wo"]),
                                  jparams["dec"]["cross_attn"]["wo"][3])
    np.testing.assert_array_equal(_np(model.dec_norm["bias"]), jparams["dec_norm"]["bias"])


def test_full_size_param_count_on_meta_matches_jax():
    """The whole model, counted without allocation: 1,633,406,976
    parameters, as the JAX package's ``param_count``; bfloat16 weights with
    float32 norms (about 3.27 GB)."""
    model = EncDecLM(get_config(ARCH), device="meta")
    want = jax_param_count(jax_build(jax_config(ARCH)).specs())
    assert param_count(model.specs()) == want == 1_633_406_976
    assert sum(p.numel() for p in model.parameters()) == want
    assert len(model.enc) == len(model.dec) == 24
    assert model.embed["head"].shape == (1024, 256256)
    assert model.dec[0]["mlp"]["wi"].shape == (1024, 8192)
    assert model.dec[0]["norm_x"]["bias"].dtype == torch.float32
    assert model.dec[0]["cross_attn"]["wq"].dtype == torch.bfloat16
    assert 3.26e9 < tree_bytes(model.specs()) < 3.28e9


def test_encdec_lm_refuses_a_decoder_config():
    with pytest.raises(ValueError, match="has no encoder"):
        EncDecLM(get_config("mistral-nemo-12b"), device="meta")


@pytest.mark.cuda
def test_cuda_decode_matches_jax(cuda):  # noqa: F811
    """The reduced config in float32 on the card against the JAX package."""
    p = _Pair(device=cuda)
    want, got = _decode_after_prefill(p, 2, 8, STEPS, device=cuda)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    (jt, jf), (tt, tf) = p.inputs(2, 32)
    with torch.no_grad():
        got = p.model.forward_train({"tokens": tt, "frames": tf})
    np.testing.assert_allclose(_np(got), np.asarray(p.jmodel.forward_train(
        p.jparams, {"tokens": jt, "frames": jf})), rtol=TOL, atol=TOL)


# -- chip_smoke.py phase 9 on the CPU ------------------------------------------

class _Event:
    """A stand-in for ``torch.cuda.Event`` on the CPU: every span 1 ms."""

    def __init__(self, *args, **kwargs):
        pass

    def record(self):
        pass

    def elapsed_time(self, other):
        return 1.0


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _compare(name, got, want, tol):
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=tol, atol=tol, err_msg=name)
    return float((got - want).abs().max())


def _in_turns(label, fns, order):
    """Each version once; every time 1 ms."""
    for name in order:
        fns[name]()
    return {name: {"device_ms": [1.0], "call_ms": [1.0]} for name in fns}


def test_chip_smoke_phase_nine_on_the_cpu(monkeypatch, capsys):
    smoke = _chip_smoke()
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *args: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *args: 0)
    monkeypatch.setattr(smoke, "device_kernel_ms", lambda fn, steps: None)
    monkeypatch.setattr(smoke, "expect", lambda *args: None)
    monkeypatch.setattr(cmv, "coded_matvec_multi", cmv.coded_matvec_plain)
    launches, rec = smoke.encdec_phase(torch.device("cpu"), _compare, _in_turns, reduced=True)
    assert launches == dict.fromkeys(launches, 0)      # the CPU launches no kernel
    assert "targets decoder LMs" in rec["serve_refusal"]
    assert rec["params"] == 1_192_448 and rec["enc_layers"] == 2 and rec["layers"] == 4
    smoke_run, long_run = rec["smoke"], rec["long"]
    assert (smoke_run["frames"], smoke_run["prompt"], len(smoke_run["step_ms"])) == (16, 8, 8)
    assert (long_run["frames"], long_run["prompt"], long_run["batch"]) == (256, 256, 4)
    assert 0 < smoke_run["step_bound_ms"] < long_run["step_bound_ms"]
    assert rec["f32_handoff_rel_err"] <= smoke.F32_HANDOFF_REL
    assert set(rec["bf16_encoder_block_rel_err"]) == {"attn_apply", "mlp_apply"}
    assert set(rec["bf16_block_rel_err"]) == {"attn_decode", "cross_attn_decode", "mlp_apply",
                                              "head_apply"}
    assert all(e <= smoke.BF16_REL for e in rec["bf16_block_rel_err"].values())
    assert rec["head_hold_err"] <= smoke.REL_ERR_LIMIT
    assert set(rec["head_kernel_vs_plain"]) == {"mds_encode", "coded_matvec", "mds_decode"}
    out = capsys.readouterr().out
    assert "phase 9 (c): float32, the whole model" in out
    assert out.count("(e): coded lm_head (6, 4)") == 1


def test_chip_smoke_encdec_step_bound():
    """One decode step's bound on the full config (``meta``): the decoder's
    24 layers and the head, 1.74 GB in bfloat16 (the encoder and
    ``frontend_proj`` not read), bytes-bound near 0.52 ms on the H100's
    3.35 TB/s at a short context; about 1.0 ms with 2,048 positions of self
    and of cross K/V a layer at B = 4."""
    smoke = _chip_smoke()
    model = build_model(get_config(ARCH), device="meta")
    short, by = smoke.decode_step_bound(model, 4, 12, enc_len=16)
    assert by == "bytes" and 0.51 < short < 0.53
    long, by = smoke.decode_step_bound(model, 4, 2056, enc_len=2048)
    assert by == "bytes" and 0.99 < long < 1.01
    no_cross, _ = smoke.decode_step_bound(model, 4, 2056, enc_len=0)
    assert 0.23 < long - no_cross < 0.25       # 24 layers x 2 x 4 x 2,048 x 1,024 x 2 bytes
