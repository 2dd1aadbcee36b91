"""The port's LSTM predictor against the JAX package's.

Parameters cross over as numbers through ``repro_torch.convert``: both the
JAX package's ``init_lstm(PRNGKey(0))`` and the committed trained params
(``src/repro_torch/data/lstm_predictor.json``).  Tolerance 1e-5, the JAX
LSTM kernel test's (``tests/test_kernels.py:126-129``): a cell sums a few
float32 terms, in another order on each side.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cuda import cuda, jax_on_cpu  # noqa: F401  (fixtures)
from repro.core import predictor as jpred
from repro_torch import convert
from repro_torch.core import predictor
from repro_torch.kernels import ops
from repro_torch.core.s2c2 import general_allocation
from repro_torch.core.traces import controlled_traces, sample_traces, TraceConfig

pytestmark = pytest.mark.usefixtures("jax_on_cpu")   # the JAX reference on the CPU

torch.set_num_threads(1)   # small shapes; leave the cores to the timing-sensitive cluster tests

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(params=["init_lstm", "committed"])
def params_np(request):
    if request.param == "init_lstm":
        p = jpred.init_lstm(jpred.LSTMParams(), jax.random.PRNGKey(0))
        return {k: np.asarray(v) for k, v in p.items()}
    return convert.load_params_numpy()


def _port(params_np):
    return convert.params_from_jax(params_np, device="cpu")


def _jax(params_np):
    return {k: jnp.asarray(v) for k, v in params_np.items()}


def test_convert_copies_every_parameter(params_np):
    model = _port(params_np)
    assert model.cfg == predictor.LSTMParams(hidden=4, input_dim=1, output_dim=1)
    for name, value in params_np.items():
        np.testing.assert_array_equal(getattr(model, name).detach().numpy(), value)


def test_lstm_cell(params_np):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((6, 1)).astype(np.float32)
    h, c = (rng.standard_normal((6, 4)).astype(np.float32) for _ in range(2))
    gh, gc = predictor.lstm_cell(_port(params_np), torch.from_numpy(x),
                                 (torch.from_numpy(h), torch.from_numpy(c)))
    wh, wc = jpred.lstm_cell(_jax(params_np), jnp.asarray(x), (jnp.asarray(h), jnp.asarray(c)))
    np.testing.assert_allclose(gh.detach().numpy(), np.asarray(wh), **TOL)
    np.testing.assert_allclose(gc.detach().numpy(), np.asarray(wc), **TOL)


def test_lstm_apply(params_np):
    xs = np.random.default_rng(1).uniform(0.1, 1.0, (10, 5, 1)).astype(np.float32)
    got = predictor.lstm_apply(_port(params_np), torch.from_numpy(xs))
    want = jpred.lstm_apply(_jax(params_np), jnp.asarray(xs))
    assert got.shape == (10, 5, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def _weighted_loss_grads(apply, params, xs, w):
    """Gradients of sum(apply(params, xs) * w) with respect to every
    parameter of a port model, by torch autograd."""
    loss = (apply(params, xs) * w).sum()
    names = list(convert.load_params_numpy())
    return dict(zip(names, torch.autograd.grad(loss, [getattr(params, n) for n in names])))


def test_lstm_apply_gradients_match_jax(params_np):
    """Outside ``no_grad``: the port's ``lstm_apply`` differentiates like the
    JAX package's (``jax.grad`` through its ``lax.scan``)."""
    rng = np.random.default_rng(5)
    xs = rng.uniform(0.1, 1.0, (10, 5, 1)).astype(np.float32)
    w = rng.standard_normal((10, 5, 1)).astype(np.float32)
    got = _weighted_loss_grads(predictor.lstm_apply, _port(params_np), torch.from_numpy(xs),
                               torch.from_numpy(w))
    want = jax.grad(lambda p: jnp.sum(jpred.lstm_apply(p, jnp.asarray(xs)) * w))(
        _jax(params_np))
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(want[name]), **TOL)


@pytest.mark.parametrize("op", ["lstm_cell", "lstm_sequence"])
def test_kernel_forward_differentiates_the_plain_version(op):
    """The autograd path a CUDA call takes (``ops._PlainBackward``), run on
    the CPU with the plain version in the kernel's place: the forward runs
    it once without a graph, and the gradients equal autograd's through the
    plain version."""
    from repro_torch.kernels import lstm_cell as lstm_mod
    plain = getattr(lstm_mod, f"{op}_plain")
    rng = np.random.default_rng(6)
    shapes = ([(6, 1), (6, 4), (6, 4)] if op == "lstm_cell" else [(9, 6, 1)]) + \
        [(16, 1), (16, 4), (16,)] + ([] if op == "lstm_cell" else [(1, 4), (1,)])
    args = [torch.from_numpy(rng.standard_normal(s).astype(np.float32) * 0.5).requires_grad_()
            for s in shapes]
    calls = []

    def kernel(*a):
        assert not torch.is_grad_enabled() and not any(t.requires_grad for t in a)
        calls.append(1)
        return plain(*a)

    def flat(out):
        return out if isinstance(out, tuple) else (out,)

    got = flat(ops._PlainBackward.apply(kernel, plain, *args))
    want = flat(plain(*args))
    assert len(calls) == 1
    weights = [torch.from_numpy(rng.standard_normal(tuple(o.shape)).astype(np.float32))
               for o in want]
    g_got = torch.autograd.grad(sum((o * wt).sum() for o, wt in zip(got, weights)), args)
    g_want = torch.autograd.grad(sum((o * wt).sum() for o, wt in zip(want, weights)), args)
    for o, o_want in zip(got, want):
        np.testing.assert_array_equal(o.detach().numpy(), o_want.detach().numpy())
    for g, g_w in zip(g_got, g_want):
        np.testing.assert_allclose(g.numpy(), g_w.numpy(), rtol=1e-6, atol=1e-6)


def test_predict_next(params_np):
    hist = controlled_traces(12, 32, n_stragglers=2, seed=7).astype(np.float32)
    got = predictor.predict_next(_port(params_np), torch.from_numpy(hist))
    want = jpred.predict_next(_jax(params_np), jnp.asarray(hist))
    assert got.shape == (12,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# (T, B, I, H, O): a one-step window, the main path's 29- and 32-step
# windows over its 12 workers, and wider cells; the committed params fit
# only the paper's (I, H, O) = (1, 4, 1)
SEQUENCE_SHAPES = [(1, 1, 1, 4, 1), (29, 12, 1, 4, 1), (32, 12, 1, 4, 1), (10, 100, 3, 8, 2),
                   (7, 7, 2, 16, 1)]
SEQUENCE_CASES = [(kind, shape) for shape in SEQUENCE_SHAPES
                  for kind in ("init_lstm", "committed")
                  if kind == "init_lstm" or shape[2:] == (1, 4, 1)]


@pytest.mark.parametrize("kind,shape", SEQUENCE_CASES)
def test_lstm_sequence_matches_jax_lstm_apply(kind, shape):
    """``ops.lstm_sequence`` (the plain version, on the CPU) against the JAX
    package's ``lstm_apply``, the ``lax.scan`` it replaces."""
    steps, bsz, i, h, o = shape
    if kind == "init_lstm":
        cfg = jpred.LSTMParams(hidden=h, input_dim=i, output_dim=o)
        p = {k: np.asarray(v) for k, v in jpred.init_lstm(cfg, jax.random.PRNGKey(0)).items()}
    else:
        p = convert.load_params_numpy()
    model = _port(p)
    xs = np.random.default_rng(steps * 100 + bsz).uniform(0.1, 1.0, (steps, bsz, i))
    xs = xs.astype(np.float32)
    with torch.no_grad():
        got = ops.lstm_sequence(torch.from_numpy(xs), model.w_ih, model.w_hh, model.b,
                                model.w_out, model.b_out)
    want = jpred.lstm_apply(_jax(p), jnp.asarray(xs))
    assert got.shape == (steps, bsz, o)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_speed_predictor_sequence(params_np):
    """The online wrapper agrees step by step, past the 32-step window."""
    traces = sample_traces(TraceConfig(n_nodes=8, n_iters=40), seed=3)
    port = predictor.SpeedPredictor(8, _port(params_np), window=32, device="cpu")
    ref = jpred.SpeedPredictor(8, _jax(params_np), window=32)
    for it in range(40):
        np.testing.assert_allclose(port.predict(), ref.predict(), **TOL)
        port.observe(traces[it])
        ref.observe(traces[it])
    port.reset_worker(3)
    ref.reset_worker(3)
    np.testing.assert_allclose(port.predict(), ref.predict(), **TOL)


def test_speed_predictor_without_params_matches():
    port = predictor.SpeedPredictor(4, None, device="cpu")
    ref = jpred.SpeedPredictor(4, None)
    np.testing.assert_array_equal(port.predict(), ref.predict())
    port.observe([1.0, 0.5, 0.2, 0.9])
    ref.observe([1.0, 0.5, 0.2, 0.9])
    np.testing.assert_array_equal(port.predict(), ref.predict())


def test_mape_and_baselines_match():
    rng = np.random.default_rng(4)
    pred, true = rng.uniform(0.1, 1, 50), rng.uniform(0.1, 1, 50)
    np.testing.assert_allclose(
        float(predictor.mape(torch.from_numpy(pred), torch.from_numpy(true))),
        float(jpred.mape(jnp.asarray(pred), jnp.asarray(true))), rtol=1e-6)
    hist = rng.uniform(0.1, 1, (7, 5))
    np.testing.assert_array_equal(predictor.last_value_baseline(hist),
                                  jpred.last_value_baseline(hist))
    np.testing.assert_allclose(predictor.ema_baseline(hist), jpred.ema_baseline(hist),
                               rtol=1e-12)


def test_convert_rejects_bad_params():
    p = convert.load_params_numpy()
    with pytest.raises(KeyError, match="b_out"):
        convert.params_from_jax({k: v for k, v in p.items() if k != "b_out"}, device="cpu")
    bad = dict(p, b=np.zeros(15, np.float32))
    with pytest.raises(ValueError, match="shape"):
        convert.params_from_jax(bad, device="cpu")


def test_committed_params_steer_the_allocation():
    """The main path's setting: every prediction is positive and the two
    5x-slower stragglers get about half the chunks of the others."""
    traces = controlled_traces(12, 30, n_stragglers=2, seed=7)
    sp = predictor.SpeedPredictor(12, convert.load_params(device="cpu"), device="cpu")
    for it in range(30):
        speeds = sp.predict()
        assert (speeds > 0.2).all()
        sp.observe(traces[it])
    count = general_allocation(sp.predict(), 10, 20).count
    assert count[-2:].max() <= 10 and count[:-2].min() >= 16


@pytest.mark.cuda
def test_cuda_speed_predictor_matches_cpu(cuda):
    """The main path's predictor on the card: one sequence launch per
    prediction with history, the same speeds as on the CPU."""
    traces = controlled_traces(12, 30, n_stragglers=2, seed=7)
    on_card = predictor.SpeedPredictor(12, convert.load_params(device=cuda), device=cuda)
    on_cpu = predictor.SpeedPredictor(12, convert.load_params(device="cpu"), device="cpu")
    ops.reset_launch_counts()
    for it in range(30):
        got = on_card.predict()
        np.testing.assert_allclose(got, on_cpu.predict(), **TOL)
        on_card.observe(traces[it])
        on_cpu.observe(traces[it])
    assert ops.design_counts()["lstm_cell"] == {"sequence": 29, "cell": 0}
    ops.reset_launch_counts()


@pytest.mark.cuda
def test_cuda_lstm_apply_with_grad(cuda):
    """``lstm_apply`` on a CUDA predictor with grad enabled: one launch of the
    sequence kernel, and the plain version's outputs and parameter gradients."""
    rng = np.random.default_rng(7)
    xs = rng.uniform(0.1, 1.0, (32, 12, 1)).astype(np.float32)
    w = rng.standard_normal((32, 12, 1)).astype(np.float32)
    on_card = convert.load_params(device=cuda)
    on_cpu = convert.load_params(device="cpu")
    ops.reset_launch_counts()
    ys = predictor.lstm_apply(on_card, torch.from_numpy(xs).to(cuda))
    assert ops.design_counts()["lstm_cell"] == {"sequence": 1, "cell": 0}
    assert ys.requires_grad
    np.testing.assert_allclose(ys.detach().cpu().numpy(),
                               predictor.lstm_apply(on_cpu, torch.from_numpy(xs))
                               .detach().numpy(), **TOL)
    got = _weighted_loss_grads(predictor.lstm_apply, on_card, torch.from_numpy(xs).to(cuda),
                               torch.from_numpy(w).to(cuda))
    want = _weighted_loss_grads(predictor.lstm_apply, on_cpu, torch.from_numpy(xs),
                                torch.from_numpy(w))
    for name, g in got.items():
        np.testing.assert_allclose(g.cpu().numpy(), want[name].numpy(), **TOL)
    ops.reset_launch_counts()


# -- training -----------------------------------------------------------------

def _train_pairs(traces):
    xs = traces[:-1].astype(np.float32)[:, :, None]
    return xs, traces[1:].astype(np.float32)


def test_loss_fn_matches_jax(params_np):
    xs, tg = _train_pairs(sample_traces(TraceConfig(n_nodes=6, n_iters=60), seed=2))
    with torch.no_grad():
        got = predictor._loss_fn(_port(params_np), torch.from_numpy(xs), torch.from_numpy(tg))
    want = jpred._loss_fn(_jax(params_np), jnp.asarray(xs), jnp.asarray(tg))
    np.testing.assert_allclose(float(got), float(want), **TOL)


def test_adam_steps_match_jax(params_np):
    """20 steps of the port's ``_adam_step`` against the JAX package's, from
    the same parameters and zero moments: the losses, parameters and both
    moments after each step."""
    xs, tg = _train_pairs(sample_traces(TraceConfig(n_nodes=6, n_iters=150), seed=1))
    model = _port(params_np)
    state = tuple({n: torch.zeros_like(p)
                   for n, p in model.named_parameters()} for _ in range(2))
    ref = _jax(params_np)
    ref_state = (jax.tree.map(jnp.zeros_like, ref), jax.tree.map(jnp.zeros_like, ref))
    xs_t, tg_t = torch.from_numpy(xs), torch.from_numpy(tg)
    for step in range(20):
        model, state, loss = predictor._adam_step(model, state, xs_t, tg_t, step)
        ref, ref_state, ref_loss = jpred._adam_step(ref, ref_state, jnp.asarray(xs),
                                                    jnp.asarray(tg), step)
        np.testing.assert_allclose(float(loss), float(ref_loss), **TOL)
        for name, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(ref[name]), **TOL)
            for got, want in zip(state, ref_state):
                np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), **TOL)


def test_init_lstm_shapes_and_forget_bias():
    cfg = predictor.LSTMParams(hidden=8, input_dim=3, output_dim=2)
    model = predictor.init_lstm(cfg, torch.Generator().manual_seed(0), device="cpu")
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    want = {k: np.asarray(v).shape for k, v in
            jpred.init_lstm(jpred.LSTMParams(8, 3, 2), jax.random.PRNGKey(0)).items()}
    assert shapes == want == {"w_ih": (32, 3), "w_hh": (32, 8), "b": (32,), "w_out": (2, 8),
                              "b_out": (2,)}
    b = model.b.detach().numpy()
    np.testing.assert_array_equal(b[8:16], 1.0)
    np.testing.assert_array_equal(np.delete(b, np.s_[8:16]), 0.0)
    np.testing.assert_array_equal(model.b_out.detach().numpy(), 0.0)
    # the weights' scale is 1/sqrt(H), as in the reference's draws
    w = torch.cat([model.w_ih.flatten(), model.w_hh.flatten()]).detach().numpy()
    assert 0.5 / np.sqrt(8) < w.std() < 1.5 / np.sqrt(8)
    again = predictor.init_lstm(cfg, torch.Generator().manual_seed(0), device="cpu")
    for (n, p), (_, q) in zip(model.named_parameters(), again.named_parameters()):
        np.testing.assert_array_equal(p.detach().numpy(), q.detach().numpy())


def test_training_reduces_loss_and_tracks():
    """``tests/test_substrate.py::TestPredictor::test_training_reduces_loss_and_tracks``
    on the port's ``train_predictor``."""
    traces = sample_traces(TraceConfig(n_nodes=6, n_iters=150), seed=1)
    params, metrics = predictor.train_predictor(traces, epochs=120, device="cpu")
    assert metrics["test_mape"] < 0.5
    assert np.isfinite(metrics["final_train_loss"])
    assert isinstance(params, predictor.LSTMPredictor)
    # the last-value baseline is the reference's, on the same split
    _, jm = jpred.train_predictor(traces, epochs=0)
    np.testing.assert_allclose(metrics["last_value_test_mape"], jm["last_value_test_mape"],
                               rtol=1e-6)


def test_train_predictor_from_the_references_start_matches_jax(monkeypatch):
    """From the JAX package's initial parameters (``init_lstm(PRNGKey(0))``,
    converted), the port's ``train_predictor`` reaches the reference's
    metrics: only the random draws of the start differ between the two."""
    traces = sample_traces(TraceConfig(n_nodes=6, n_iters=150), seed=1)
    start = {k: np.asarray(v) for k, v in
             jpred.init_lstm(jpred.LSTMParams(), jax.random.PRNGKey(0)).items()}
    monkeypatch.setattr(predictor, "init_lstm",
                        lambda cfg, generator, device: convert.params_from_jax(start, device))
    _, got = predictor.train_predictor(traces, epochs=120, device="cpu")
    _, want = jpred.train_predictor(traces, epochs=120)
    assert got.keys() == want.keys()
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, **TOL)


def test_committed_start_is_the_references_init():
    """``data/lstm_predictor_init.json`` is the JAX package's
    ``init_lstm(LSTMParams(), PRNGKey(0))``, bit for bit."""
    want = jpred.init_lstm(jpred.LSTMParams(), jax.random.PRNGKey(0))
    got = convert.load_params_numpy(convert.INIT_PARAMS)
    assert got.keys() == want.keys()
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], np.asarray(value))


def test_train_predictor_from_init_matches_jax():
    """``train_predictor(init=...)`` from the committed start reaches the JAX
    package's metrics and parameters, and leaves ``init`` as it was."""
    traces = sample_traces(TraceConfig(n_nodes=6, n_iters=150), seed=1)
    start = convert.load_params(convert.INIT_PARAMS, device="cpu")
    before = {n: p.detach().clone() for n, p in start.named_parameters()}
    params, got = predictor.train_predictor(traces, epochs=30, device="cpu", init=start)
    jparams, want = jpred.train_predictor(traces, epochs=30)
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, **TOL)
    for name, value in jparams.items():
        np.testing.assert_allclose(getattr(params, name).detach().numpy(), np.asarray(value),
                                   **TOL)
    for name, p in start.named_parameters():
        assert torch.equal(p.detach(), before[name])


def test_trained_params_drive_the_speed_predictor():
    """A port-trained model is a drop-in for ``load_params()``: it crosses
    ``params_from_jax`` as numbers and predicts the same speeds."""
    traces = sample_traces(TraceConfig(n_nodes=6, n_iters=60), seed=4)
    params, _ = predictor.train_predictor(traces, epochs=5, device="cpu")
    again = convert.params_from_jax({n: p.detach().numpy() for n, p in params.named_parameters()},
                                    device="cpu")
    a = predictor.SpeedPredictor(6, params, device="cpu")
    b = predictor.SpeedPredictor(6, again, device="cpu")
    for it in range(10):
        np.testing.assert_array_equal(a.predict(), b.predict())
        a.observe(traces[it])
        b.observe(traces[it])


@pytest.mark.cuda
def test_cuda_training_matches_cpu(cuda):
    """``train_predictor`` on the card: one sequence launch under grad per
    epoch and one per evaluation, none of the per-step cell, and the CPU
    run's metrics."""
    traces = sample_traces(TraceConfig(n_nodes=6, n_iters=150), seed=1)
    ops.reset_launch_counts()
    params, metrics = predictor.train_predictor(traces, epochs=30, device=cuda)
    assert ops.design_counts()["lstm_cell"] == {"sequence": 32, "cell": 0}
    ops.reset_launch_counts()
    assert params.w_ih.device.type == "cuda"
    _, on_cpu = predictor.train_predictor(traces, epochs=30, device="cpu")
    for key, value in on_cpu.items():
        np.testing.assert_allclose(metrics[key], value, rtol=1e-3, atol=1e-5)
