"""The port's training path held to the JAX package's, on the CPU.

* **Gradients, all ten archs.**  For each reduced (float32) config, the JAX
  package's parameters carried into the port (``lm_params_from_jax``), the
  port's ``torch.autograd.grad`` of ``loss_fn`` against ``jax.grad`` of the
  reference's, mapped leaf by leaf through ``repro_torch.convert.unstack``:
  each leaf within ``GRAD_TOL`` = 1e-4 of that leaf's largest gradient,
  the forward parity's 1e-4 (``tests/test_torch_models.py``); measured at
  most 8.1e-6 (zamba2's ``a_log``).  The blocks run under
  ``torch.utils.checkpoint`` (``cfg.remat``), as the JAX package's run
  under ``jax.checkpoint``.
* **The Mamba-2 scan's gradient stays finite** where a chunk's decay
  overflows ``exp`` and the reference's gradient is NaN.
* **Three SGD steps make the loss fall** for every arch, mirroring
  ``tests/test_models.py::TestArchSmoke::test_forward_loss_and_train_step``
  from its weights.
* **The sLSTM scan's backward** (autograd through ``ssm._slstm_scan``'s
  loop) in float32 against the same loop's in float64 at
  ``SLSTM_F32_TOL``, and against the JAX package's custom VJP in float32
  at 1e-5 of the largest value; and under ``torch.utils.checkpoint``,
  which must not change it.
* **CodedDPStep**, mirroring ``tests/test_runtime.py::TestCodedDP`` (the
  coded gradient equals the sum of the partitions' within 5e-3, a straggler
  is timed out, dead groups are tolerated), and against the JAX package's
  step on the same batch and weights: the same stragglers and responders,
  the decoded gradient within ``STEP_TOL`` of each leaf's largest value.
* **train** against the reference's ``train`` from the same weights,
  pipeline and traces with a group killed at step 2, with AdamW and with
  SGDM (linear in the gradient, so a wrongly scaled gradient shows): the
  same losses step by step, the same final parameters and optimizer state
  (``TRAIN_TOL``); then ``TestTrainLoopE2E``'s restart.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cuda import cuda, jax_on_cpu  # noqa: F401  (fixtures)
from repro.checkpoint.checkpoint import restore_checkpoint as jax_restore
from repro.configs import get_config as jax_config
from repro.core.traces import TraceConfig, sample_traces
from repro.data.pipeline import TokenPipeline as JaxPipeline
from repro.models import build_model as jax_build
from repro.models import ssm as JSSM
from repro.models.params import initialize as jax_initialize
from repro.optim.optimizer import make_optimizer as jax_optimizer
from repro.runtime.train_loop import CodedDPStep as JaxCodedDPStep
from repro.runtime.train_loop import TrainLoopConfig as JaxLoopConfig
from repro.runtime.train_loop import train as jax_train
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_jax, unstack
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.models import build_model
from repro_torch.models import ssm as SSM
from repro_torch.optim.optimizer import make_optimizer
from repro_torch.runtime.train_loop import CodedDPStep, TrainLoopConfig, train

pytestmark = pytest.mark.usefixtures("jax_on_cpu")   # the JAX reference on the CPU

torch.set_num_threads(1)   # small shapes; leave the cores to the timing-sensitive cluster tests

ARCHS = ["mistral-nemo-12b", "mistral-large-123b", "nemotron-4-340b", "gemma3-27b",
         "internvl2-26b", "mixtral-8x22b", "phi3.5-moe-42b-a6.6b", "zamba2-1.2b", "xlstm-125m",
         "seamless-m4t-large-v2"]
GRAD_TOL = 1e-4     # of each leaf's largest gradient: the forward parity's 1e-4
STEP_TOL = 3e-4     # a decoded gradient (float32 coded sums, decode weights up to 2.2): 3.0e-5 measured
SLSTM_F32_TOL = 1e-5  # float32 against float64 over 24 steps, of the largest value: 2.1e-7 measured
LOSS_TOL = 1e-4     # a step's mean loss after five steps: 1.8e-5 (AdamW), 3.5e-7 (SGDM) measured
# train against the reference, five steps at lr 1e-3: {(optimizer, on the
# card): (LOSS_TOL, the final parameters' tolerance, the optimizer state's),
# each of a leaf's largest value}.  SGDM is linear in the gradient: its
# state (momentum, a sum of decoded gradients) is held at STEP_TOL (2.7e-5
# measured on the CPU, 6.7e-5 on an H100) and its parameters at GRAD_TOL
# (6.7e-6, 1.0e-5), its losses parting by 3.5e-7 and 9.6e-8.  AdamW's
# update m / sqrt(v) is ±lr whatever a gradient's size, so float32
# rounding in a near-zero gradient can flip a step: its parameters part
# most where they started at zero (the sLSTM's b_gates, 3.1e-2 measured)
# and its state follows (3.8e-3).  On the card, whose sums round other
# than XLA's on the CPU, more steps flip: losses 2.9e-4, parameters 0.15
# and the momentum 0.78 of its leaf's largest value (an H100), where SGDM
# holds as on the CPU; the card's AdamW state limit, 2, still fails a
# gradient left unscaled by 1 / n_groups (the second moment off by 15 on the CPU)
TRAIN_LR = {"adamw": 1e-3, "sgdm": 1e-3}
TRAIN_TOL = {("sgdm", False): (LOSS_TOL, GRAD_TOL, STEP_TOL),
             ("sgdm", True): (LOSS_TOL, GRAD_TOL, STEP_TOL),
             ("adamw", False): (LOSS_TOL, 0.1, 2e-2),
             ("adamw", True): (1e-3, 0.5, 2.0)}


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _batch(cfg, b: int, s: int, seed: int = 0) -> dict:
    """A numpy batch as the pipeline gives it (tokens, labels, and frames or
    image embeds)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    out = {"tokens": toks, "labels": toks}
    if cfg.frontend == "vit_stub":
        out["image_embeds"] = rng.standard_normal(
            (b, cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32)
    if cfg.is_encdec:
        out["frames"] = rng.standard_normal((b, s // 2, cfg.frontend_dim)).astype(np.float32)
    return out


def _on(batch: dict, device) -> dict:
    return {k: torch.as_tensor(v, device=device).long() if k in ("tokens", "labels")
            else torch.as_tensor(v, device=device) for k, v in batch.items()}


def _pair(arch: str, device="cpu", **overrides):
    """(the port's model, the JAX model, its parameters) with the same weights."""
    cfg = dataclasses.replace(get_config(arch).reduced(), **overrides)
    jmodel = jax_build(dataclasses.replace(jax_config(arch).reduced(), **overrides))
    jparams = jax_initialize(jmodel.specs(), jax.random.PRNGKey(0))
    model = lm_params_from_jax(jax.tree.map(np.asarray, jparams),
                               build_model(cfg, device=device))
    return model, jmodel, jparams


def _leaf_errors(got: dict, want: dict) -> dict:
    """{name: max |got − want| / max |want|}."""
    return {name: float(np.abs(_np(g) - want[name]).max()
                        / max(float(np.abs(want[name]).max()), 1e-30))
            for name, g in got.items()}


def _grads_match(arch: str, device="cpu"):
    model, jmodel, jparams = _pair(arch, device)
    batch = _batch(model.cfg, 2, 32)
    jgrads = jax.jit(jax.grad(jmodel.loss_fn))(jparams, jax.tree.map(jnp.asarray, batch))
    want = unstack(jax.tree.map(np.asarray, jgrads), model)
    names = [n for n, _ in model.named_parameters()]
    loss = model.loss_fn(_on(batch, device))
    grads = torch.autograd.grad(loss, list(model.parameters()))
    assert model.cfg.remat
    errs = _leaf_errors(dict(zip(names, grads)), want)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_TOL, f"{arch}: {worst} off by {errs[worst]:.2e}"


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_jax(arch):
    _grads_match(arch)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_jax_on_the_card(cuda, arch):  # noqa: F811
    _grads_match(arch, cuda)


def test_ssd_gradient_stays_finite_where_the_reference_gives_nan():
    """A Mamba-2 chunk whose cumulative decay passes 88 (dt_bias 10 in the
    first slot, layers 0 and 2: dt ≈ 10 a position over 32): the JAX package's
    ``where(mask, exp(li), 0)`` overflows above the diagonal and its
    gradient is NaN (0 · inf) from that layer back; the port masks before
    the exp, so its gradients stay finite, the loss is the same, and every
    leaf the reference gets finite matches at ``GRAD_TOL``.  (zamba2-1.2b's
    repeated tokens reach this regime at full width.)"""
    model, jmodel, jparams = _pair("zamba2-1.2b")
    mamba = jparams["slots"]["s0"]["mamba"]
    mamba["dt_bias"] = jnp.full_like(mamba["dt_bias"], 10.0)
    model = lm_params_from_jax(jax.tree.map(np.asarray, jparams), model)
    batch = _batch(model.cfg, 2, 32)
    jb = jax.tree.map(jnp.asarray, batch)
    jgrads = jax.jit(jax.grad(jmodel.loss_fn))(jparams, jb)
    want = unstack(jax.tree.map(np.asarray, jgrads), model)
    nan = {n for n, w in want.items() if not np.isfinite(w).all()}
    assert "layers.2.mamba.in_proj" in nan and "layers.3.mamba.in_proj" not in nan
    names = [n for n, _ in model.named_parameters()]
    loss = model.loss_fn(_on(batch, "cpu"))
    grads = dict(zip(names, torch.autograd.grad(loss, list(model.parameters()))))
    assert all(torch.isfinite(g).all() for g in grads.values())
    assert abs(loss.item() - float(jmodel.loss_fn(jparams, jb))) <= 1e-4 * loss.item()
    errs = _leaf_errors({n: g for n, g in grads.items() if n not in nan}, want)
    assert max(errs.values()) <= GRAD_TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_three_sgd_steps_reduce_the_loss(arch):
    """TestArchSmoke::test_forward_loss_and_train_step on the port, from
    that test's weights (the JAX package's ``PRNGKey(0)``, carried over): a
    finite forward of the right shape, then three SGD steps (lr 0.5).  From
    the port's own seed-0 draw zamba2 reaches NaN at the third step, and so
    does the JAX package from those same weights: lr 0.5 is the test's."""
    model = _pair(arch)[0]
    cfg = model.cfg
    batch = _on(_batch(cfg, 2, 32), "cpu")
    with torch.no_grad():
        logits = model.forward_train(batch)
    assert logits.shape[0] == 2 and logits.shape[-1] == cfg.padded_vocab
    assert torch.isfinite(logits).all()
    params = list(model.parameters())
    l0 = model.loss_fn(batch).item()
    for _ in range(3):
        grads = torch.autograd.grad(model.loss_fn(batch), params)
        with torch.no_grad():
            for p, g in zip(params, grads):
                p.sub_(0.5 * g.to(p.dtype))
    l1 = model.loss_fn(batch).item()
    assert np.isfinite(l1) and l1 < l0, f"loss did not improve: {l0} -> {l1}"


# -- the sLSTM scan's backward ----------------------------------------------------

def _slstm_inputs(dtype, device="cpu", b=2, s=24, nh=4, hd=8, seed=0):
    gen = torch.Generator().manual_seed(seed)
    r = (torch.randn(nh, hd, 4 * hd, generator=gen) / hd ** 0.5).to(device, dtype)
    bias = (torch.randn(4 * nh * hd, generator=gen) * 0.5).to(device, dtype)
    xw = torch.randn(b, s, nh, 4 * hd, generator=gen).to(device, dtype)
    g_hs = torch.randn(b, s, nh, hd, generator=gen).to(device, dtype)
    return r, bias, xw, g_hs


def _plain_scan(r, bias, xw):
    return SSM._slstm_scan(r, bias.reshape(r.shape[0], -1), xw)[0]


def _scan_grads(r, bias, xw, g_hs):
    leaves = [t.detach().requires_grad_() for t in (r, bias, xw)]
    hs = _plain_scan(*leaves)
    return hs, torch.autograd.grad(hs, leaves, g_hs)


def _slstm_against_float64(device):
    """The float32 scan's gradients (dr, db, dxw) on ``device`` against
    autograd of the same loop in float64 on the CPU."""
    _, got = _scan_grads(*_slstm_inputs(torch.float32, device))
    _, want = _scan_grads(*_slstm_inputs(torch.float64))
    for name, g, w in zip(("dr", "db", "dxw"), got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        err = float((g.double().cpu() - w).abs().max() / w.abs().max())
        assert err <= SLSTM_F32_TOL, f"{name} off by {err:.2e}"


def test_slstm_scan_backward_matches_autograd_of_the_loop():
    _slstm_against_float64("cpu")


@pytest.mark.cuda
def test_slstm_scan_backward_matches_autograd_of_the_loop_on_the_card(cuda):  # noqa: F811
    _slstm_against_float64(cuda)


def test_slstm_scan_backward_matches_the_jax_custom_vjp():
    """Autograd through the port's loop against the JAX package's custom
    VJP (a reverse scan that replays the carries), in float32."""
    r, bias, xw, g_hs = _slstm_inputs(torch.float32)
    nh = r.shape[0]
    b, s = xw.shape[:2]
    _, got = _scan_grads(r, bias, xw, g_hs)
    _, vjp = jax.vjp(lambda r_, b_, x_: JSSM._slstm_scan_cv(r_, b_, x_, nh), jnp.asarray(r),
                     jnp.asarray(bias), jnp.asarray(xw.reshape(b, s, -1)))
    want = vjp(jnp.asarray(g_hs))
    for name, g, w in zip(("dr", "db", "dxw"), got, want):
        w = np.asarray(w).reshape(g.shape)
        assert np.abs(_np(g) - w).max() <= 1e-5 * np.abs(w).max(), name


def test_slstm_apply_under_checkpoint_keeps_its_gradients():
    """Inside ``torch.utils.checkpoint`` (non-reentrant, as ``cfg.remat``
    runs every block) ``slstm_apply``'s gradients are the same, bit for bit,
    and its output is the prefill's."""
    cfg = get_config("xlstm-125m").reduced()
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    p = model.layers[1]["slstm"]
    x = torch.randn(2, 16, cfg.d_model, generator=torch.Generator().manual_seed(1))
    x.requires_grad_()
    leaves = [x] + list(p.values())
    direct = torch.autograd.grad(SSM.slstm_apply(p, x, cfg).square().sum(), leaves)
    out = torch.utils.checkpoint.checkpoint(SSM.slstm_apply, p, x, cfg, use_reentrant=False)
    again = torch.autograd.grad(out.square().sum(), leaves)
    assert all(torch.equal(a, b) for a, b in zip(direct, again))
    with torch.no_grad():
        plain, state = SSM.slstm_apply(p, x, cfg, return_state=True)
    assert torch.equal(plain, out) and sorted(state) == ["c", "h", "m", "n"]


# -- the coded data-parallel step -----------------------------------------------

def _coded_setup(device="cpu"):
    cfg = get_config("xlstm-125m").reduced()
    model = build_model(cfg, device=device, generator=torch.Generator(device=device).manual_seed(0))
    batch = TokenPipeline(vocab_size=cfg.vocab_size, batch=12, seq_len=16, seed=0).next_batch()
    return model, batch


def test_coded_gradient_equals_plain():
    """TestCodedDP::test_coded_gradient_equals_plain: the decoded gradient
    is Σ over partitions of each partition's gradient, within 5e-3."""
    model, batch = _coded_setup()
    coded = CodedDPStep(model, n_groups=6, s=2)
    grad, loss, info = coded.step(batch, np.ones(6))
    want = None
    for part in coded.partition_batch(batch, np.ones(6)):
        if part["tokens"].shape[0] == 0:
            continue
        g = torch.autograd.grad(model.loss_fn(_on(part, "cpu")), list(model.parameters()))
        want = [x.float() for x in g] if want is None else [a + x.float() for a, x in zip(want, g)]
    err = max(float((grad[n] - w).abs().max()) for (n, _), w in zip(model.named_parameters(), want))
    scale = max(float(w.abs().max()) for w in want)
    assert err / (scale + 1e-9) < 5e-3
    assert np.isfinite(loss) and info["responders"] >= 4


def test_straggler_does_not_break_decode():
    model, batch = _coded_setup()
    coded = CodedDPStep(model, n_groups=6, s=2)
    grad, loss, info = coded.step(batch, np.array([1, 1, 1, 1, 0.05, 1.0]))
    assert grad is not None and np.isfinite(loss)
    assert 4 in info["straggled"]
    assert all(torch.isfinite(g).all() for g in grad.values())


def test_dead_group_tolerated():
    model, batch = _coded_setup()
    coded = CodedDPStep(model, n_groups=6, s=2)
    grad, loss, info = coded.step(batch, np.ones(6), dead_groups={1, 4})
    assert grad is not None and np.isfinite(loss)
    assert info["responders"] == 4 and not info["straggled"]


def _step_against_jax(device="cpu"):
    """Two coded steps on the same batches and weights in both packages: a
    straggler in the first, two dead groups in the second (the predictor
    then forecasts the first step's speeds)."""
    model, jmodel, jparams = _pair("xlstm-125m", device)
    cfg = model.cfg
    ours = CodedDPStep(model, n_groups=6, s=2)
    ref = JaxCodedDPStep(jmodel.loss_fn, n_groups=6, s=2)
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, batch=12, seq_len=16, seed=0)
    for speeds, dead in ((np.array([1, 1, 1, 1, 0.05, 1.0]), None),
                         (np.array([1, 0.5, 1, 1, 1, 2.0]), {0, 3})):
        batch = pipe.next_batch()
        jgrad, jloss, jinfo = ref.step(jparams, batch, speeds, dead_groups=dead)
        grad, loss, info = ours.step(batch, speeds, dead_groups=dead)
        assert info["straggled"] == jinfo["straggled"]
        assert info["responders"] == jinfo["responders"]
        assert info["makespan"] == jinfo["makespan"]
        assert abs(loss - jloss) <= 1e-5 * abs(jloss)
        errs = _leaf_errors(grad, unstack(jax.tree.map(np.asarray, jgrad), model))
        worst = max(errs, key=errs.get)
        assert errs[worst] <= STEP_TOL, f"{worst} off by {errs[worst]:.2e}"
        assert all(g.dtype == torch.float32 and g.device.type == torch.device(device).type
                   for g in grad.values())


def test_coded_step_matches_jax():
    _step_against_jax()


@pytest.mark.cuda
def test_coded_step_matches_jax_on_the_card(cuda):  # noqa: F811
    _step_against_jax(cuda)


# -- the training loop ------------------------------------------------------------

def _train_both(tmp_path, opt_name: str, device="cpu"):
    """The port's ``train`` and the reference's, five steps of ``opt_name``
    from the same weights, pipeline and traces, group 1 killed at step 2:
    the losses step by step, then the final parameters and the optimizer
    state, each read back from its package's last checkpoint (the state's
    names are the same in both; ``repro.checkpoint`` reads the port's).
    Prints the three errors (``pytest -rP`` shows them)."""
    model, jmodel, jparams = _pair("xlstm-125m", device)
    cfg = model.cfg
    traces = sample_traces(TraceConfig(n_nodes=4, n_iters=40), seed=0)
    lr = TRAIN_LR[opt_name]
    jopt = jax_optimizer(opt_name, lr=lr)

    def loop(cls, sub):
        return cls(total_steps=5, ckpt_every=3, ckpt_dir=str(tmp_path / sub), n_groups=4,
                   stragglers_tolerated=1, log_every=100)

    want = jax_train(jmodel, jparams, jopt,
                     JaxPipeline(vocab_size=cfg.vocab_size, batch=8, seq_len=16, seed=0),
                     loop(JaxLoopConfig, "jax"), speed_traces=traces, fail_at={2: 1})
    got = train(model, make_optimizer(opt_name, lr=lr),
                TokenPipeline(vocab_size=cfg.vocab_size, batch=8, seq_len=16, seed=0),
                loop(TrainLoopConfig, "port"), speed_traces=traces, fail_at={2: 1})
    _, jfinal, jstate, _ = jax_restore(str(tmp_path / "jax"), jparams, jopt.init(jparams))
    _, _, state, _ = jax_restore(str(tmp_path / "port"), {}, jopt.init(jparams))
    loss_err = float(np.max(np.abs(np.subtract(got["losses"], want["losses"]))
                            / np.abs(want["losses"])))
    param_errs = _leaf_errors(dict(model.named_parameters()),
                              unstack(jax.tree.map(np.asarray, jfinal), model))
    state_errs = {jax.tree_util.keystr(path): float(np.abs(np.asarray(a) - np.asarray(b)).max()
                                                    / max(float(np.abs(np.asarray(b)).max()),
                                                          1e-30))
                  for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(state)[0],
                                          jax.tree.leaves(jstate))}
    print(f"train against the reference, {opt_name} on {device}: losses {loss_err:.3e}, "
          f"parameters {max(param_errs.values()):.3e}, state {max(state_errs.values()):.3e}")
    on_card = torch.device(device).type != "cpu"
    loss_tol, param_tol, state_tol = TRAIN_TOL[opt_name, on_card]
    assert len(got["losses"]) == len(want["losses"]) == 5
    assert loss_err <= loss_tol, f"losses off by {loss_err:.2e}"
    np.testing.assert_allclose(got["makespans"], want["makespans"], rtol=1e-12)
    assert got["losses"][-1] < got["losses"][0]
    worst = max(param_errs, key=param_errs.get)
    assert param_errs[worst] <= param_tol, f"{worst} off by {param_errs[worst]:.2e}"
    worst = max(state_errs, key=state_errs.get)
    assert state_errs[worst] <= state_tol, f"state {worst} off by {state_errs[worst]:.2e}"


@pytest.mark.parametrize("opt_name", ["adamw", "sgdm"])
def test_train_matches_the_reference_loop(tmp_path, opt_name):
    _train_both(tmp_path, opt_name)


@pytest.mark.cuda
@pytest.mark.parametrize("opt_name", ["adamw", "sgdm"])
def test_train_matches_the_reference_loop_on_the_card(tmp_path, cuda, opt_name):  # noqa: F811
    _train_both(tmp_path, opt_name, cuda)


def test_checkpoint_restart_resumes(tmp_path, monkeypatch):
    """TestTrainLoopE2E::test_checkpoint_restart_resumes: after 6 steps a
    restart with 10 resumes from step 5's checkpoint, the data cursor
    intact, and runs only the steps left."""
    cfg = get_config("xlstm-125m").reduced()
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    opt = make_optimizer("adamw", lr=1e-3)
    traces = sample_traces(TraceConfig(n_nodes=4, n_iters=40), seed=0)

    def mk_pipeline():
        return TokenPipeline(vocab_size=cfg.vocab_size, batch=8, seq_len=16, seed=0)

    loop_cfg = TrainLoopConfig(total_steps=6, ckpt_every=3, ckpt_dir=str(tmp_path), n_groups=4,
                               stragglers_tolerated=1, log_every=100)
    m1 = train(model, opt, mk_pipeline(), loop_cfg, speed_traces=traces)
    after = {n: p.detach().clone() for n, p in model.named_parameters()}
    fresh = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    loop_cfg2 = dataclasses.replace(loop_cfg, total_steps=10)
    pipeline = mk_pipeline()
    restored = {}
    real_step = CodedDPStep.step

    def first_step(self, batch, *args, **kwargs):
        if not restored:      # the weights the restart starts from: step 5's
            restored.update({n: p.detach().clone() for n, p in self.model.named_parameters()})
        return real_step(self, batch, *args, **kwargs)

    monkeypatch.setattr(CodedDPStep, "step", first_step)
    m2 = train(fresh, opt, pipeline, loop_cfg2, speed_traces=traces)
    assert len(m1["losses"]) == 6 and len(m2["losses"]) == 4   # resumed, not from scratch
    assert np.isfinite(m2["final_loss"])
    assert all(torch.equal(restored[n], after[n]) for n in after)
    assert pipeline.cursor == 10 * 8
