"""LSTM speed predictor (§3.2, §6.1 of the paper) in PyTorch.

The paper's architecture: a single-layer LSTM, 1-dim input (the previous
iteration's speed), 4-dim hidden state, and a 1-dim linear output head
predicting the next iteration's speed.  The model is shared across nodes
(speeds are batched over nodes) and trained with Adam on MSE.  Metrics:
MAPE (the paper reports 16.7 % on test, ~5 % better than the last-value
baseline).

A prediction runs the whole window, every LSTM step and the output head
``h @ w_outᵀ + b_out``, through ``ops.lstm_sequence``: one launch of the
sequence kernel on a card (where the JAX package runs one ``lax.scan``),
its plain version on the CPU.  :func:`lstm_cell`, one step, goes through
``ops.lstm_cell``.  Both run with grad enabled too: on a card the kernel
computes the forward and the backward differentiates the plain version.

Training (:func:`train_predictor`) is the JAX package's: the same 80:20
split, teacher-forced pairs, Adam written out term by term
(:func:`_adam_step`) and metrics.  On a card each epoch is one launch of
the sequence kernel under grad, and the two evaluation passes one each.
``jax.random`` cannot be reproduced, so :func:`init_lstm` draws the same
distributions from a ``torch.Generator``; the JAX package's start and its
trained parameters cross over through :mod:`repro_torch.convert`
(``train_predictor(..., init=load_params(INIT_PARAMS))`` reproduces its
training).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch._device import resolve_device
from repro_torch.core.traces import train_test_split
from repro_torch.kernels import ops

__all__ = [
    "LSTMParams", "LSTMPredictor", "init_lstm", "lstm_cell", "lstm_apply",
    "predict_next", "train_predictor", "mape", "last_value_baseline",
    "ema_baseline", "SpeedPredictor",
]


@dataclasses.dataclass(frozen=True)
class LSTMParams:
    hidden: int = 4      # paper: 4-dim hidden state (tuned hyperparameter)
    input_dim: int = 1
    output_dim: int = 1


class LSTMPredictor(nn.Module):
    """The predictor's parameters, named as in the JAX package's dict:
    ``w_ih (4H, I)``, ``w_hh (4H, H)``, ``b (4H,)`` packed in gate order
    i, f, g, o, and the head ``w_out (O, H)``, ``b_out (O,)``.

    Starts at zero; :func:`repro_torch.convert.params_from_jax` fills it.
    """

    def __init__(self, cfg: LSTMParams = LSTMParams(),
                 device: str | torch.device = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        h, i, o = cfg.hidden, cfg.input_dim, cfg.output_dim
        self.cfg = cfg
        self.w_ih = nn.Parameter(torch.zeros(4 * h, i, device=dev))
        self.w_hh = nn.Parameter(torch.zeros(4 * h, h, device=dev))
        self.b = nn.Parameter(torch.zeros(4 * h, device=dev))
        self.w_out = nn.Parameter(torch.zeros(o, h, device=dev))
        self.b_out = nn.Parameter(torch.zeros(o, device=dev))

    def forward(self, history: torch.Tensor) -> torch.Tensor:
        return predict_next(self, history)


def init_lstm(cfg: LSTMParams, generator: torch.Generator,
              device: str | torch.device = "cuda") -> LSTMPredictor:
    """Fresh parameters: weights normal with scale 1/sqrt(H), drawn from
    ``generator`` on its own device and then moved to ``device``; biases
    zero, except the forget gate's, which is 1."""
    h, i = cfg.hidden, cfg.input_dim
    scale = 1.0 / np.sqrt(h)
    model = LSTMPredictor(cfg, device=device)

    def normal(*shape):
        return torch.randn(*shape, generator=generator, device=generator.device) * scale

    with torch.no_grad():
        model.w_ih.copy_(normal(4 * h, i))
        model.w_hh.copy_(normal(4 * h, h))
        model.b[h:2 * h] = 1.0                   # forget-gate bias 1
        model.w_out.copy_(normal(cfg.output_dim, h))
    return model


def lstm_cell(params: LSTMPredictor, x: torch.Tensor,
              state: Tuple[torch.Tensor, torch.Tensor]):
    """One LSTM step. x: (batch, input_dim); state: (h, c) each (batch, H)."""
    h_prev, c_prev = state
    return ops.lstm_cell(x, h_prev, c_prev, params.w_ih, params.w_hh, params.b)


def lstm_apply(params: LSTMPredictor, xs: torch.Tensor) -> torch.Tensor:
    """Run the LSTM over a sequence and emit one prediction per step.

    xs: (T, batch, input_dim) -> (T, batch, output_dim); the prediction at
    step t is the model's estimate of x_{t+1}.
    """
    return ops.lstm_sequence(xs.contiguous(), params.w_ih, params.w_hh, params.b,
                             params.w_out, params.b_out)


@torch.no_grad()
def predict_next(params: LSTMPredictor, history: torch.Tensor) -> torch.Tensor:
    """Predict next-iteration speeds from history (T, n_nodes) -> (n_nodes,)."""
    xs = history[:, :, None]                        # (T, nodes, 1)
    return lstm_apply(params, xs)[-1, :, 0]


def mape(pred: torch.Tensor, true: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    return torch.mean(torch.abs(pred - true) / torch.clamp(torch.abs(true), min=eps))


def last_value_baseline(history: np.ndarray) -> np.ndarray:
    """Predict next speed = current speed (the paper's comparison point)."""
    return history[-1]


def ema_baseline(history: np.ndarray, alpha: float = 0.5) -> np.ndarray:
    w = alpha * (1 - alpha) ** np.arange(history.shape[0])[::-1]
    w = w / w.sum()
    return (history * w[:, None]).sum(axis=0)


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

Moments = Dict[str, torch.Tensor]


def _loss_fn(params: LSTMPredictor, xs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    preds = lstm_apply(params, xs)                  # (T, B, 1)
    return torch.mean((preds[:, :, 0] - targets) ** 2)


def _adam_update(params: LSTMPredictor, grads: Moments, opt_state: Tuple[Moments, Moments],
                 step: int, lr: float = 1e-2, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
    """One Adam update of ``params`` in place from ``grads`` (by name).
    Returns (params, new (m, v))."""
    m, v = opt_state
    m = {n: b1 * m[n] + (1 - b1) * g for n, g in grads.items()}
    v = {n: b2 * v[n] + (1 - b2) * g * g for n, g in grads.items()}
    with torch.no_grad():
        for n, p in params.named_parameters():
            mhat = m[n] / (1 - b1 ** (step + 1))
            vhat = v[n] / (1 - b2 ** (step + 1))
            p.copy_(p - lr * mhat / (torch.sqrt(vhat) + eps))
    return params, (m, v)


def _adam_step(params: LSTMPredictor, opt_state: Tuple[Moments, Moments], xs: torch.Tensor,
               targets: torch.Tensor, step: int, lr: float = 1e-2, b1: float = 0.9,
               b2: float = 0.999, eps: float = 1e-8):
    """Loss, gradients and one Adam update, as the JAX package's
    ``_adam_step``; ``opt_state`` is (m, v), each a tensor per parameter
    name.  Returns (params, (m, v), loss), the loss a 0-d tensor on the
    parameters' device (reading it would wait for the card)."""
    named = dict(params.named_parameters())
    loss = _loss_fn(params, xs, targets)
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    params, opt_state = _adam_update(params, grads, opt_state, step, lr, b1, b2, eps)
    return params, opt_state, loss.detach()


def train_predictor(traces: np.ndarray, epochs: int = 300, lr: float = 1e-2,
                    seed: int = 0, cfg: LSTMParams = LSTMParams(),
                    device: str | torch.device = "cuda", init: LSTMPredictor | None = None):
    """Train on (T, n_nodes) speed traces; 80:20 time split inside.

    Starts from a copy of ``init`` where given (its shapes set the
    config), else from ``init_lstm(cfg, seed)``.  Returns (params, metrics
    dict with train/test MAPE + baselines); the params are a
    :class:`LSTMPredictor` on ``device``.
    """
    dev = resolve_device(device)
    train, test = train_test_split(traces)
    if init is None:
        params = init_lstm(cfg, torch.Generator().manual_seed(seed), device=dev)
    else:
        params = LSTMPredictor(init.cfg, device=dev)
        params.load_state_dict(init.state_dict())
    opt_state = tuple({n: torch.zeros_like(p)
                       for n, p in params.named_parameters()} for _ in range(2))

    def seq_pair(arr):
        xs = torch.as_tensor(arr[:-1], dtype=torch.float32)[:, :, None]   # inputs
        tg = torch.as_tensor(arr[1:], dtype=torch.float32)                # next-step targets
        return xs.contiguous().to(dev), tg.to(dev)

    xs_tr, tg_tr = seq_pair(train)
    xs_te, tg_te = seq_pair(test)

    loss = torch.tensor(np.inf)
    for step in range(epochs):
        params, opt_state, loss = _adam_step(params, opt_state, xs_tr, tg_tr, step, lr=lr)

    with torch.no_grad():
        pred_te = lstm_apply(params, xs_te)[:, :, 0]
        pred_tr = lstm_apply(params, xs_tr)[:, :, 0]
        lv_te = xs_te[:, :, 0]                      # last-value = input itself
        metrics = {
            "final_train_loss": float(loss),
            "train_mape": float(mape(pred_tr, tg_tr)),
            "test_mape": float(mape(pred_te, tg_te)),
            "last_value_test_mape": float(mape(lv_te, tg_te)),
        }
    return params, metrics


# ---------------------------------------------------------------------------
# Online wrapper used by the scheduler
# ---------------------------------------------------------------------------

class SpeedPredictor:
    """Stateful online predictor: feed measured speeds, get next-iteration
    predictions.  Mirrors §6.2 — starts by assuming equal speeds, then
    tracks the LSTM conditioned on the last ``window`` observations."""

    def __init__(self, n_nodes: int, params: LSTMPredictor | None = None,
                 window: int = 32, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.n_nodes = n_nodes
        self.params = None if params is None else params.to(self.device)
        self.window = window
        self.history: list[np.ndarray] = []

    def observe(self, speeds: np.ndarray) -> None:
        self.history.append(np.asarray(speeds, dtype=np.float64))

    def reset_worker(self, worker: int) -> None:
        """Forget one worker's history (rejoin after a partition/fence).

        Its column is rewritten to the nominal speed 1.0 across the
        window, so the next prediction treats the rejoined worker as a
        fresh node instead of extrapolating its pre-partition collapse.
        """
        for h in self.history:
            h[worker] = 1.0

    def predict(self) -> np.ndarray:
        if not self.history:
            return np.ones(self.n_nodes)
        if self.params is None:
            return self.history[-1]
        hist = np.stack(self.history[-self.window:], axis=0)
        # the window in one copy, from pinned memory so that it is async
        host = torch.empty(hist.shape, dtype=torch.float32,
                           pin_memory=self.device.type == "cuda")
        host.numpy()[...] = hist
        hist_t = host.to(self.device, non_blocking=True)
        return predict_next(self.params, hist_t).cpu().numpy()
