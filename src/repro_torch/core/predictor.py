"""LSTM speed predictor (§3.2, §6.1 of the paper) in PyTorch.

The paper's architecture: a single-layer LSTM, 1-dim input (the previous
iteration's speed), 4-dim hidden state, and a 1-dim linear output head
predicting the next iteration's speed.  The model is shared across nodes
(speeds are batched over nodes).

A prediction runs the whole window, every LSTM step and the output head
``h @ w_outᵀ + b_out``, through ``ops.lstm_sequence``: one launch of the
sequence kernel on a card (where the JAX package runs one ``lax.scan``),
its plain version on the CPU.  :func:`lstm_cell`, one step, goes through
``ops.lstm_cell``.  Both run with grad enabled too: on a card the kernel
computes the forward and the backward differentiates the plain version.  Training (``train_predictor`` and its Adam) is not
ported yet: trained parameters come from the JAX package through
:mod:`repro_torch.convert`.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
from torch import nn

from repro_torch._device import resolve_device
from repro_torch.kernels import ops

__all__ = [
    "LSTMParams", "LSTMPredictor", "lstm_cell", "lstm_apply", "predict_next",
    "mape", "last_value_baseline", "ema_baseline", "SpeedPredictor",
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
