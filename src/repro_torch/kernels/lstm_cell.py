"""Fused LSTM cell for the speed predictor (gate order i, f, g, o).

Replaces ``src/repro/kernels/lstm_cell.py::lstm_cell_pallas``.  The
scheduler predicts every worker's next speed each iteration, batched over
workers: a (B = workers, H = 4) recurrence between collecting response
times and issuing the next allocation.

On Hopper the kernel (``csrc/lstm_cell.cu``) is bound by its launch: a step
moves a few hundred bytes.  One launch does both gate products, the
activations and the state update, one thread per (b, j) element, on the
packed 4H weights as they are (the TPU wrapper's per-gate padding to 128
lanes is not carried over).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

__all__ = ["lstm_cell_plain", "lstm_cell_cuda"]

launches = 0        # kernel launches since the last reset (see ops.reset_launch_counts)


def lstm_cell_plain(x: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
                    w_ih: torch.Tensor, w_hh: torch.Tensor, b: torch.Tensor):
    """Plain PyTorch version (the JAX package's ``lstm_cell_ref``).

    x: (B, I); h, c: (B, H); w_ih: (4H, I); w_hh: (4H, H); b: (4H,).
    Returns (h', c') each (B, H).
    """
    gates = x @ w_ih.T + h @ w_hh.T + b
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
    c_new = f * c + i * torch.tanh(g)
    return o * torch.tanh(c_new), c_new


def lstm_cell_cuda(x: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
                   w_ih: torch.Tensor, w_hh: torch.Tensor, b: torch.Tensor):
    """Launch the CUDA kernel; same contract as :func:`lstm_cell_plain`."""
    global launches
    if x.ndim != 2 or h.ndim != 2:
        raise ValueError("need x (B, I) and h, c (B, H)")
    bsz, idim = x.shape
    hdim = h.shape[1]
    # the kernel reads x, h, c and writes h', c' over bsz rows of each
    if (h.shape != (bsz, hdim) or c.shape != h.shape or w_ih.shape != (4 * hdim, idim)
            or w_hh.shape != (4 * hdim, hdim) or b.shape != (4 * hdim,)):
        raise ValueError(f"shapes x {tuple(x.shape)}, h {tuple(h.shape)}, c {tuple(c.shape)}, "
                         f"w_ih {tuple(w_ih.shape)}, w_hh {tuple(w_hh.shape)}, b "
                         f"{tuple(b.shape)} do not make one LSTM cell")
    tensors = (x, h, c, w_ih, w_hh, b)
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError("lstm_cell takes float32 tensors")
        if not t.is_contiguous():
            raise ValueError("lstm_cell needs contiguous tensors")
    fn = _build.kernel("s2c2_lstm_cell")
    h_new = torch.empty_like(h)
    c_new = torch.empty_like(c)
    if bsz and hdim:
        err = fn(x.data_ptr(), h.data_ptr(), c.data_ptr(), w_ih.data_ptr(), w_hh.data_ptr(),
                 b.data_ptr(), h_new.data_ptr(), c_new.data_ptr(), bsz, idim, hdim,
                 _build.stream_of(x))
        _build.check(err, "lstm_cell")
        launches += 1
    return h_new, c_new
