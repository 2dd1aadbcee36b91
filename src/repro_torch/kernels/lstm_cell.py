"""The speed predictor's LSTM (gate order i, f, g, o): one cell, and the
whole window with its output head.

Replaces ``src/repro/kernels/lstm_cell.py::lstm_cell_pallas`` and, for the
window, the ``lax.scan`` around it (``src/repro/core/predictor.py::
lstm_apply``).  The scheduler predicts every worker's next speed each
iteration, batched over workers: a (B = workers, H = 4) recurrence over the
last T ≤ 32 observed speeds between collecting response times and issuing
the next allocation.

On Hopper both kernels (``csrc/lstm_cell.cu``) are bound by launches and by
the chain of dependent steps, not by bytes: a window moves a few kB.

* the cell (:func:`lstm_cell_cuda`): one launch per step, one thread per
  (b, j) element, on the packed 4H weights as they are (the TPU wrapper's
  per-gate padding to 128 lanes is not carried over);
* the sequence (:func:`lstm_sequence_cuda`), which the main path takes: one
  launch per window runs all T steps and the head, with each gate row's
  weights in registers and the state exchanged by warp shuffles (4H ≤ 32)
  or through shared memory with one barrier a step (4H > 32).  It takes
  H ≤ ``MAX_SEQUENCE_HIDDEN``, I ≤ ``MAX_SEQUENCE_INPUT`` and O ≤ 4H.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

__all__ = ["lstm_cell_plain", "lstm_cell_cuda", "lstm_sequence_plain", "lstm_sequence_cuda",
           "MAX_SEQUENCE_HIDDEN", "MAX_SEQUENCE_INPUT"]

MAX_SEQUENCE_HIDDEN = 32    # kMaxHidden in csrc/lstm_cell.cu
MAX_SEQUENCE_INPUT = 16     # kMaxIn in csrc/lstm_cell.cu
# kernel launches since the last reset (see ops.reset_launch_counts): all of
# them, and those of each design
launches = 0
launches_cell = 0
launches_sequence = 0


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
    global launches, launches_cell
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
        launches_cell += 1
    return h_new, c_new


def lstm_sequence_plain(xs: torch.Tensor, w_ih: torch.Tensor, w_hh: torch.Tensor,
                        b: torch.Tensor, w_out: torch.Tensor, b_out: torch.Tensor):
    """Plain PyTorch version (the JAX package's ``lstm_apply``): the cell and
    the head at every step, from h = c = 0.

    xs: (T, B, I); w_ih: (4H, I); w_hh: (4H, H); b: (4H,); w_out: (O, H);
    b_out: (O,).  Returns ys: (T, B, O).
    """
    steps, bsz, _ = xs.shape
    h = xs.new_zeros((bsz, w_hh.shape[1]))
    c = xs.new_zeros((bsz, w_hh.shape[1]))
    ys = []
    for x in xs:
        h, c = lstm_cell_plain(x, h, c, w_ih, w_hh, b)
        ys.append(h @ w_out.T + b_out)
    return torch.stack(ys) if steps else xs.new_empty((0, bsz, w_out.shape[0]))


def lstm_sequence_cuda(xs: torch.Tensor, w_ih: torch.Tensor, w_hh: torch.Tensor,
                       b: torch.Tensor, w_out: torch.Tensor, b_out: torch.Tensor):
    """Launch the sequence kernel; same contract as :func:`lstm_sequence_plain`."""
    global launches, launches_sequence
    if xs.ndim != 3 or w_hh.ndim != 2 or w_out.ndim != 2:
        raise ValueError("need xs (T, B, I), w_hh (4H, H) and w_out (O, H)")
    steps, bsz, idim = xs.shape
    hdim, odim = w_hh.shape[1], w_out.shape[0]
    # the kernel indexes every operand by xs's (T, B, I), w_hh's H and w_out's O
    if (w_ih.shape != (4 * hdim, idim) or w_hh.shape != (4 * hdim, hdim)
            or b.shape != (4 * hdim,) or w_out.shape != (odim, hdim) or b_out.shape != (odim,)):
        raise ValueError(f"shapes xs {tuple(xs.shape)}, w_ih {tuple(w_ih.shape)}, w_hh "
                         f"{tuple(w_hh.shape)}, b {tuple(b.shape)}, w_out {tuple(w_out.shape)}, "
                         f"b_out {tuple(b_out.shape)} do not make one LSTM sequence")
    if not (1 <= hdim <= MAX_SEQUENCE_HIDDEN and 1 <= idim <= MAX_SEQUENCE_INPUT
            and 1 <= odim <= 4 * hdim):
        raise ValueError(f"the sequence kernel keeps a gate row in registers: it takes "
                         f"1 <= H <= {MAX_SEQUENCE_HIDDEN}, 1 <= I <= {MAX_SEQUENCE_INPUT} "
                         f"and 1 <= O <= 4H, got H = {hdim}, I = {idim}, O = {odim}")
    tensors = (xs, w_ih, w_hh, b, w_out, b_out)
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError("lstm_sequence takes float32 tensors")
        if not t.is_contiguous():
            raise ValueError("lstm_sequence needs contiguous tensors")
    ys = torch.empty((steps, bsz, odim), dtype=torch.float32, device=xs.device)
    if steps and bsz:
        fn = _build.kernel("s2c2_lstm_sequence")
        err = fn(xs.data_ptr(), w_ih.data_ptr(), w_hh.data_ptr(), b.data_ptr(),
                 w_out.data_ptr(), b_out.data_ptr(), ys.data_ptr(), steps, bsz, idim, hdim,
                 odim, _build.stream_of(xs))
        _build.check(err, "lstm_sequence")
        launches += 1
        launches_sequence += 1
    return ys
