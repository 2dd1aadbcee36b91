"""Dispatch for the kernels: a CPU tensor takes the plain version, a CUDA
tensor the hand-written kernel.

There is no fallback between the two: tensors on a CUDA device launch the
kernel or raise (a missing toolkit, a failed build or a refused launch all
raise), and tensors on any other device, or on several devices at once,
raise.  The LSTM's kernels have a backward: a CUDA call that autograd has
to differentiate launches the kernel on detached inputs, and its backward
recomputes the plain version and differentiates that, as the JAX package
differentiates only its plain ``jnp`` path.  The other kernels have none,
so such a call to them raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import coded_matvec as _cmv
from repro_torch.kernels import lstm_cell as _lstm
from repro_torch.kernels import mds_decode as _dec
from repro_torch.kernels import mds_encode as _enc

__all__ = ["coded_matvec", "mds_encode", "mds_decode", "mds_decode_into", "lstm_cell",
           "lstm_sequence", "launch_counts", "design_counts", "reset_launch_counts"]

_MODULES = {"coded_matvec": _cmv, "mds_encode": _enc, "mds_decode": _dec,
            "lstm_cell": _lstm}


def _on_card(op: str, *tensors: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU tensors; raise for anything else."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{op}: tensors on several devices {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{op}: no version for device {dev}")
    return True


def _needs_grad(tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _use_kernel(op: str, *tensors: torch.Tensor) -> bool:
    """:func:`_on_card`, raising for a CUDA call that autograd would have to
    differentiate (these kernels have no backward)."""
    if not _on_card(op, *tensors):
        return False
    if _needs_grad(tensors):
        raise RuntimeError(f"{op}: the CUDA kernel has no backward; call it under "
                           "torch.no_grad()")
    return True


class _PlainBackward(torch.autograd.Function):
    """``kernel(*args)`` forward, on detached inputs; the backward recomputes
    ``plain(*args)`` under autograd and differentiates it."""

    @staticmethod
    def forward(ctx, kernel, plain, *args):
        ctx.plain = plain
        ctx.save_for_backward(*args)
        return kernel(*(a.detach() for a in args))

    @staticmethod
    def backward(ctx, *grads):
        args = [a.detach().requires_grad_(need)
                for a, need in zip(ctx.saved_tensors, ctx.needs_input_grad[2:])]
        with torch.enable_grad():
            out = ctx.plain(*args)
        wrt = [a for a in args if a.requires_grad]
        got = iter(torch.autograd.grad(out if isinstance(out, tuple) else (out,), wrt, grads,
                                       allow_unused=True))
        return (None, None, *(next(got) if a.requires_grad else None for a in args))


def coded_matvec(a: torch.Tensor, x: torch.Tensor, block_ids: torch.Tensor,
                 block_rows: int) -> torch.Tensor:
    """out[i] = A[block_ids[i]·br:(…+1)·br] @ x.

    a: (rows, d); x: (d,) or (d, nvec); block_ids: (nb,) int32.
    Returns (nb, block_rows) for vector x, else (nb, block_rows, nvec).
    """
    if _use_kernel("coded_matvec", a, x, block_ids):
        return _cmv.coded_matvec_cuda(a, x, block_ids, block_rows)
    return _cmv.coded_matvec_plain(a, x, block_ids, block_rows)


def mds_encode(g: torch.Tensor, blocks: torch.Tensor) -> torch.Tensor:
    """g: (n, k); blocks: (k, rows, d) -> (n, rows, d)."""
    if _use_kernel("mds_encode", g, blocks):
        return _enc.mds_encode_cuda(g, blocks)
    return _enc.mds_encode_plain(g, blocks)


def mds_decode(w: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """w: (chunks, k, m); y: (chunks, m, r) -> (chunks, k, r)."""
    if _use_kernel("mds_decode", w, y):
        return _dec.mds_decode_cuda(w, y)
    return _dec.mds_decode_plain(w, y)


def mds_decode_into(w: torch.Tensor, parts: torch.Tensor, table: torch.Tensor,
                    out: torch.Tensor) -> torch.Tensor:
    """out[c] = w[c] @ parts[table[c]], written into ``out`` and returned.

    w: (chunks, k, m); parts: (P, r); table: (chunks, m) int32; out: a
    (chunks, k, r) tensor or strided view whose last dim is contiguous.
    """
    if _use_kernel("mds_decode", w, parts, table, out):
        return _dec.mds_decode_into_cuda(w, parts, table, out)
    return _dec.mds_decode_into_plain(w, parts, table, out)


def lstm_cell(x: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
              w_ih: torch.Tensor, w_hh: torch.Tensor, b: torch.Tensor):
    """Fused LSTM cell; shapes as in :func:`ref.lstm_cell_ref`."""
    args = (x, h, c, w_ih, w_hh, b)
    if not _on_card("lstm_cell", *args):
        return _lstm.lstm_cell_plain(*args)
    if _needs_grad(args):
        return _PlainBackward.apply(_lstm.lstm_cell_cuda, _lstm.lstm_cell_plain, *args)
    return _lstm.lstm_cell_cuda(*args)


def lstm_sequence(xs: torch.Tensor, w_ih: torch.Tensor, w_hh: torch.Tensor, b: torch.Tensor,
                  w_out: torch.Tensor, b_out: torch.Tensor) -> torch.Tensor:
    """The LSTM over a window from h = c = 0, with the output head at every
    step: xs (T, B, I) -> ys (T, B, O); weights as in
    :func:`ref.lstm_sequence_ref`."""
    args = (xs, w_ih, w_hh, b, w_out, b_out)
    if not _on_card("lstm_sequence", *args):
        return _lstm.lstm_sequence_plain(*args)
    if _needs_grad(args):
        return _PlainBackward.apply(_lstm.lstm_sequence_cuda, _lstm.lstm_sequence_plain, *args)
    return _lstm.lstm_sequence_cuda(*args)


def launch_counts() -> dict[str, int]:
    """Kernel launches per kernel since the last :func:`reset_launch_counts`
    (``lstm_cell``: the cell's and the sequence's together)."""
    with _build.COUNT_LOCK:
        return {name: mod.launches for name, mod in _MODULES.items()}


def design_counts() -> dict[str, dict[str, int]]:
    """The launches of the kernels with several designs, per design, since
    the last reset."""
    with _build.COUNT_LOCK:
        return {"coded_matvec": {"stream": _cmv.launches_stream,
                                 "split": _cmv.launches_split,
                                 "multi": _cmv.launches_multi,
                                 "general": _cmv.launches_general},
                "lstm_cell": {"sequence": _lstm.launches_sequence,
                              "cell": _lstm.launches_cell}}


def reset_launch_counts() -> None:
    with _build.COUNT_LOCK:
        for mod in _MODULES.values():
            mod.launches = 0
        _cmv.launches_stream = _cmv.launches_split = 0
        _cmv.launches_multi = _cmv.launches_general = 0
        _lstm.launches_sequence = _lstm.launches_cell = 0
