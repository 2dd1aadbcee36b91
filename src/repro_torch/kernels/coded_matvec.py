"""Slack-squeeze coded product: out[i] = A[ids[i]·br:(ids[i]+1)·br] @ x.

Replaces ``src/repro/kernels/coded_matvec.py::coded_matvec_pallas``.  The
S²C² scheduler assigns each worker a subset of the row-blocks of its coded
partition; only those blocks are read, so the cost scales with the work
assigned.

On Hopper the kernel (``csrc/coded_matvec.cu``) is bound by device-memory
bytes: at ``nvec = 1`` each element read feeds one multiply-add.  Two designs,
chosen by shape, never by trying one:

* the stream (:func:`coded_matvec_stream`), for ``nvec = 1`` with rows of a
  multiple of 16 bytes and at most ``MAX_STREAM_ROW_BYTES``, and a 16-byte
  aligned ``a``: a persistent grid, one block per SM, in which one thread
  keeps a ring of shared-memory tiles filled by bulk copies (TMA) while
  consumer warps reduce rows out of it, so the bytes in flight never wait
  for a reduction.  The main path takes it.
* the general path (:func:`coded_matvec_general`) for every other shape: one
  warp per row, 16-byte loads where d and the alignment allow, ``nvec`` up
  to 16.

Both accumulate in float32, read each assigned row once, and give NaN rows
for an id outside ``a``.  Each block id is read by the kernel itself (the
TPU kernel's scalar prefetch), and nothing is padded: no d tile, and no 128
lanes of ``nvec`` for a single vector.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

__all__ = ["coded_matvec_plain", "coded_matvec_cuda", "coded_matvec_stream",
           "coded_matvec_general", "takes_stream", "MAX_NVEC", "MAX_STREAM_ROW_BYTES"]

MAX_NVEC = 16
MAX_STREAM_ROW_BYTES = 32 * 1024  # kMaxRowBytes in csrc/coded_matvec.cu
_ROWS_PER_LAUNCH_BLOCK = 64      # kRowsPerBlock in csrc/coded_matvec.cu
# kernel launches since the last reset (see ops.reset_launch_counts): all of
# them, and those of each design; changed under _build.COUNT_LOCK
launches = 0
launches_stream = 0
launches_general = 0


def _as_matrix(x: torch.Tensor) -> tuple[torch.Tensor, bool]:
    if x.ndim == 1:
        return x[:, None], True
    if x.ndim == 2:
        return x, False
    raise ValueError(f"x must be (d,) or (d, nvec), got shape {tuple(x.shape)}")


def coded_matvec_plain(a: torch.Tensor, x: torch.Tensor, block_ids: torch.Tensor,
                       block_rows: int) -> torch.Tensor:
    """Plain PyTorch version (the JAX package's ``coded_matvec_ref``).

    a: (rows, d); x: (d,) or (d, nvec); block_ids: (nb,) integer.
    Returns (nb, block_rows) for a vector x, else (nb, block_rows, nvec),
    in x's dtype, accumulated in float32.
    """
    x2, squeeze = _as_matrix(x)
    d = a.shape[1]
    sel = a.reshape(-1, block_rows, d)[block_ids.long()]          # (nb, br, d)
    out = torch.einsum("nbd,dv->nbv", sel.float(), x2.float()).to(x.dtype)
    return out[:, :, 0] if squeeze else out


def _checked(a: torch.Tensor, x: torch.Tensor, block_ids: torch.Tensor,
             block_rows: int) -> tuple[torch.Tensor, bool]:
    """Validate a CUDA call; return x as (d, nvec) and whether it was (d,)."""
    x2, squeeze = _as_matrix(x)
    if a.ndim != 2:
        raise ValueError(f"a must be (rows, d), got shape {tuple(a.shape)}")
    rows, d = a.shape
    nvec = x2.shape[1]
    if x2.shape[0] != d:
        raise ValueError(f"x has {x2.shape[0]} rows, a has d={d}")
    if a.dtype not in _build.DTYPE_CODES or x.dtype != a.dtype:
        raise TypeError(f"need a and x both float32 or both bfloat16, got {a.dtype}, {x.dtype}")
    if block_ids.dtype != torch.int32 or block_ids.ndim != 1:
        raise TypeError("block_ids must be a 1-D int32 tensor")
    if not (a.is_contiguous() and x2.is_contiguous() and block_ids.is_contiguous()):
        raise ValueError("coded_matvec needs contiguous a, x and block_ids")
    if block_rows < 1 or rows % block_rows:
        raise ValueError(f"rows={rows} not divisible by block_rows={block_rows}")
    if not 1 <= nvec <= MAX_NVEC:
        raise ValueError(f"nvec={nvec} outside [1, {MAX_NVEC}]")
    return x2, squeeze


def takes_stream(a: torch.Tensor, x: torch.Tensor) -> bool:
    """Whether :func:`coded_matvec_cuda` runs these operands on the stream design."""
    row_bytes = a.shape[1] * a.element_size()
    return ((x.ndim == 1 or x.shape[1] == 1) and row_bytes % 16 == 0
            and row_bytes <= MAX_STREAM_ROW_BYTES and a.data_ptr() % 16 == 0)


def coded_matvec_cuda(a: torch.Tensor, x: torch.Tensor, block_ids: torch.Tensor,
                      block_rows: int) -> torch.Tensor:
    """Launch the CUDA kernel of the design the shape takes; same contract as
    :func:`coded_matvec_plain`."""
    _build.library()            # without a toolkit, raise before any pointer is read
    x2, squeeze = _checked(a, x, block_ids, block_rows)
    if takes_stream(a, x2):
        return _stream(a, x2, block_ids, block_rows, squeeze)
    return _general(a, x2, block_ids, block_rows, squeeze)


def coded_matvec_stream(a: torch.Tensor, x: torch.Tensor, block_ids: torch.Tensor,
                        block_rows: int) -> torch.Tensor:
    """The persistent, TMA-fed design; raises for a shape it does not take."""
    _build.library()
    x2, squeeze = _checked(a, x, block_ids, block_rows)
    if not takes_stream(a, x2):
        raise ValueError(f"the stream design takes nvec = 1 and 16-byte-aligned rows of at "
                         f"most {MAX_STREAM_ROW_BYTES} bytes, got a {tuple(a.shape)} "
                         f"{a.dtype} at {a.data_ptr() % 16} past 16, nvec={x2.shape[1]}")
    return _stream(a, x2, block_ids, block_rows, squeeze)


def coded_matvec_general(a: torch.Tensor, x: torch.Tensor, block_ids: torch.Tensor,
                         block_rows: int) -> torch.Tensor:
    """The warp-per-row design, for any shape the kernel takes."""
    _build.library()
    x2, squeeze = _checked(a, x, block_ids, block_rows)
    return _general(a, x2, block_ids, block_rows, squeeze)


def _stream(a, x2, block_ids, block_rows, squeeze) -> torch.Tensor:
    global launches, launches_stream
    nb = block_ids.shape[0]
    out = torch.empty((nb, block_rows), dtype=a.dtype, device=a.device)
    if nb:
        err = _build.kernel("s2c2_coded_matvec_stream")(
            a.data_ptr(), x2.data_ptr(), block_ids.data_ptr(), out.data_ptr(),
            a.shape[0] // block_rows, nb, block_rows, a.shape[1], _build.DTYPE_CODES[a.dtype],
            _build.stream_of(a))
        _build.check(err, "coded_matvec (stream)")
        with _build.COUNT_LOCK:
            launches += 1
            launches_stream += 1
    return out if squeeze else out[:, :, None]


def _general(a, x2, block_ids, block_rows, squeeze) -> torch.Tensor:
    global launches, launches_general
    rows, d = a.shape
    nvec = x2.shape[1]
    nb = block_ids.shape[0]
    tiles = -(-block_rows // _ROWS_PER_LAUNCH_BLOCK)
    if nb * tiles >= 2**31:
        raise ValueError(f"{nb} blocks of {block_rows} rows exceed one launch's grid")
    out = torch.empty((nb, block_rows, nvec), dtype=a.dtype, device=a.device)
    if nb:
        packet = 16 // a.element_size()
        vec = (d % packet == 0 and a.data_ptr() % 16 == 0 and x2.data_ptr() % 16 == 0)
        err = _build.kernel("s2c2_coded_matvec")(
            a.data_ptr(), x2.data_ptr(), block_ids.data_ptr(), out.data_ptr(),
            rows // block_rows, nb, block_rows, d, nvec, _build.DTYPE_CODES[a.dtype],
            int(vec), _build.stream_of(a))
        _build.check(err, "coded_matvec")
        with _build.COUNT_LOCK:
            launches += 1
            launches_general += 1
    return out[:, :, 0] if squeeze else out
