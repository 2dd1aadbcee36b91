"""Slack-squeeze coded product: out[i] = A[ids[i]·br:(ids[i]+1)·br] @ x.

Replaces ``src/repro/kernels/coded_matvec.py::coded_matvec_pallas``.  The
S²C² scheduler assigns each worker a subset of the row-blocks of its coded
partition; only those blocks are read, so the cost scales with the work
assigned.

On Hopper the kernel (``csrc/coded_matvec.cu``) is bound by device-memory
bytes: each element read feeds ``nvec`` ≤ 16 multiply-adds.  Four designs,
chosen by shape (:func:`design_of`), never by trying one:

* the stream (:func:`coded_matvec_stream`), for ``nvec = 1`` with rows of a
  multiple of 16 bytes and at most ``MAX_STREAM_ROW_BYTES``, and a 16-byte
  aligned ``a``: a persistent grid, one block per SM, in which one thread
  keeps a ring of shared-memory tiles filled by bulk copies (TMA) while
  consumer warps reduce rows out of it, so the bytes in flight never wait
  for a reduction.  The main path takes it.
* the split-row stream (:func:`coded_matvec_split`), for ``nvec = 1`` with
  16-byte-aligned rows over ``MAX_STREAM_ROW_BYTES`` (PageRank's and the
  graph filter's), whose whole rows and x no longer fit beside a ring: the
  same persistent, TMA-fed ring, but each block owns an equal range of the
  assigned rows and walks d in slices, a tile being one row's segment of
  one slice; only that slice of x is in shared memory, and each row's slice
  sums are added in slice order, so the result has the same bits on every
  run.
* the multi design (:func:`coded_matvec_multi`) for every x of 2 to 16
  columns, which the cluster's ``matmul`` chunks take: a persistent grid, x
  staged once per block in shared memory as float32 columns, each warp
  computing two rows at once so that a read of x feeds both.
* the general path (:func:`coded_matvec_general`) for the ``nvec = 1``
  shapes the two streams refuse (a row not a multiple of 16 bytes, an
  unaligned ``a``): one warp per row, 16-byte loads where d and the
  alignment allow.

All accumulate in float32, read each assigned row once, and give NaN rows
for an id outside ``a``.  Each block id is read by the kernel itself (the
TPU kernel's scalar prefetch), and nothing is padded: no d tile, and no 128
lanes of ``nvec`` for a single vector.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

__all__ = ["coded_matvec_plain", "coded_matvec_cuda", "coded_matvec_stream",
           "coded_matvec_split", "coded_matvec_multi", "coded_matvec_general", "design_of",
           "MAX_NVEC", "MAX_STREAM_ROW_BYTES"]

MAX_NVEC = 16
MAX_STREAM_ROW_BYTES = 32 * 1024  # kMaxRowBytes in csrc/coded_matvec.cu
_ROWS_PER_LAUNCH_BLOCK = 64      # kRowsPerBlock in csrc/coded_matvec.cu
# kernel launches since the last reset (see ops.reset_launch_counts): all of
# them, and those of each design; changed under _build.COUNT_LOCK
launches = 0
launches_stream = 0
launches_split = 0
launches_multi = 0
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


def design_of(a: torch.Tensor, x: torch.Tensor) -> str:
    """The design :func:`coded_matvec_cuda` runs these operands on:
    ``"stream"``, ``"split"``, ``"multi"`` or ``"general"``, from their
    shapes, dtype and ``a``'s alignment alone."""
    if x.ndim == 2 and x.shape[1] >= 2:
        return "multi"
    row_bytes = a.shape[1] * a.element_size()
    if row_bytes % 16 == 0 and a.data_ptr() % 16 == 0:
        return "stream" if row_bytes <= MAX_STREAM_ROW_BYTES else "split"
    return "general"


def coded_matvec_cuda(a: torch.Tensor, x: torch.Tensor, block_ids: torch.Tensor,
                      block_rows: int) -> torch.Tensor:
    """Launch the CUDA kernel of the design the shape takes; same contract as
    :func:`coded_matvec_plain`."""
    _build.library()            # without a toolkit, raise before any pointer is read
    x2, squeeze = _checked(a, x, block_ids, block_rows)
    return _LAUNCH[design_of(a, x2)](a, x2, block_ids, block_rows, squeeze)


def _design(design: str, a, x, block_ids, block_rows) -> torch.Tensor:
    """Launch ``design``; raise for a shape that :func:`design_of` gives to
    another design (the general path also takes the two streams' shapes)."""
    _build.library()
    x2, squeeze = _checked(a, x, block_ids, block_rows)
    got = design_of(a, x2)
    if got != design and not (design == "general" and got in ("stream", "split")):
        raise ValueError(f"the {design} design does not take a {tuple(a.shape)} {a.dtype} at "
                         f"{a.data_ptr() % 16} past 16 with nvec={x2.shape[1]}: that is the "
                         f"{got} design's")
    return _LAUNCH[design](a, x2, block_ids, block_rows, squeeze)


def coded_matvec_stream(a: torch.Tensor, x: torch.Tensor, block_ids: torch.Tensor,
                        block_rows: int) -> torch.Tensor:
    """The persistent, TMA-fed design: nvec = 1 and 16-byte-aligned rows of
    at most ``MAX_STREAM_ROW_BYTES``; raises for any other shape."""
    return _design("stream", a, x, block_ids, block_rows)


def coded_matvec_split(a: torch.Tensor, x: torch.Tensor, block_ids: torch.Tensor,
                       block_rows: int) -> torch.Tensor:
    """The split-row stream: nvec = 1 and 16-byte-aligned rows over
    ``MAX_STREAM_ROW_BYTES``; raises for any other shape."""
    return _design("split", a, x, block_ids, block_rows)


def coded_matvec_multi(a: torch.Tensor, x: torch.Tensor, block_ids: torch.Tensor,
                       block_rows: int) -> torch.Tensor:
    """The multi-RHS design: x of shape (d, nvec), 2 <= nvec <= 16; raises
    for any other shape."""
    return _design("multi", a, x, block_ids, block_rows)


def coded_matvec_general(a: torch.Tensor, x: torch.Tensor, block_ids: torch.Tensor,
                         block_rows: int) -> torch.Tensor:
    """The warp-per-row design, for any shape with nvec = 1."""
    return _design("general", a, x, block_ids, block_rows)


def _count(design: str) -> None:
    global launches, launches_stream, launches_split, launches_multi, launches_general
    with _build.COUNT_LOCK:
        launches += 1
        if design == "stream":
            launches_stream += 1
        elif design == "split":
            launches_split += 1
        elif design == "multi":
            launches_multi += 1
        else:
            launches_general += 1


def _stream(a, x2, block_ids, block_rows, squeeze) -> torch.Tensor:
    nb = block_ids.shape[0]
    out = torch.empty((nb, block_rows), dtype=a.dtype, device=a.device)
    if nb:
        err = _build.kernel("s2c2_coded_matvec_stream")(
            a.data_ptr(), x2.data_ptr(), block_ids.data_ptr(), out.data_ptr(),
            a.shape[0] // block_rows, nb, block_rows, a.shape[1], _build.DTYPE_CODES[a.dtype],
            _build.stream_of(a))
        _build.check(err, "coded_matvec (stream)")
        _count("stream")
    return out if squeeze else out[:, :, None]


def _split(a, x2, block_ids, block_rows, squeeze) -> torch.Tensor:
    nb = block_ids.shape[0]
    out = torch.empty((nb, block_rows), dtype=a.dtype, device=a.device)
    if nb:
        # x's slices arrive by bulk copy, which needs 16-byte alignment
        x_in = x2 if x2.data_ptr() % 16 == 0 else x2.clone()
        err = _build.kernel("s2c2_coded_matvec_split")(
            a.data_ptr(), x_in.data_ptr(), block_ids.data_ptr(), out.data_ptr(),
            a.shape[0] // block_rows, nb, block_rows, a.shape[1], _build.DTYPE_CODES[a.dtype],
            _build.stream_of(a))
        _build.check(err, "coded_matvec (split)")
        _count("split")
    return out if squeeze else out[:, :, None]


def _multi(a, x2, block_ids, block_rows, squeeze) -> torch.Tensor:
    nb, nvec = block_ids.shape[0], x2.shape[1]
    out = torch.empty((nb, block_rows, nvec), dtype=a.dtype, device=a.device)
    if nb:
        err = _build.kernel("s2c2_coded_matvec_multi")(
            a.data_ptr(), x2.data_ptr(), block_ids.data_ptr(), out.data_ptr(),
            a.shape[0] // block_rows, nb, block_rows, a.shape[1], nvec,
            _build.DTYPE_CODES[a.dtype], _build.stream_of(a))
        _build.check(err, "coded_matvec (multi)")
        _count("multi")
    return out


def _general(a, x2, block_ids, block_rows, squeeze) -> torch.Tensor:
    rows, d = a.shape
    nb = block_ids.shape[0]
    tiles = -(-block_rows // _ROWS_PER_LAUNCH_BLOCK)
    if nb * tiles >= 2**31:
        raise ValueError(f"{nb} blocks of {block_rows} rows exceed one launch's grid")
    out = torch.empty((nb, block_rows), dtype=a.dtype, device=a.device)
    if nb:
        packet = 16 // a.element_size()
        vec = (d % packet == 0 and a.data_ptr() % 16 == 0 and x2.data_ptr() % 16 == 0)
        err = _build.kernel("s2c2_coded_matvec")(
            a.data_ptr(), x2.data_ptr(), block_ids.data_ptr(), out.data_ptr(),
            rows // block_rows, nb, block_rows, d, _build.DTYPE_CODES[a.dtype], int(vec),
            _build.stream_of(a))
        _build.check(err, "coded_matvec")
        _count("general")
    return out if squeeze else out[:, :, None]


_LAUNCH = {"stream": _stream, "split": _split, "multi": _multi, "general": _general}
