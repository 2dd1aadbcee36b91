"""Per-chunk MDS decode: out[c] = W[c] @ Y[c].

Replaces ``src/repro/kernels/mds_decode.py::mds_decode_pallas``.  After an
S²C² round the master holds, for every chunk index c, the partial products
of the k responders, stacked as Y: (C, m, r), and the decode weights
W: (C, k, m).  Decoding is a batched product with a tiny contraction
(m ≤ 32) over a large r.

Two entry points share one kernel (``csrc/mds_decode.cu``):

* :func:`mds_decode_cuda` keeps the JAX contract, (C, k, m) × (C, m, r) →
  (C, k, r);
* :func:`mds_decode_into_cuda` reads ``Y[c, j]`` as row ``table[c, j]`` of
  a flat (P, r) tensor of partials and writes ``out[c, i, :]`` through any
  two strides of ``out``.  ``CodedMatvec.apply`` hands it coded_matvec's
  output and a strided view of y, so the gather before the decode and the
  transpose after it cost no launch and no round trip through memory.

On Hopper the kernel is bound by device-memory bytes and, at the main
path's few megabytes, by its launch.  One block per (chunk, 512-column tile)
keeps W[c] and the chunk's row table in shared memory; each thread reads 4
columns of each of the m partial rows with 16-byte loads and writes its 4
columns of the k outputs.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

__all__ = ["mds_decode_plain", "mds_decode_cuda", "mds_decode_into_plain",
           "mds_decode_into_cuda", "MAX_KM"]

MAX_KM = 32                     # kMaxKM in csrc/mds_decode.cu
# kernel launches since the last reset (see ops.reset_launch_counts); changed
# under _build.COUNT_LOCK
launches = 0


def mds_decode_plain(w: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version (the JAX package's ``mds_decode_ref``).

    w: (C, k, m); y: (C, m, r) -> (C, k, r) in y's dtype, float32 sums.
    """
    return torch.einsum("ckm,cmr->ckr", w.float(), y.float()).to(y.dtype)


def mds_decode_into_plain(w: torch.Tensor, parts: torch.Tensor, table: torch.Tensor,
                          out: torch.Tensor) -> torch.Tensor:
    """Plain version of the table-addressed decode.

    w: (C, k, m); parts: (P, r); table: (C, m) integer rows of parts;
    out: a (C, k, r) tensor or view, written in place and returned:
    out[c] = w[c] @ parts[table[c]], float32 sums.
    """
    out.copy_(torch.einsum("ckm,cmr->ckr", w.float(), parts[table.long()].float()))
    return out


def _launch(w: torch.Tensor, parts: torch.Tensor, table: torch.Tensor | None,
            out: torch.Tensor, n_parts: int, r: int, stride_c: int, stride_i: int) -> None:
    global launches
    chunks, k, m = w.shape
    if not (1 <= k <= MAX_KM and 1 <= m <= MAX_KM and 1 <= chunks <= 65535):
        raise ValueError(f"(C, k, m)=({chunks}, {k}, {m}) outside the kernel's limits")
    if r:
        err = _build.kernel("s2c2_mds_decode")(
            w.data_ptr(), parts.data_ptr(), None if table is None else table.data_ptr(),
            out.data_ptr(), chunks, k, m, r, n_parts, r, stride_c, stride_i,
            _build.stream_of(parts))
        _build.check(err, "mds_decode")
        with _build.COUNT_LOCK:
            launches += 1


def mds_decode_cuda(w: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel; same contract as :func:`mds_decode_plain`."""
    if w.ndim != 3 or y.ndim != 3:
        raise ValueError(f"need w (C, k, m) and y (C, m, r), got "
                         f"{tuple(w.shape)} and {tuple(y.shape)}")
    chunks, k, m = w.shape
    if y.shape[:2] != (chunks, m):
        raise ValueError(f"w {tuple(w.shape)} and y {tuple(y.shape)} do not match")
    if w.dtype != torch.float32 or y.dtype != torch.float32:
        raise TypeError(f"mds_decode takes float32, got {w.dtype}, {y.dtype}")
    if not (w.is_contiguous() and y.is_contiguous()):
        raise ValueError("mds_decode needs contiguous w and y")
    r = y.shape[2]
    out = torch.empty((chunks, k, r), dtype=torch.float32, device=y.device)
    # the identity table (a null pointer) and contiguous output strides
    _launch(w, y, None, out, chunks * m, r, k * r, r)
    return out


def mds_decode_into_cuda(w: torch.Tensor, parts: torch.Tensor, table: torch.Tensor,
                         out: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel; same contract as :func:`mds_decode_into_plain`.

    A table entry outside [0, P) gives NaN columns and no read.
    """
    if w.ndim != 3 or parts.ndim != 2 or table.ndim != 2 or out.ndim != 3:
        raise ValueError(f"need w (C, k, m), parts (P, r), table (C, m), out (C, k, r), "
                         f"got {tuple(w.shape)}, {tuple(parts.shape)}, "
                         f"{tuple(table.shape)}, {tuple(out.shape)}")
    chunks, k, m = w.shape
    n_parts, r = parts.shape
    if table.shape != (chunks, m) or out.shape != (chunks, k, r):
        raise ValueError(f"w {tuple(w.shape)}, parts {tuple(parts.shape)}, table "
                         f"{tuple(table.shape)} and out {tuple(out.shape)} do not match")
    if (w.dtype != torch.float32 or parts.dtype != torch.float32
            or out.dtype != torch.float32 or table.dtype != torch.int32):
        raise TypeError(f"mds_decode takes float32 w, parts, out and an int32 table, got "
                        f"{w.dtype}, {parts.dtype}, {out.dtype}, {table.dtype}")
    if not (w.is_contiguous() and parts.is_contiguous() and table.is_contiguous()):
        raise ValueError("mds_decode needs contiguous w, parts and table")
    if r > 1 and out.stride(2) != 1:
        raise ValueError(f"out's columns must be contiguous, got strides {out.stride()}")
    _launch(w, parts, table, out, n_parts, r, out.stride(0), out.stride(1))
    return out
