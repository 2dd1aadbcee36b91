"""Per-chunk MDS decode: out[c] = W[c] @ Y[c].

Replaces ``src/repro/kernels/mds_decode.py::mds_decode_pallas``.  After an
S²C² round the master holds, for every chunk index c, the partial products
of the k responders, stacked as Y: (C, m, r), and the decode weights
W: (C, k, m).  Decoding is a batched product with a tiny contraction
(m ≤ 32) over a large r.

On Hopper the kernel (``csrc/mds_decode.cu``) is bound by device-memory
bytes and, at the main path's few megabytes, by its launch.  One block per
(chunk, 256-column tile) keeps W[c] in shared memory and reads each column
of Y once.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

__all__ = ["mds_decode_plain", "mds_decode_cuda", "MAX_KM"]

MAX_KM = 32                     # kMaxKM in csrc/mds_decode.cu
launches = 0        # kernel launches since the last reset (see ops.reset_launch_counts)


def mds_decode_plain(w: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version (the JAX package's ``mds_decode_ref``).

    w: (C, k, m); y: (C, m, r) -> (C, k, r) in y's dtype, float32 sums.
    """
    return torch.einsum("ckm,cmr->ckr", w.float(), y.float()).to(y.dtype)


def mds_decode_cuda(w: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel; same contract as :func:`mds_decode_plain`."""
    global launches
    if w.ndim != 3 or y.ndim != 3:
        raise ValueError(f"need w (C, k, m) and y (C, m, r), got "
                         f"{tuple(w.shape)} and {tuple(y.shape)}")
    chunks, k, m = w.shape
    if y.shape[:2] != (chunks, m):
        raise ValueError(f"w {tuple(w.shape)} and y {tuple(y.shape)} do not match")
    if w.dtype != torch.float32 or y.dtype != torch.float32:
        raise TypeError(f"mds_decode takes float32, got {w.dtype}, {y.dtype}")
    if not (1 <= k <= MAX_KM and 1 <= m <= MAX_KM and 1 <= chunks <= 65535):
        raise ValueError(f"(C, k, m)=({chunks}, {k}, {m}) outside the kernel's limits")
    if not (w.is_contiguous() and y.is_contiguous()):
        raise ValueError("mds_decode needs contiguous w and y")
    lib = _build.library()
    r = y.shape[2]
    out = torch.empty((chunks, k, r), dtype=torch.float32, device=y.device)
    if r:
        err = lib.s2c2_mds_decode(w.data_ptr(), y.data_ptr(), out.data_ptr(),
                                  chunks, k, m, r, _build.stream_of(y))
        _build.check(err, "mds_decode")
        launches += 1
    return out
