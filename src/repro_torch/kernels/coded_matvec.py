"""Slack-squeeze coded product: out[i] = A[ids[i]·br:(ids[i]+1)·br] @ x.

Replaces ``src/repro/kernels/coded_matvec.py::coded_matvec_pallas``.  The
S²C² scheduler assigns each worker a subset of the row-blocks of its coded
partition; only those blocks are read, so the cost scales with the work
assigned.

On Hopper the kernel (``csrc/coded_matvec.cu``) is bound by device-memory
bytes: at ``nvec = 1`` each element read feeds one multiply-add.  It reads
each assigned row once with 16-byte loads, one warp per row, accumulating in
float32; each block reads its row-block id itself (the TPU kernel's scalar
prefetch) and walks the contraction dim in a loop (the TPU's sequential
d-tile axis).  Unlike the TPU wrapper, nothing is padded: no d tile, and no
128 lanes of ``nvec`` for a single vector.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

__all__ = ["coded_matvec_plain", "coded_matvec_cuda", "MAX_NVEC"]

MAX_NVEC = 16
_ROWS_PER_LAUNCH_BLOCK = 64      # kRowsPerBlock in csrc/coded_matvec.cu
launches = 0        # kernel launches since the last reset (see ops.reset_launch_counts)


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


def coded_matvec_cuda(a: torch.Tensor, x: torch.Tensor, block_ids: torch.Tensor,
                      block_rows: int) -> torch.Tensor:
    """Launch the CUDA kernel; same contract as :func:`coded_matvec_plain`."""
    global launches
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
    nb = block_ids.shape[0]
    tiles = -(-block_rows // _ROWS_PER_LAUNCH_BLOCK)
    if nb * tiles >= 2**31:
        raise ValueError(f"{nb} blocks of {block_rows} rows exceed one launch's grid")
    lib = _build.library()
    out = torch.empty((nb, block_rows, nvec), dtype=a.dtype, device=a.device)
    if nb:
        packet = 16 // a.element_size()
        vec = (d % packet == 0 and a.data_ptr() % 16 == 0 and x2.data_ptr() % 16 == 0)
        err = lib.s2c2_coded_matvec(
            a.data_ptr(), x2.data_ptr(), block_ids.data_ptr(), out.data_ptr(),
            rows // block_rows, nb, block_rows, d, nvec, _build.DTYPE_CODES[a.dtype],
            int(vec), _build.stream_of(a))
        _build.check(err, "coded_matvec")
        launches += 1
    return out[:, :, 0] if squeeze else out
