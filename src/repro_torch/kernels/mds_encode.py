"""MDS encode: coded partitions from data blocks, C[w] = Σ_i G[w, i]·A[i].

Replaces ``src/repro/kernels/mds_encode.py::mds_encode_pallas``.  Encoding
happens once per matrix, but it is a full pass over it: the contraction
dim k is tiny (≤ 32) while rows×d is large, a streaming operation.

On Hopper the kernel (``csrc/mds_encode.cu``) is bound by device-memory
bytes: the k data planes are read once and the n coded planes written once.
The generator sits in shared memory; each thread holds four elements of all
k blocks in registers and writes those four elements of every coded plane,
accumulating in float32.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

__all__ = ["mds_encode_plain", "mds_encode_cuda", "MAX_N", "MAX_K"]

MAX_N, MAX_K = 64, 32           # kMaxN, kMaxK in csrc/mds_encode.cu
# kernel launches since the last reset (see ops.reset_launch_counts); changed
# under _build.COUNT_LOCK
launches = 0


def mds_encode_plain(g: torch.Tensor, blocks: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version (the JAX package's ``mds_encode_ref``).

    g: (n, k); blocks: (k, rows, d) -> (n, rows, d) in blocks' dtype,
    accumulated in float32.
    """
    return torch.einsum("nk,krd->nrd", g.float(), blocks.float()).to(blocks.dtype)


def mds_encode_cuda(g: torch.Tensor, blocks: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel; same contract as :func:`mds_encode_plain`.

    The generator is rounded to blocks' dtype first, as the TPU kernel does,
    then widened to float32 for the kernel.
    """
    global launches
    fn = _build.kernel("s2c2_mds_encode")
    if g.ndim != 2 or blocks.ndim < 2:
        raise ValueError(f"need g (n, k) and blocks (k, rows, ...), got "
                         f"{tuple(g.shape)} and {tuple(blocks.shape)}")
    n, k = g.shape
    if blocks.shape[0] != k:
        raise ValueError(f"g has k={k}, blocks has {blocks.shape[0]}")
    if not (1 <= n <= MAX_N and 1 <= k <= MAX_K):
        raise ValueError(f"(n, k)=({n}, {k}) outside the kernel's ({MAX_N}, {MAX_K})")
    if blocks.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"blocks must be float32 or bfloat16, got {blocks.dtype}")
    if not blocks.is_contiguous():
        raise ValueError("mds_encode needs contiguous blocks")
    g32 = g.to(blocks.dtype).to(torch.float32).contiguous()
    out = torch.empty((n,) + tuple(blocks.shape[1:]), dtype=blocks.dtype,
                      device=blocks.device)
    plane = blocks[0].numel()
    if plane:
        quad = 4 * blocks.element_size()
        vec = plane % 4 == 0 and blocks.data_ptr() % quad == 0 and out.data_ptr() % quad == 0
        sms = torch.cuda.get_device_properties(blocks.device).multi_processor_count
        err = fn(
            g32.data_ptr(), blocks.data_ptr(), out.data_ptr(), n, k, plane,
            _build.DTYPE_CODES[blocks.dtype], int(vec), sms, _build.stream_of(blocks))
        _build.check(err, "mds_encode")
        with _build.COUNT_LOCK:
            launches += 1
    return out
