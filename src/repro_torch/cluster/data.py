"""Tenant data plane: how a job's matrix lives on the cluster.

Two layouts, matching the two families of strategies:

* :class:`CodedData` — the matrix is padded, split row-wise into ``k``
  blocks, MDS-encoded into ``n`` coded partitions (one per worker), and
  each partition is over-decomposed into ``C`` chunks of ``rows_per_chunk``
  rows.  Chunk index ``c`` is decodable from ANY ``k`` workers' chunk-``c``
  results (the S²C² invariant) — used by MDSCoded / BasicS2C2 /
  GeneralS2C2.
* :class:`ReplicatedData` — uncoded ``D/n`` partitions, each placed on
  ``r`` distinct workers (primary first) — used by UncodedReplication's
  speculative re-execution.

Encoding runs in float64 on the host (it happens once per tenant; the
paper's one-time setup cost) and installs one shard per worker under the
tenant's shard id, so one engine serves many jobs concurrently.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch._device import device_guard, resolve_device
from repro_torch.core.coding import MDSCode
from repro_torch.kernels import ops

__all__ = ["CodedData", "ReplicatedData", "replica_placement"]


def replica_placement(n: int, replication: int = 3,
                      seed: int = 0) -> np.ndarray:
    """(n, r) placement: partition p primary on worker p (matching the
    simulator's convention), replicas on distinct random other workers."""
    rng = np.random.default_rng(seed)
    rows = []
    for p in range(n):
        others = [w for w in range(n) if w != p]
        extra = rng.choice(others, size=max(replication - 1, 0),
                           replace=False)
        rows.append([p, *extra.tolist()])
    return np.asarray(rows, dtype=np.int64)


def _pad_rows(a: np.ndarray, multiple: int) -> np.ndarray:
    rem = (-a.shape[0]) % multiple
    if rem == 0:
        return a
    return np.concatenate([a, np.zeros((rem,) + a.shape[1:], a.dtype)], axis=0)


def _kernel_decode(dms: np.ndarray, y2: np.ndarray, out: np.ndarray,
                   dev: torch.device) -> None:
    """out[i, c] = Σ_j dms[c, i, j] · y2[c, j] through ``mds_decode`` on ``dev``.

    dms: (C, k, k); y2: (C, k, cols); out: the host's block-major (k, C,
    cols) float64 buffer.  The kernel reads the partials as C·k rows through
    the identity position table and writes the chunk-major view of a
    block-major device buffer, so the result comes back in one copy.
    """
    C, k, cols = y2.shape
    w = torch.from_numpy(np.ascontiguousarray(dms, dtype=np.float32)).to(dev)
    parts = torch.from_numpy(
        np.ascontiguousarray(y2, dtype=np.float32).reshape(C * k, cols)).to(dev)
    with device_guard(dev):
        table = torch.arange(C * k, dtype=torch.int32, device=dev).view(C, k)
        buf = torch.empty((k, C, cols), dtype=torch.float32, device=dev)
        ops.mds_decode_into(w, parts, table, buf.transpose(0, 1))
        out[...] = buf.cpu().numpy()


@dataclasses.dataclass
class CodedData:
    """An (n, k)-MDS encoded, chunk-decomposed tenant matrix."""

    shard_id: str
    code: MDSCode
    chunks: int                    # C — chunk indices per partition
    rows_per_chunk: int
    orig_rows: int                 # rows of the un-padded matrix
    partitions: List[np.ndarray]   # (n,) worker shards, each (C·rpc, d)

    @classmethod
    def encode(cls, shard_id: str, a: np.ndarray, code: MDSCode,
               chunks: int) -> "CodedData":
        a = np.asarray(a, dtype=np.float64)
        orig_rows = a.shape[0]
        a = _pad_rows(a, code.k * chunks)
        blocks = a.reshape(code.k, -1, *a.shape[1:])        # (k, D/k, d)
        coded = np.einsum("nk,kr...->nr...", code.generator, blocks)
        rows_per_part = coded.shape[1]
        return cls(shard_id=shard_id, code=code, chunks=chunks,
                   rows_per_chunk=rows_per_part // chunks,
                   orig_rows=orig_rows,
                   partitions=[np.ascontiguousarray(coded[w])
                               for w in range(code.n)])

    @property
    def n(self) -> int:
        return self.code.n

    @property
    def k(self) -> int:
        return self.code.k

    def chunk_range(self, chunk_id: int) -> Tuple[int, int]:
        r0 = chunk_id * self.rows_per_chunk
        return r0, r0 + self.rows_per_chunk

    def gather_used(self, used: Sequence[Sequence[int]],
                    partials: Dict[Tuple[int, int], np.ndarray]
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """Compact (ids, y_parts) gather of exactly-k per-chunk coverage.

        used: per chunk, the k workers whose results were collected;
        partials: (worker, chunk) -> that worker's chunk result — a
        ``(rpc,)`` vector for matvec rounds or a ``(rpc, B)`` block for
        multi-RHS rounds; ``y_parts`` comes back ``(C, k, rpc)`` or
        ``(C, k, rpc, B)`` to match.

        Responders are SORTED per chunk, which makes the downstream decode
        a pure function of each chunk's coverage *set* — the order workers
        happened to finish (or whether a chunk was stolen mid-round) can
        never change the decoded bits.
        """
        C, k = self.chunks, self.k
        probe = partials[(used[0][0], 0)]
        ids = np.empty((C, k), dtype=np.int64)
        y_parts = np.empty((C, k) + probe.shape, dtype=np.float64)
        for c in range(C):
            row = sorted(used[c])
            ids[c] = row
            for j, w in enumerate(row):
                y_parts[c, j] = partials[(w, c)]
        return ids, y_parts

    def decode(self, coverage: np.ndarray, partials: np.ndarray,
               use_cache: bool = True,
               use_kernel: bool = False,
               device: "str | torch.device" = "cuda") -> np.ndarray:
        """Decode a full round from per-chunk any-k coverage.

        coverage: (C, n) bool — exactly the k used workers per chunk.
        partials: (n, C, rpc) — or (n, C, rpc, B) for multi-RHS rounds —
        chunk results (zeros where unused).
        Returns the decoded product of the ORIGINAL matrix:
        (orig_rows,) or (orig_rows, B).  ``use_kernel`` and ``device`` are
        as in :meth:`decode_compact`.
        """
        dms, ids = self.code.chunk_decode_weights_compact(
            coverage, use_cache=use_cache)
        # gather only the k used rows per chunk: (C, k, rpc)
        y = partials[ids, np.arange(self.chunks)[:, None], :]
        return self.decode_compact(dms, y, use_kernel=use_kernel, device=device)

    def decode_compact(self, dms: np.ndarray, y: np.ndarray,
                       out: Optional[np.ndarray] = None,
                       use_kernel: bool = False,
                       device: "str | torch.device" = "cuda") -> np.ndarray:
        """Hot-path decode: one batched (C, k, k) @ (C, k, ·) contraction.

        dms: per-chunk decode submatrices (from ``decode_submats`` /
        ``chunk_decode_weights_compact``); y: the matching gathered
        partials — ``(C, k, rpc)`` for a matvec round or ``(C, k, rpc, B)``
        for a multi-RHS round.  One coverage pattern's decode weights
        apply to ALL B columns in a single contraction (the rpc and B axes
        fuse into one RHS axis), so the per-round decode cost amortizes
        ~B× across the batched requests.  The result is assembled straight
        into a preallocated block-major output buffer (``out`` may be
        supplied to reuse one across rounds) and returned as
        ``(orig_rows,)`` or ``(orig_rows, B)``.  ``use_kernel=True`` routes
        the contraction through the port's ``mds_decode`` kernel on
        ``device`` in float32: ``dms`` and the partials go up once, one
        launch decodes every chunk straight into a block-major
        ``(k, C, cols)`` buffer on the device, and that buffer comes back
        once (``device="cpu"`` runs the kernel's plain version).  It is an
        explicit opt-in because it trades the default float64 precision
        for kernel throughput; the default is batched float64 BLAS on the
        host, so results never vary silently by host.
        """
        C, k, rpc = y.shape[:3]
        width = y.shape[3] if y.ndim == 4 else None
        cols = rpc if width is None else rpc * width
        if out is None:
            out = np.empty(k * C * cols, dtype=np.float64)
        # block-major view: out[block i][chunk c] — matmul writes into the
        # strided view directly, no per-chunk stacking or transpose copy.
        # For multi-RHS y the (rpc, B) tail flattens row-major, so the same
        # strided view lands each element exactly where the final
        # (k·C·rpc, B) reshape expects it.
        view = out.reshape(k, C, cols).transpose(1, 0, 2)
        y2 = y.reshape(C, k, cols)
        if use_kernel:
            _kernel_decode(dms, y2, out.reshape(k, C, cols), resolve_device(device))
        else:
            np.matmul(dms, y2, out=view)
        if width is None:
            return out[: self.orig_rows]
        return out.reshape(k * C * rpc, width)[: self.orig_rows]


@dataclasses.dataclass
class ReplicatedData:
    """Uncoded D/n partitions with r-fold replication (primary = first)."""

    shard_id: str
    n: int
    rows_per_part: int
    orig_rows: int
    placement: np.ndarray          # (n_parts, r) worker ids, primary first
    partitions: List[np.ndarray]   # (n_parts,) arrays of (rows_per_part, d)

    @classmethod
    def partition(cls, shard_id: str, a: np.ndarray, n: int,
                  placement: np.ndarray) -> "ReplicatedData":
        a = np.asarray(a, dtype=np.float64)
        orig_rows = a.shape[0]
        a = _pad_rows(a, n)
        rpp = a.shape[0] // n
        parts = [np.ascontiguousarray(a[p * rpp:(p + 1) * rpp])
                 for p in range(n)]
        return cls(shard_id=shard_id, n=n, rows_per_part=rpp,
                   orig_rows=orig_rows, placement=np.asarray(placement),
                   partitions=parts)

    def part_shard_id(self, p: int) -> str:
        return f"{self.shard_id}/p{p}"

    def assemble(self, results: List[Optional[np.ndarray]]) -> np.ndarray:
        out = np.concatenate(results, axis=0)
        return out[: self.orig_rows]
