"""Coded matrix–vector multiplication under S²C² on one CUDA device.

The n workers' coded partitions are the leading dimension of one
``(n, rows, d)`` tensor on the card (encode once — the paper's
zero-data-movement property), and every iteration applies a fresh S²C²
allocation:

  1. host: predicted speeds → ``general_allocation`` → (begin, count), and
     per-chunk decode weights from the sorted responders
     (``MDSCode.chunk_decode_weights_compact``, solved in float64, applied
     in float32);
  2. device: one ``coded_matvec`` launch over the ``(n·rows, d)`` view
     computes exactly the k·C assigned chunks — worker w's chunk
     ``(begin_w + j) mod C`` is global block ``w·C + (begin_w + j) mod C`` —
     so unassigned chunks are never read;
  3. device: one ``mds_decode`` launch reads each chunk's k partials where
     ``coded_matvec`` left them, through a (chunk, responder) position
     table, and writes the recovered data-block products straight into y
     in the original row order.

Both index tables reach the card in one pinned, non-blocking copy, so an
iteration's device work is that copy and two kernels.

**Across a worker mesh** (``mesh=``, a 1-D ``DeviceMesh`` of n ranks from
``launch.mesh.make_worker_mesh``; the JAX package's ``shard_map`` form):
rank w holds only its own coded partition (rows, d), encoded from
``G[w:w+1]`` with ``mds_encode`` one chunk of rows at a time, so that A
itself never has to sit on the device; ``apply`` launches
``coded_matvec`` over rank w's assigned chunks only, then combines across
the axis so that every rank holds all of y.  The combine is a gather, not
the JAX package's weighted ``psum``: each rank's partials, padded to C
chunks, are all-gathered, and every rank runs the same ``mds_decode_into``
launch as the single-device path over the (n·C, rpc) result.  That keeps
the hand-written decode on the path, and it moves the same k·rows floats
to each rank as the psum of the (C, k, rpc) contributions would.  Under
gloo, which has no all-gather of CUDA tensors, the gather is staged
through pinned host memory (:func:`_all_gather`); under NCCL it stays on
the device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from repro_torch._device import resolve_device
from repro_torch.core.coding import MDSCode, pad_rows
from repro_torch.core.s2c2 import Allocation
from repro_torch.kernels import ops
from repro_torch.kernels.coded_matvec import MAX_NVEC

__all__ = ["CodedMatvec", "coded_partition_shards", "masked_partial_products",
           "oracle_matvec"]


def coded_partition_shards(code: MDSCode, a: torch.Tensor) -> torch.Tensor:
    """Encode A into (n, D/k, d) stacked coded partitions, on a's device, once."""
    return code.encode(a)


def _chunk_mask(begin, count, chunks: int) -> torch.Tensor:
    idx = torch.arange(chunks)
    rel = (idx - int(begin)) % chunks
    return rel < int(count)


def masked_partial_products(coded: torch.Tensor, x: torch.Tensor, begin, count,
                            chunks: int) -> torch.Tensor:
    """Plain per-worker partial product with chunk masking (the reference).

    coded: (rows, d) this worker's partition; rows % chunks == 0.
    Returns (chunks, rows_per_chunk): y[c] = coded_chunk_c @ x if assigned
    else 0.  ``CodedMatvec.apply`` computes the assigned chunks only.
    """
    rows, d = coded.shape
    rpc = rows // chunks
    mask = _chunk_mask(begin, count, chunks).to(coded.device)
    y = (coded.reshape(chunks, rpc, d) @ x).reshape(chunks, rpc)
    return y * mask[:, None].to(y.dtype)


def _all_gather(local: torch.Tensor, group, stage: dict) -> torch.Tensor:
    """(n,) + local.shape: every rank's ``local``, in rank order, on
    local's device.

    gloo has no all-gather of CUDA tensors, so for a CUDA tensor under
    gloo (ranks that share one card) the collective runs on pinned host
    copies, made and read here in plain sight: a copy down, the gather, a
    copy up.  Any other backend gathers on the device."""
    n = dist.get_world_size(group)
    if local.is_cuda and dist.get_backend(group) == "gloo":
        key = (tuple(local.shape), local.dtype)
        if key not in stage:                   # the buffers of the last shape only
            stage.clear()
            stage[key] = (torch.empty(local.shape, dtype=local.dtype, pin_memory=True),
                          torch.empty((n,) + tuple(local.shape), dtype=local.dtype,
                                      pin_memory=True))
        down, up = stage[key]
        # synchronous: the partials are final, and the last call's copy up is done
        down.copy_(local)
        dist.all_gather(list(up.unbind(0)), down, group=group)
        return up.to(local.device, non_blocking=True)
    out = torch.empty((n,) + tuple(local.shape), dtype=local.dtype, device=local.device)
    dist.all_gather(list(out.unbind(0)), local, group=group)
    return out


@dataclasses.dataclass
class CodedMatvec:
    """(n, k)-MDS coded matvec with per-iteration S²C² planning, on one
    device or across a worker mesh.

    Usage::

        cm = CodedMatvec(code, chunks=C)           # device="cuda" by default
        coded = cm.shard(A)                        # encode once
        tables = cm.plan_tables(alloc)             # every iteration, host
        y = cm.apply(coded, x, *tables)            # every iteration, device

    With ``mesh=make_worker_mesh(n, axis)`` (one rank per worker; the mesh's
    device type must be ``device``'s) every rank makes the same calls:
    ``shard`` returns the rank's own partition (rows, d) and ``apply`` y,
    whole, on every rank.
    """

    code: MDSCode
    chunks: int
    device: str | torch.device = "cuda"
    mesh: object = None               # a 1-D torch.distributed DeviceMesh, or None
    axis: str = "workers"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self._stage: dict = {}
        if self.mesh is None:
            return
        names = tuple(self.mesh.mesh_dim_names or ())
        if self.axis not in names:
            raise ValueError(f"the mesh has no axis {self.axis!r} (it has {names})")
        size = self.mesh.size(names.index(self.axis))
        if size != self.code.n:
            raise ValueError(f"mesh axis {self.axis!r} has size {size} but code.n={self.code.n}")
        if self.mesh.device_type != self.device.type:
            raise ValueError(f"the mesh is on {self.mesh.device_type}, the partitions on "
                             f"{self.device}")

    @property
    def rank(self) -> int:
        """This process's worker on the mesh's axis."""
        return self.mesh.get_local_rank(self.axis)

    # -- data placement -----------------------------------------------------
    def shard(self, a: torch.Tensor) -> torch.Tensor:
        """Encode: (D, d) -> (n, rows, d) on the device, rows % chunks == 0;
        with a mesh, this rank's partition (rows, d) alone.

        A gets zero rows up to a multiple of k·C before the encode, as the
        cluster's ``CodedData`` pads, so that ``apply``'s y keeps A's row
        order with the padding at its end.  (The JAX package's
        ``CodedMatvec.shard`` pads each coded partition to a multiple of C
        instead, which puts padding between the data blocks' products in y.)
        With a mesh, ``a`` may stay on the host: each chunk's k row slabs
        are copied to the device and encoded by rank w's generator row
        ``G[w:w+1]``, one ``mds_encode`` launch a chunk.
        """
        if self.mesh is None:
            return self.code.encode(pad_rows(a.to(self.device), self.code.k * self.chunks))
        k, C = self.code.k, self.chunks
        total, d = a.shape
        rows = -(-total // (k * C)) * C                    # a partition's rows, padded
        rpc = rows // C
        g = torch.as_tensor(self.code.generator[self.rank:self.rank + 1]).to(
            device=self.device, dtype=a.dtype)
        part = torch.empty((rows, d), dtype=a.dtype, device=self.device)
        slab = torch.empty((k, rpc, d), dtype=a.dtype, device=self.device)
        for r0 in range(0, rows, rpc):
            for i in range(k):                             # data block i's rows r0 .. r0 + rpc
                lo = min(i * rows + r0, total)
                hi = min(i * rows + r0 + rpc, total)
                slab[i, :hi - lo].copy_(a[lo:hi])
                slab[i, hi - lo:].zero_()
            part[r0:r0 + rpc].copy_(ops.mds_encode(g, slab)[0])
        return part

    # -- planning (host) ----------------------------------------------------
    def plan_tables(self, alloc: Allocation):
        """Allocation → (begin, count, weights, responders).

        begin, count: (n,) int64 on the host; responders: (chunks, k) int64
        on the host, each row the chunk's k responders in ascending order;
        weights: (chunks, k, k) float32 on the device, the decode matrix
        of each chunk's responders, solved in float64.
        """
        if alloc.n != self.code.n or alloc.k != self.code.k or alloc.chunks != self.chunks:
            raise ValueError(f"allocation (n={alloc.n}, k={alloc.k}, C={alloc.chunks}) does "
                             f"not match the code (n={self.code.n}, k={self.code.k}, "
                             f"C={self.chunks})")
        dms, ids = self.code.chunk_decode_weights_compact(alloc.masks().T)
        weights = torch.as_tensor(dms, dtype=torch.float32).to(self.device)
        return (torch.as_tensor(alloc.begin, dtype=torch.int64),
                torch.as_tensor(alloc.count, dtype=torch.int64),
                weights, torch.as_tensor(ids, dtype=torch.int64))

    def _index_tables(self, begin: np.ndarray, count: np.ndarray,
                      responders: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Global block ids of the assigned chunks, worker-major, and for each
        (chunk, responder) the position of its partial among them."""
        C = self.chunks
        n = begin.shape[0]
        if (count < 0).any() or (count > C).any():
            raise ValueError("per-worker count out of range [0, C]")
        offset = np.cumsum(count) - count                  # first slot of worker w
        worker = np.repeat(np.arange(n), count)            # the worker of each slot
        slot = np.arange(worker.shape[0]) - offset[worker]
        block_ids = worker * C + (begin[worker] + slot) % C
        chunk = np.arange(C)[:, None]
        rel = (chunk - begin[responders]) % C              # (C, k)
        if (rel >= count[responders]).any():
            c = int(np.argwhere(rel >= count[responders])[0, 0])
            raise ValueError(f"a responder of chunk {c} was not assigned that chunk")
        return block_ids, offset[responders] + rel

    def device_tables(self, begin, count, responders,
                      device: str | torch.device) -> tuple[torch.Tensor, torch.Tensor]:
        """:meth:`apply`'s index tables on ``device``, from :meth:`plan_tables`'
        ``begin``, ``count`` and ``responders``: the assigned blocks' global
        ids (nb,), for ``coded_matvec``, and each (chunk, responder)'s
        position among them (chunks, k), for ``mds_decode_into``.  Both are
        int32 views of one buffer, copied from pinned memory without a wait."""
        C, k, device = self.chunks, self.code.k, torch.device(device)
        block_ids, gather = self._index_tables(
            np.asarray(begin, dtype=np.int64), np.asarray(count, dtype=np.int64),
            np.asarray(responders, dtype=np.int64))
        nb = block_ids.shape[0]
        host = torch.empty(nb + C * k, dtype=torch.int32, pin_memory=device.type == "cuda")
        host_np = host.numpy()
        host_np[:nb] = block_ids
        host_np[nb:] = gather.ravel()
        tables = host.to(device, non_blocking=True)
        return tables[:nb], tables[nb:].view(C, k)

    # -- apply (device) -------------------------------------------------------
    def apply(self, coded: torch.Tensor, x: torch.Tensor, begin, count,
              weights: torch.Tensor, responders) -> torch.Tensor:
        """Compute A @ x from the coded partitions under an S²C² allocation.

        coded: (n, rows, d) from :meth:`shard`; x: (d,) or (d, B); the other
        arguments are :meth:`plan_tables`' output.  Returns y: (k·rows,) or
        (k·rows, B), A @ x in A's row order followed by the padding's zeros,
        in x's dtype.  An x of more than ``MAX_NVEC`` columns is computed in
        column groups of at most ``MAX_NVEC``, one ``coded_matvec`` launch
        each, as the cluster's ``KernelBackend`` does; the decode is one
        launch whatever B.
        """
        if self.mesh is not None:
            return self._apply_mesh(coded, x, begin, count, weights, responders)
        n, rows, d = coded.shape
        _check_x(x, d)
        C, k = self.chunks, self.code.k
        rpc = rows // C
        ids, gather = self.device_tables(begin, count, responders, coded.device)
        nb = ids.shape[0]
        parts = _partials(coded.view(n * rows, d), x, ids, rpc)
        return self._decode(weights, parts.reshape(nb, -1), gather, x, rows)

    def _decode(self, weights: torch.Tensor, parts: torch.Tensor, gather: torch.Tensor,
                x: torch.Tensor, rows: int) -> torch.Tensor:
        """y (k·rows[, B]) from the partials (P, rpc·B) by one ``mds_decode``
        launch; ``gather`` (C, k) holds each (chunk, responder)'s row of
        ``parts``."""
        C, k = self.chunks, self.code.k
        cols = 1 if x.ndim == 1 else x.shape[1]
        y = torch.empty((k * rows,) + tuple(x.shape[1:]), dtype=torch.float32, device=x.device)
        # data block i, chunk c, row r (and column b)  ->  position
        # (i·rows + c·rpc + r)·B + b: each chunk's rpc·B values are contiguous
        ops.mds_decode_into(weights, parts.float(), gather,
                            y.view(k, C, (rows // C) * cols).transpose(0, 1))
        return y.to(x.dtype)

    def _apply_mesh(self, part: torch.Tensor, x: torch.Tensor, begin, count,
                    weights: torch.Tensor, responders) -> torch.Tensor:
        """:meth:`apply` on rank w: its assigned chunks, the gather, the decode."""
        rows, d = part.shape
        _check_x(x, d)
        C, w = self.chunks, self.rank
        rpc = rows // C
        begin = np.asarray(begin, dtype=np.int64)
        count = np.asarray(count, dtype=np.int64)
        responders = np.asarray(responders, dtype=np.int64)
        self._index_tables(begin, count, responders)       # validates the allocation
        mine = int(count[w])
        # worker u's j-th assigned chunk is (begin_u + j) mod C, and it sits
        # at row u·C + j of the gathered partials
        rel = (np.arange(C)[:, None] - begin[responders]) % C
        host = torch.empty(mine + C * self.code.k, dtype=torch.int32,
                           pin_memory=part.is_cuda)
        host_np = host.numpy()
        host_np[:mine] = (begin[w] + np.arange(mine)) % C
        host_np[mine:] = (responders * C + rel).ravel()
        tables = host.to(part.device, non_blocking=True)
        local = torch.zeros((C, rpc) + tuple(x.shape[1:]), dtype=torch.float32,
                            device=part.device)
        if mine:
            local[:mine] = _partials(part, x, tables[:mine], rpc)
        gathered = _all_gather(local, self.mesh.get_group(self.axis), self._stage)
        return self._decode(weights, gathered.view(self.code.n * C, -1),
                            tables[mine:].view(C, self.code.k), x, rows)


def _check_x(x: torch.Tensor, d: int) -> None:
    if not (x.ndim in (1, 2) and x.shape[0] == d):
        raise ValueError(f"x must have shape ({d},) or ({d}, B), got {tuple(x.shape)}")


def _partials(view: torch.Tensor, x: torch.Tensor, ids: torch.Tensor, rpc: int) -> torch.Tensor:
    """The blocks ``ids`` of ``view`` (rows, d) times x: (nb, rpc[, B]), one
    ``coded_matvec`` launch per column group of at most ``MAX_NVEC``."""
    if x.ndim == 1:
        return ops.coded_matvec(view, x, ids, rpc)
    groups = [ops.coded_matvec(view, x[:, c:c + MAX_NVEC].contiguous(), ids, rpc)
              for c in range(0, x.shape[1], MAX_NVEC)]
    return groups[0] if len(groups) == 1 else torch.cat(groups, dim=2)


def oracle_matvec(a: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Float64 product on the host, the exact reference of the tests."""
    return np.asarray(a, np.float64) @ np.asarray(x, np.float64)
