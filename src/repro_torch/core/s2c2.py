"""S²C² workload allocation — Algorithm 1 of the paper plus the basic variant.

Terminology (matches the paper):

* Each worker stores ONE coded partition of the data (``(n, k)``-MDS coded).
* Every partition is *over-decomposed* into ``C = chunks_per_partition``
  equal chunks of rows.  Chunk index ``c`` of worker ``w`` is the coded
  combination of chunk ``c`` of all k data blocks, so the master can decode
  chunk ``c`` from ANY k workers that computed their chunk ``c``.
* An *allocation* assigns each worker a cyclic range of chunk indices
  ``[begin, begin + count) mod C``.  Decodability requires every chunk
  index to be covered by ≥ k workers; the cyclic end-to-start placement of
  Algorithm 1 covers every index exactly k times when
  ``Σ count_w = k·C`` and every ``count_w ≤ C``.

The allocator is implemented twice:

* :func:`general_allocation` — exact integer host-side version (numpy),
  used by the coded matvec's planner.
* :func:`general_allocation_torch` — fixed-shape tensor version that runs
  on the speeds' device, for a schedule that must stay on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

__all__ = [
    "Allocation",
    "basic_allocation",
    "general_allocation",
    "general_allocation_torch",
    "allocation_masks",
    "coverage_counts",
    "expected_makespan",
]


@dataclasses.dataclass(frozen=True)
class Allocation:
    """A cyclic chunk-range allocation for n workers over C chunk indices."""

    n: int
    k: int
    chunks: int                     # C — chunk indices per partition
    begin: np.ndarray               # (n,) int — first chunk index per worker
    count: np.ndarray               # (n,) int — number of chunks per worker

    def masks(self) -> np.ndarray:
        """(n, C) bool — worker w computes chunk c."""
        return allocation_masks(self.begin, self.count, self.chunks)

    def coverage(self) -> np.ndarray:
        """(C,) int — how many workers compute each chunk index."""
        return self.masks().sum(axis=0)

    def validate(self) -> None:
        cov = self.coverage()
        if (cov < self.k).any():
            bad = int(np.argmin(cov))
            raise ValueError(
                f"chunk {bad} covered {int(cov[bad])} < k={self.k}: undecodable")
        if (self.count < 0).any() or (self.count > self.chunks).any():
            raise ValueError("per-worker count out of range [0, C]")

    def work_fraction(self) -> np.ndarray:
        """(n,) — fraction of its stored partition each worker computes."""
        return self.count / float(self.chunks)


def allocation_masks(begin: np.ndarray, count: np.ndarray, chunks: int) -> np.ndarray:
    """Expand cyclic ranges into boolean masks, shape (n, chunks)."""
    begin = np.asarray(begin)
    count = np.asarray(count)
    idx = np.arange(chunks)[None, :]                     # (1, C)
    rel = (idx - begin[:, None]) % chunks                # position within cycle
    return rel < count[:, None]


def coverage_counts(alloc: Allocation) -> np.ndarray:
    return alloc.coverage()


# ---------------------------------------------------------------------------
# Basic S²C² — straggler count only (§4.1)
# ---------------------------------------------------------------------------

def basic_allocation(n: int, k: int, chunks: int,
                     stragglers: Sequence[int] = ()) -> Allocation:
    """Equal allocation among non-stragglers, zero to stragglers.

    With s = n - len(stragglers) live workers, each live worker computes
    ceil(k·C / s) chunks — i.e. the (n, s)-MDS workload D/s — assigned as
    cyclic ranges placed end-to-start so that every chunk index is covered
    ≥ k times.
    """
    stragglers = set(int(x) for x in stragglers)
    live = [w for w in range(n) if w not in stragglers]
    s = len(live)
    if s < k:
        raise ValueError(f"only {s} live workers < k={k}: cannot decode")
    total = k * chunks
    base, extra = divmod(total, s)
    count = np.zeros(n, dtype=np.int64)
    for i, w in enumerate(live):
        count[w] = base + (1 if i < extra else 0)
    if (count > chunks).any():
        raise ValueError("allocation exceeds partition size; increase chunks or k")
    begin = np.zeros(n, dtype=np.int64)
    pos = 0
    for w in live:
        begin[w] = pos
        pos = (pos + count[w]) % chunks
    alloc = Allocation(n=n, k=k, chunks=chunks, begin=begin, count=count)
    alloc.validate()
    return alloc


# ---------------------------------------------------------------------------
# General S²C² — Algorithm 1 (§4.2)
# ---------------------------------------------------------------------------

def _proportional_counts(speeds: np.ndarray, total: int, cap: int) -> np.ndarray:
    """Speed-proportional integer allocation with per-worker cap.

    Implements the paper's descending-speed loop: each worker gets
    ``u_i / Σ_{j>=i} u_j`` of the remaining chunks, capped at the partition
    size; the spill-over flows to the next (slower) worker.  Exact integer
    arithmetic via floor + largest-remainder on the final pass.
    """
    n = speeds.shape[0]
    order = np.argsort(-speeds, kind="stable")
    counts = np.zeros(n, dtype=np.int64)
    remaining = int(total)
    speed_left = float(speeds[order].sum())
    for w in order:
        if remaining <= 0 or speed_left <= 0:
            break
        share = remaining * (float(speeds[w]) / speed_left)
        take = min(cap, int(np.floor(share + 1e-9)))
        counts[w] = take
        remaining -= take
        speed_left -= float(speeds[w])
    # Distribute any remainder (from flooring / caps) to the fastest workers
    # that still have headroom — this preserves Σ counts == total.  Workers
    # with zero speed never receive work (they could not finish it).
    if remaining > 0:
        for w in order:
            if speeds[w] <= 0:
                continue
            room = cap - counts[w]
            if room <= 0:
                continue
            add = min(room, remaining)
            counts[w] += add
            remaining -= add
            if remaining == 0:
                break
    if remaining > 0:
        live = int((speeds > 0).sum())
        raise ValueError(
            f"infeasible allocation: total={total} > live capacity "
            f"{live}*{cap}={live * cap} ({n - live} of {n} workers have "
            "zero speed; need more live workers, lower k, or more chunks)")
    return counts


def general_allocation(speeds: Sequence[float], k: int, chunks: int,
                       min_speed: float = 1e-6) -> Allocation:
    """Algorithm 1: speed-proportional cyclic allocation.

    speeds: predicted speeds u_i (arbitrary positive units).  Workers whose
    speed is below ``min_speed`` of the max are treated as full stragglers
    (zero allocation) provided enough capacity remains.
    """
    u = np.asarray(speeds, dtype=np.float64).copy()
    n = u.shape[0]
    if n < k:
        raise ValueError(f"n={n} < k={k}")
    u = np.maximum(u, 0.0)
    if u.max() <= 0:
        raise ValueError("all speeds are zero")
    u[u < min_speed * u.max()] = 0.0
    total = k * chunks
    counts = _proportional_counts(u, total, cap=chunks)
    # Cyclic end-to-start placement in descending-speed order: the union of
    # ranges walks the chunk circle exactly k times -> every index covered
    # exactly k times (the paper's decodability argument).
    order = np.argsort(-u, kind="stable")
    begin = np.zeros(n, dtype=np.int64)
    pos = 0
    for w in order:
        begin[w] = pos
        pos = (pos + counts[w]) % chunks
    alloc = Allocation(n=n, k=k, chunks=chunks, begin=begin, count=counts)
    alloc.validate()
    return alloc


# ---------------------------------------------------------------------------
# Tensor (device-side) variant — fixed shapes, no data-dependent control flow
# ---------------------------------------------------------------------------

def general_allocation_torch(speeds: torch.Tensor, k: int, chunks: int):
    """Device-side Algorithm 1 producing (begin, count) int32 tensors.

    Runs on ``speeds``' device without a host sync.  It differs from the
    host version in the remainder policy: the leftover goes in one
    deterministic pass to the fastest workers with headroom, which keeps
    Σcount == k·C.  The float32 arithmetic is that of the JAX package's
    ``general_allocation_jax`` as XLA compiles it (a sequential suffix sum,
    and the share as one fused multiply-add), so both give the same integers.
    """
    n = speeds.shape[0]
    total = k * chunks
    u = torch.clamp(speeds.to(torch.float32), min=0.0)
    order = torch.argsort(-u, stable=True)                # descending
    u_sorted = u[order]
    # suffix sums Σ_{j>=i} u_j, accumulated from the slowest worker upwards
    suffix = torch.empty_like(u_sorted)
    acc = torch.zeros((), dtype=torch.float32, device=u.device)
    for i in range(n - 1, -1, -1):
        acc = acc + u_sorted[i]
        suffix[i] = acc
    suffix = torch.clamp(suffix, min=1e-20)

    # XLA contracts ``remaining * ratio + 1e-6`` into one fused multiply-add;
    # the product of two float32 values is exact in float64, so rounding the
    # float64 sum once to float32 gives the same share
    eps = torch.tensor(1e-6, dtype=torch.float32).double()
    remaining = torch.tensor(total, dtype=torch.int32, device=u.device)
    takes = []
    for i in range(n):
        ratio = u_sorted[i] / suffix[i]
        share = (remaining.double() * ratio.double() + eps).float()
        take = torch.clamp(torch.floor(share).to(torch.int32), max=chunks)
        take = torch.minimum(take, remaining)
        remaining = remaining - take
        takes.append(take)
    counts_sorted = torch.stack(takes)
    # hand the leftover to the fastest workers with headroom in one wave
    headroom = chunks - counts_sorted
    cum_head = torch.cumsum(headroom, 0, dtype=torch.int32)
    prev_head = cum_head - headroom
    add = torch.minimum(torch.clamp(remaining - prev_head, min=0), headroom)
    counts_sorted = counts_sorted + add
    # cyclic placement
    ends = torch.cumsum(counts_sorted, 0, dtype=torch.int32)
    begins_sorted = torch.cat([ends.new_zeros(1), ends[:-1]]) % chunks
    inv = torch.empty_like(order)
    inv[order] = torch.arange(n, device=u.device)
    return begins_sorted[inv].to(torch.int32), counts_sorted[inv].to(torch.int32)


# ---------------------------------------------------------------------------
# Planning helpers
# ---------------------------------------------------------------------------

def expected_makespan(alloc: Allocation, speeds: Sequence[float],
                      rows_per_chunk: int, row_cost: float = 1.0) -> float:
    """Predicted completion time of an allocation under given true speeds."""
    u = np.asarray(speeds, dtype=np.float64)
    t = np.where(alloc.count > 0,
                 alloc.count * rows_per_chunk * row_cost / np.maximum(u, 1e-12),
                 0.0)
    return float(t.max())
