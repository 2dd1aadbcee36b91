"""Workload-distribution strategies evaluated in the paper.

Each strategy distributes one iteration of a D-row matrix-vector product
over ``n`` workers and defines how the master collects results:

* :class:`UncodedReplication` — Hadoop/LATE-like: uncoded D/n partitions,
  r-fold replication, reactive speculative re-execution (§6.6 baseline 1).
* :class:`MDSCoded` — conventional (n, k)-MDS: every worker computes its
  full D/k coded partition; master uses the fastest k (§6.6 baseline 2).
* :class:`OverDecomposition` — Charm++-inspired uncoded over-decomposition
  with speed-predicted load balancing and runtime chunk migration (§7.2.1).
* :class:`BasicS2C2` — S²C² with straggler-count-only information (§4.1).
* :class:`GeneralS2C2` — Algorithm 1: speed-proportional cyclic allocation
  with the §4.3 timeout/reassign mis-prediction handling.

Latency semantics live in :mod:`repro_torch.core.simulation`; the *policies* here
are the production implementations (same code drives the shard_map runtime).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.s2c2 import (Allocation, allocation_masks, basic_allocation,
                                   expected_makespan, general_allocation)
from repro_torch.core.simulation import CostModel, IterationResult

__all__ = [
    "UncodedReplication", "MDSCoded", "OverDecomposition",
    "BasicS2C2", "GeneralS2C2",
]


# ---------------------------------------------------------------------------
# Uncoded replication with speculative execution (LATE-like)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class UncodedReplication:
    """r-replicated uncoded strategy with speculative re-execution.

    Data: D rows split into n partitions of D/n rows; each partition has r
    copies placed on distinct random workers (primary = first).  The master
    monitors progress; once ``detect_fraction`` of tasks finish it
    speculatively relaunches every unfinished task on the fastest finished
    worker holding a replica (restart-from-scratch, Hadoop semantics) or —
    if no replica holder is available — moves the partition to the fastest
    idle worker, paying the transfer time (§3.1's "data transfer time in
    the critical path").  Up to ``max_speculative`` relaunches (paper: 6).
    """

    n: int
    total_rows: int
    replication: int = 3
    detect_fraction: float = 0.75
    max_speculative: int = 6
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.placement = np.stack([
            rng.choice(self.n, size=self.replication, replace=False)
            for _ in range(self.n)])          # partition p -> worker ids
        self.rows_per_part = self.total_rows // self.n

    def plan(self, pred_speeds: Optional[np.ndarray]):
        return None  # reactive strategy: no use of predictions

    def execute(self, plan, speeds: np.ndarray, cost: CostModel,
                rng: np.random.Generator) -> IterationResult:
        n, rp = self.n, self.rows_per_part
        prim_t = np.array([cost.compute_time(rp, speeds[p]) for p in range(n)])
        t_detect = np.quantile(prim_t, self.detect_fraction)
        finish = prim_t.copy()
        wasted = np.zeros(n)
        useful = np.full(n, float(rp))
        moved_rows = 0.0
        # Workers whose primary task finished by t_detect are idle candidates.
        idle = [w for w in range(n) if prim_t[w] <= t_detect]
        idle.sort(key=lambda w: -speeds[w])
        slow_parts = [p for p in range(n) if prim_t[p] > t_detect]
        slow_parts.sort(key=lambda p: -prim_t[p])
        spec_budget = self.max_speculative
        for p in slow_parts:
            if spec_budget == 0 or not idle:
                break
            # prefer an idle replica holder
            holders = [w for w in self.placement[p] if w in idle]
            if holders:
                w = holders[0]
                xfer = 0.0
            else:
                w = idle[0]
                xfer = cost.transfer_time(rp)
                moved_rows += rp
            idle.remove(w)
            spec_budget -= 1
            t_new = t_detect + xfer + cost.compute_time(rp, speeds[w])
            if t_new < finish[p]:
                # original attempt killed -> its partial work wasted
                done_rows = min(rp, speeds[p] * t_new / cost.row_cost)
                wasted[p] += done_rows
                useful[p] -= rp
                useful[w] += rp
                finish[p] = t_new
            else:
                # speculation lost the race -> speculative work wasted
                done_rows = min(rp, speeds[w] * max(finish[p] - t_detect - xfer, 0)
                                / cost.row_cost)
                wasted[w] += done_rows
        compute = float(finish.max())
        comm = cost.vector_bcast_time(n) + cost.collect_time(self.total_rows)
        post = cost.postprocess_time(self.total_rows)
        return IterationResult(makespan=compute + comm + post,
                               compute_time=compute, comm_time=comm,
                               post_time=post, useful_rows=useful,
                               wasted_rows=wasted, data_moved_rows=moved_rows)


# ---------------------------------------------------------------------------
# Conventional (n, k)-MDS coded computation
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MDSCoded:
    """Every worker computes its whole D/k coded partition; fastest k used."""

    n: int
    k: int
    total_rows: int

    def __post_init__(self):
        self.rows_per_part = -(-self.total_rows // self.k)  # ceil

    def plan(self, pred_speeds: Optional[np.ndarray]):
        return None  # static workload, predictions unused

    def execute(self, plan, speeds: np.ndarray, cost: CostModel,
                rng: np.random.Generator) -> IterationResult:
        n, rp = self.n, self.rows_per_part
        t = np.array([cost.compute_time(rp, speeds[w]) for w in range(n)])
        order = np.argsort(t)
        t_done = t[order[self.k - 1]]            # k-th fastest completion
        useful = np.zeros(n)
        wasted = np.zeros(n)
        for rank, w in enumerate(order):
            if rank < self.k:
                useful[w] = rp
            else:
                # cancelled at t_done: everything it computed is discarded
                wasted[w] = min(rp, speeds[w] * t_done / cost.row_cost)
        comm = cost.vector_bcast_time(n) + cost.collect_time(rp * self.k)
        post = cost.postprocess_time(rp * self.k)
        return IterationResult(makespan=float(t_done) + comm + post,
                               compute_time=float(t_done), comm_time=comm,
                               post_time=post, useful_rows=useful,
                               wasted_rows=wasted)


# ---------------------------------------------------------------------------
# Charm++-style over-decomposition (uncoded, fine-grained, predictive)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class OverDecomposition:
    """Uncoded over-decomposition with speed-based load balancing (§7.2.1).

    Data split into n·factor chunks; replication_factor copies of chunks
    round-robin across workers.  Each iteration, chunks are assigned to
    workers proportionally to predicted speed; a chunk may run on any
    worker holding a copy for free, otherwise it must first be transferred
    (runtime data movement — the cost that bites at high mis-prediction).
    """

    n: int
    total_rows: int
    factor: int = 4
    replication_factor: float = 1.42
    seed: int = 0

    def __post_init__(self):
        self.num_chunks = self.n * self.factor
        self.rows_per_chunk = self.total_rows // self.num_chunks
        # primary placement: round-robin; replicas: additional round-robin
        # shifted by one worker (paper: distributed round-robin).
        copies = int(round(self.num_chunks * (self.replication_factor - 1.0)))
        self.holds = np.zeros((self.n, self.num_chunks), dtype=bool)
        for c in range(self.num_chunks):
            self.holds[c % self.n, c] = True
        for i in range(copies):
            c = i % self.num_chunks
            self.holds[(c + 1 + i // self.num_chunks) % self.n, c] = True

    def plan(self, pred_speeds: Optional[np.ndarray]):
        speeds = pred_speeds if pred_speeds is not None else np.ones(self.n)
        share = speeds / speeds.sum()
        target = share * self.num_chunks
        # greedy: walk chunks, give each to the neediest worker, preferring
        # holders of a local copy (zero movement).
        assign = np.full(self.num_chunks, -1, dtype=np.int64)
        load = np.zeros(self.n)
        for c in range(self.num_chunks):
            deficit = target - load
            holders = np.nonzero(self.holds[:, c])[0]
            best_holder = holders[np.argmax(deficit[holders])]
            # strongly prefer locality: migrate only when every holder is
            # already clearly overloaded (transfers cost seconds on the
            # cloud network — §7.2.3's observed penalty)
            if deficit[best_holder] > -1.0:
                assign[c] = best_holder
            else:
                assign[c] = int(np.argmax(deficit))
            load[assign[c]] += 1.0
        return assign

    def execute(self, assign, speeds: np.ndarray, cost: CostModel,
                rng: np.random.Generator) -> IterationResult:
        rows = np.zeros(self.n)
        moved_rows = 0.0
        xfer = np.zeros(self.n)
        for c, w in enumerate(assign):
            rows[w] += self.rows_per_chunk
            if not self.holds[w, c]:
                xfer[w] += cost.transfer_time(self.rows_per_chunk)
                moved_rows += self.rows_per_chunk
        t = np.array([xfer[w] + cost.compute_time(rows[w], speeds[w])
                      for w in range(self.n)])
        compute = float(t.max())
        comm = cost.vector_bcast_time(self.n) + cost.collect_time(self.total_rows)
        post = cost.postprocess_time(self.total_rows)
        return IterationResult(makespan=compute + comm + post,
                               compute_time=compute, comm_time=comm,
                               post_time=post, useful_rows=rows,
                               wasted_rows=np.zeros(self.n),
                               data_moved_rows=moved_rows)


# ---------------------------------------------------------------------------
# S²C² — shared execution semantics (timeout + reassign, §4.3)
# ---------------------------------------------------------------------------

def _execute_s2c2(alloc: Allocation, rows_per_chunk: int, speeds: np.ndarray,
                  cost: CostModel, timeout_slack: float,
                  planned_makespan: float = 0.0) -> IterationResult:
    """Run one S²C² iteration: workers compute their cyclic ranges; master
    collects first k, waits ``timeout_slack`` × mean response, then
    reassigns still-pending chunks among the finishers (§4.3).

    ``planned_makespan`` — the master's own predicted completion time for
    this allocation; it floors the timeout so that workers mispredicted as
    slow (tiny allocations, near-instant responses) cannot drag the
    first-k mean below the plan and trigger cascading cancellations.
    """
    n, k, C = alloc.n, alloc.k, alloc.chunks
    count = alloc.count.astype(np.float64)
    t = np.where(count > 0,
                 cost.compute_time(count * rows_per_chunk, speeds), 0.0)
    active = count > 0
    # §4.3: the clock is set by the first k workers to return results
    # (coverage ≥ k guarantees at least k active workers exist).
    t_order = np.where(active, t, np.inf)
    k_first = np.argsort(t_order)[:k]
    base = max(float(np.mean(t_order[k_first])), planned_makespan)
    timeout = base * (1.0 + timeout_slack)
    finished = active & (t <= timeout)
    useful = np.where(finished, count * rows_per_chunk, 0.0)
    wasted = np.zeros(n)
    reassigned = False

    masks = alloc.masks()
    cov_done = masks[finished].sum(axis=0) if finished.any() else np.zeros(C)
    pending = np.nonzero(cov_done < k)[0]
    makespan_compute = float(np.max(np.where(finished, t, 0.0)))

    if pending.size > 0:
        reassigned = True
        # cancelled workers' partial work is discarded (paper accounting)
        cancelled = active & ~finished
        frac_done = np.clip(timeout * speeds / np.maximum(
            count * rows_per_chunk * cost.row_cost, 1e-12), 0.0, 1.0)
        wasted[cancelled] = (count * rows_per_chunk * frac_done)[cancelled]
        # Reassign each pending chunk to the fastest *available* workers
        # (finishers AND idle zero-allocation workers — every worker holds a
        # full coded partition, so any non-cancelled worker can compute any
        # chunk) until coverage reaches k.
        extra = np.zeros(n)
        finishers = [int(w) for w in np.argsort(-speeds) if not cancelled[w]]
        wait_for = 0.0   # fallback: wait out a cancelled worker if needed
        for c in pending:
            need = int(k - cov_done[c])
            for w in finishers:
                if need == 0:
                    break
                if not masks[w, c]:
                    extra[w] += 1
                    masks[w, c] = True
                    need -= 1
            if need > 0:
                # not enough distinct available workers: fall back to
                # waiting for the fastest cancelled workers covering c
                # (the conventional-coded-computing degradation, §4.4)
                covering = np.nonzero(cancelled & allocation_masks(
                    alloc.begin, alloc.count, C)[:, c])[0]
                covering = sorted(covering, key=lambda w: t[w])
                for w in covering[:need]:
                    wait_for = max(wait_for, t[w])
                    useful[w] = count[w] * rows_per_chunk
                    wasted[w] = 0.0
        t2 = cost.compute_time(extra * rows_per_chunk, speeds)
        makespan_compute = max(timeout + float(t2.max()), wait_for)
        useful += extra * rows_per_chunk

    total_rows_collected = float(useful.sum())
    comm = cost.vector_bcast_time(n) + cost.collect_time(total_rows_collected)
    post = cost.postprocess_time(total_rows_collected)
    return IterationResult(
        makespan=makespan_compute + comm + post,
        compute_time=makespan_compute, comm_time=comm, post_time=post,
        useful_rows=useful, wasted_rows=wasted,
        reassigned=reassigned, mispredicted=reassigned)


@dataclasses.dataclass
class BasicS2C2:
    """S²C² with straggler-count information only (§4.1)."""

    n: int
    k: int
    total_rows: int
    chunks: int = 60
    straggler_threshold: float = 0.4   # speed < thr×max ⇒ treated as straggler
    timeout_slack: float = 0.15

    def __post_init__(self):
        self.rows_per_chunk = -(-self.total_rows // (self.k * self.chunks))

    def plan(self, pred_speeds: Optional[np.ndarray]) -> Allocation:
        if pred_speeds is None:
            self._pred = None
            return basic_allocation(self.n, self.k, self.chunks, ())
        thr = self.straggler_threshold * float(np.max(pred_speeds))
        stragglers = [w for w in range(self.n) if pred_speeds[w] < thr]
        # keep at least k live workers
        while self.n - len(stragglers) < self.k:
            stragglers.pop()
        self._pred = np.asarray(pred_speeds)
        return basic_allocation(self.n, self.k, self.chunks, stragglers)

    def execute(self, alloc: Allocation, speeds: np.ndarray, cost: CostModel,
                rng: np.random.Generator) -> IterationResult:
        planned = 0.0
        if getattr(self, "_pred", None) is not None:
            planned = expected_makespan(alloc, self._pred,
                                        self.rows_per_chunk, cost.row_cost)
        return _execute_s2c2(alloc, self.rows_per_chunk, speeds, cost,
                             self.timeout_slack, planned_makespan=planned)


@dataclasses.dataclass
class GeneralS2C2:
    """Algorithm 1: speed-proportional allocation + §4.3 timeout handling."""

    n: int
    k: int
    total_rows: int
    chunks: int = 60
    timeout_slack: float = 0.15

    def __post_init__(self):
        self.rows_per_chunk = -(-self.total_rows // (self.k * self.chunks))

    def plan(self, pred_speeds: Optional[np.ndarray]) -> Allocation:
        speeds = pred_speeds if pred_speeds is not None else np.ones(self.n)
        self._pred = np.asarray(speeds)
        return general_allocation(speeds, self.k, self.chunks)

    def execute(self, alloc: Allocation, speeds: np.ndarray, cost: CostModel,
                rng: np.random.Generator) -> IterationResult:
        planned = expected_makespan(alloc, self._pred, self.rows_per_chunk,
                                    cost.row_cost)
        return _execute_s2c2(alloc, self.rows_per_chunk, speeds, cost,
                             self.timeout_slack, planned_makespan=planned)
