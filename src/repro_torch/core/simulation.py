"""Trace-driven cluster simulator for coded-computation strategies.

The paper evaluates S²C² purely on *latency* (total execution time of
iterative jobs under controlled straggler behavior and on a real cloud).
This container has one CPU core, so wall-clock multi-node runs are not
possible; instead we simulate the cluster with a calibrated cost model:

* per-row compute cost measured from a real matvec on the card (or the
  host, on request) (:func:`calibrate_row_cost`) — speeds in the traces are
  multipliers on it;
* a simple bandwidth+latency network model for input broadcast, result
  collection, and (for uncoded strategies) data movement;
* per-iteration semantics identical to the paper's master/worker runtime:
  plan → compute → collect (with any-k or timeout rules) → decode.

All strategy *policies* (allocation, prediction, timeout/reassign) are the
exact production implementations from ``repro_torch.core`` — the simulator only
supplies time.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch._device import resolve_device

__all__ = [
    "CostModel",
    "IterationResult",
    "RunResult",
    "calibrate_row_cost",
    "simulate_run",
    "LOCAL_CLUSTER",
    "CLOUD_CLUSTER",
]


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Time model of one cluster.  Units: seconds, bytes."""

    row_cost: float = 2.0e-6        # sec per matrix row per unit speed
    d_cols: int = 5000              # row width (for byte sizing)
    elem_bytes: int = 8
    net_bw: float = 7.0e9           # bytes/sec (56 Gbps IB local cluster)
    net_latency: float = 1.0e-4     # per message
    decode_cost_per_row: float = 1.0e-8
    assemble_cost_per_row: float = 2.0e-8   # paper: loading dominates decode;
    # both are tiny next to compute (§7.1: "total execution time is
    # dominated by the computation time")

    def compute_time(self, rows, speed):
        """Vectorized: rows/speed may be scalars or arrays."""
        return rows * self.row_cost / np.maximum(speed, 1e-9)

    def transfer_time(self, rows: float) -> float:
        return self.net_latency + rows * self.d_cols * self.elem_bytes / self.net_bw

    def vector_bcast_time(self, n_workers: int) -> float:
        return self.net_latency * n_workers + \
            self.d_cols * self.elem_bytes * n_workers / self.net_bw

    def collect_time(self, rows_total: float) -> float:
        # result vectors are rows x 1
        return self.net_latency + rows_total * self.elem_bytes / self.net_bw

    def postprocess_time(self, rows_total: float) -> float:
        return rows_total * (self.decode_cost_per_row + self.assemble_cost_per_row)


# Local controlled cluster (§6.5): 56 Gbps InfiniBand, fast boxes.
LOCAL_CLUSTER = CostModel(net_bw=7.0e9, net_latency=5.0e-5)
# DigitalOcean shared droplets (§6.4): ~1 Gbps, higher latency.
CLOUD_CLUSTER = CostModel(net_bw=1.25e8, net_latency=5.0e-4)


@dataclasses.dataclass
class IterationResult:
    makespan: float
    compute_time: float
    comm_time: float
    post_time: float
    useful_rows: np.ndarray      # (n,) rows whose results were used
    wasted_rows: np.ndarray      # (n,) rows computed but discarded
    data_moved_rows: float = 0.0
    reassigned: bool = False
    mispredicted: bool = False

    @property
    def total_wasted(self) -> float:
        return float(self.wasted_rows.sum())


@dataclasses.dataclass
class RunResult:
    iteration_times: np.ndarray
    per_worker_wasted: np.ndarray    # (n,) total wasted rows per worker
    per_worker_useful: np.ndarray
    data_moved_rows: float
    mispredictions: int

    @property
    def total_time(self) -> float:
        return float(self.iteration_times.sum())

    @property
    def mean_time(self) -> float:
        return float(self.iteration_times.mean())

    def wasted_fraction(self) -> np.ndarray:
        tot = self.per_worker_wasted + self.per_worker_useful
        return self.per_worker_wasted / np.maximum(tot, 1e-12)


def calibrate_row_cost(d_cols: int = 5000, rows: int = 2000, repeats: int = 3,
                       device: str | torch.device = "cuda") -> float:
    """Measure real seconds-per-row of a dense float32 matvec on ``device``.

    The product runs on the given device (the card by default; pass
    ``device="cpu"`` for the host), and each timing ends in
    ``torch.cuda.synchronize()`` on the card, so it is the device's time,
    not the enqueue's.  The best of ``repeats`` runs, after one warm-up.
    """
    dev = resolve_device(device)
    a = torch.from_numpy(np.random.default_rng(0).standard_normal((rows, d_cols))
                         .astype(np.float32)).to(dev)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((d_cols,))
                         .astype(np.float32)).to(dev)

    def sync() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    torch.matmul(a, x)
    sync()
    best = np.inf
    for _ in range(repeats):
        t0 = time.perf_counter()
        torch.matmul(a, x)
        sync()
        best = min(best, time.perf_counter() - t0)
    return best / rows


def simulate_run(strategy, traces: np.ndarray, cost: CostModel,
                 predictor=None, seed: int = 0) -> RunResult:
    """Run ``strategy`` over per-iteration speed ``traces`` (T, n).

    ``strategy`` implements the protocol:
      plan(pred_speeds: (n,) | None) -> plan object
      execute(plan, true_speeds: (n,), cost: CostModel, rng) -> IterationResult
    ``predictor`` (optional) implements observe(speeds)/predict() — e.g.
    :class:`repro_torch.core.predictor.SpeedPredictor`.  Without one, strategies
    receive the previous iteration's measured speeds (the paper's fallback).
    """
    rng = np.random.default_rng(seed)
    t_iters, n = traces.shape
    times = np.empty(t_iters)
    wasted = np.zeros(n)
    useful = np.zeros(n)
    moved = 0.0
    mispred = 0
    prev_speeds: Optional[np.ndarray] = None
    for it in range(t_iters):
        if predictor is not None:
            pred = predictor.predict()
        else:
            pred = prev_speeds if prev_speeds is not None else None
        plan = strategy.plan(pred)
        res: IterationResult = strategy.execute(plan, traces[it], cost, rng)
        times[it] = res.makespan
        wasted += res.wasted_rows
        useful += res.useful_rows
        moved += res.data_moved_rows
        mispred += int(res.mispredicted)
        # master measures speeds from response times (rows/time) — we observe the
        # true speeds of this iteration, as §6.2 computes l_i/t_i.
        prev_speeds = traces[it]
        if predictor is not None:
            predictor.observe(traces[it])
    return RunResult(iteration_times=times, per_worker_wasted=wasted,
                     per_worker_useful=useful, data_moved_rows=moved,
                     mispredictions=mispred)
