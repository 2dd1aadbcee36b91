"""Per-round / per-job / service-level accounting for the cluster engine.

Everything the paper's evaluation reports, measured from real events:
makespan (wall), useful vs wasted rows (wasted = chunk results that arrived
beyond the k needed per chunk index, plus speculative losers), §4.3
reassignment waves, and at the service level throughput + latency
percentiles + wasted-work fraction per strategy.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["RoundMetrics", "JobMetrics", "ServiceReport", "percentile"]


def percentile(values: Sequence[float], q: float) -> float:
    if len(values) == 0:
        return float("nan")
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


@dataclasses.dataclass
class RoundMetrics:
    """One executed plan→dispatch→collect→decode round."""

    round_id: int
    strategy: str
    makespan: float                   # wall seconds, dispatch → decoded
    compute_time: float               # dispatch → last used completion
    decode_time: float
    useful_rows: np.ndarray           # (n,) row-equivalents used in the
    #                                   decode (rows × RHS width)
    wasted_rows: np.ndarray           # (n,) row-equivalents computed unused
    speeds_measured: np.ndarray       # (n,) rows/s · row_cost (1.0 = nominal)
    planned_makespan: float           # master's own prediction (virtual s)
    reassign_waves: int = 0
    mispredicted: bool = False
    cancelled_workers: int = 0
    inflight: int = 1                 # rounds in flight when this one started
    rhs_width: int = 1                # B: RHS columns of this round (1=matvec)
    coalesced: int = 1                # requests merged into this round; a
    #                                   follower's ride-along copy keeps the
    #                                   timing but zeroes the resource rows
    #                                   so service totals count the shared
    #                                   round exactly once
    steals: int = 0                   # successful idle-triggered steal passes
    retracted_chunks: int = 0         # chunks retracted and re-dispatched
    # WorkerFailed reasons seen this round
    worker_failures: Tuple[str, ...] = ()
    recovered_chunks: int = 0         # coverage seeded from the journal on
    #                                   master recovery (never recomputed)
    partition_credits: int = 0        # chunks credited from a SUSPECTED
    #                                   (partitioned) worker's replay

    @property
    def total_useful(self) -> float:
        return float(self.useful_rows.sum())

    @property
    def total_wasted(self) -> float:
        return float(self.wasted_rows.sum())

    @property
    def wasted_fraction(self) -> float:
        tot = self.total_useful + self.total_wasted
        return self.total_wasted / tot if tot > 0 else 0.0


@dataclasses.dataclass
class JobMetrics:
    """Lifecycle of one job through the service.

    ``t_start``/``t_done`` default to 0.0 until the scheduler stamps them;
    a job that errors (or is inspected) before a stamp lands would read
    ``t_start - t_submit`` as a huge negative number, so the timing
    properties return NaN until both operands are real stamps, and
    :meth:`ServiceReport.from_jobs` keeps such jobs out of the latency
    percentiles.
    """

    job_id: int
    kind: str
    strategy: str
    t_submit: float = 0.0
    t_start: float = 0.0
    t_done: float = 0.0
    rounds: List[RoundMetrics] = dataclasses.field(default_factory=list)
    error: Optional[str] = None

    @property
    def queue_wait(self) -> float:
        if self.t_start <= 0.0 or self.t_submit <= 0.0:
            return float("nan")
        return max(self.t_start - self.t_submit, 0.0)

    @property
    def service_time(self) -> float:
        if self.t_done <= 0.0 or self.t_start <= 0.0:
            return float("nan")
        return max(self.t_done - self.t_start, 0.0)

    @property
    def latency(self) -> float:
        if self.t_done <= 0.0 or self.t_submit <= 0.0:
            return float("nan")
        return max(self.t_done - self.t_submit, 0.0)

    @property
    def useful_rows(self) -> float:
        return sum(r.total_useful for r in self.rounds)

    @property
    def wasted_rows(self) -> float:
        return sum(r.total_wasted for r in self.rounds)

    @property
    def steals(self) -> int:
        return sum(r.steals for r in self.rounds)

    @property
    def retracted_chunks(self) -> int:
        return sum(r.retracted_chunks for r in self.rounds)


@dataclasses.dataclass
class ServiceReport:
    """Aggregate over a batch of completed jobs."""

    n_jobs: int
    n_rounds: int
    wall_time: float
    jobs_per_s: float
    rounds_per_s: float
    p50_latency: float
    p99_latency: float
    p50_queue_wait: float
    p99_queue_wait: float
    wasted_fraction: float
    by_strategy: Dict[str, Dict[str, float]]
    max_inflight: int = 1             # scheduler slots of the service
    peak_inflight: int = 1            # max jobs observed in service at once
    total_steals: int = 0             # idle-triggered steal passes, all rounds
    total_retracted: int = 0          # chunks retracted and re-dispatched
    coalesced_requests: int = 0       # requests that rode a merged
    #                                   multi-RHS round (coalescer admission)
    batched_rounds: int = 0           # engine rounds executed with B > 1

    @classmethod
    def from_jobs(cls, jobs: List[JobMetrics], wall_time: float,
                  max_inflight: int = 1, peak_inflight: int = 1
                  ) -> "ServiceReport":
        # errored / half-stamped jobs have NaN timings (see JobMetrics):
        # they count toward n_jobs but must not skew the percentiles
        def _finite(values: Iterable[float]) -> List[float]:
            return [v for v in values if np.isfinite(v)]

        clean = [j for j in jobs if j.error is None]
        lat = _finite(j.latency for j in clean)
        qw = _finite(j.queue_wait for j in clean)
        useful = sum(j.useful_rows for j in jobs)
        wasted = sum(j.wasted_rows for j in jobs)
        n_rounds = sum(len(j.rounds) for j in jobs)
        all_rounds = [r for j in jobs for r in j.rounds]
        # a merged round appears once per participant (same round_id), so
        # participants count requests and distinct ids count engine rounds
        coalesced_requests = sum(1 for r in all_rounds if r.coalesced > 1)
        batched_rounds = len({r.round_id for r in all_rounds
                              if r.rhs_width > 1})
        by: Dict[str, Dict[str, float]] = {}
        for strat in sorted({j.strategy for j in jobs}):
            js = [j for j in jobs if j.strategy == strat]
            u = sum(j.useful_rows for j in js)
            w = sum(j.wasted_rows for j in js)
            sl = _finite(j.latency for j in js if j.error is None)
            st = _finite(j.service_time for j in js if j.error is None)
            by[strat] = {
                "jobs": len(js),
                "rounds": sum(len(j.rounds) for j in js),
                "jobs_per_s": len(js) / wall_time if wall_time > 0 else 0.0,
                "p50_latency": percentile(sl, 50),
                "p99_latency": percentile(sl, 99),
                "mean_service_time": sum(st) / len(st) if st else 0.0,
                "wasted_fraction": w / (u + w) if (u + w) > 0 else 0.0,
            }
        return cls(
            n_jobs=len(jobs), n_rounds=n_rounds, wall_time=wall_time,
            jobs_per_s=len(jobs) / wall_time if wall_time > 0 else 0.0,
            rounds_per_s=n_rounds / wall_time if wall_time > 0 else 0.0,
            p50_latency=percentile(lat, 50), p99_latency=percentile(lat, 99),
            p50_queue_wait=percentile(qw, 50),
            p99_queue_wait=percentile(qw, 99),
            wasted_fraction=wasted / (useful + wasted)
            if (useful + wasted) > 0 else 0.0,
            by_strategy=by, max_inflight=max_inflight,
            peak_inflight=peak_inflight,
            total_steals=sum(j.steals for j in jobs),
            total_retracted=sum(j.retracted_chunks for j in jobs),
            coalesced_requests=coalesced_requests,
            batched_rounds=batched_rounds)

    @classmethod
    def from_registry(cls, registry: Any, wall_time: float,
                      max_inflight: int = 1, peak_inflight: int = 1
                      ) -> "ServiceReport":
        """Rebuild a report as a view over a live metrics registry.

        ``registry`` is the engine's :class:`~repro_torch.cluster.obs.
        MetricsRegistry` (duck-typed: anything with ``value``/``get``).
        Counts are exact (same counters the engine/service increment);
        latency percentiles are the Prometheus bucket-interpolated
        estimate, so they approximate :meth:`from_jobs` to within a
        histogram bucket.  Unlike ``from_jobs`` this needs no retained
        per-job objects — it is the long-lived-service path, and the
        bridge that keeps the report a *view* over the registry instead
        of a parallel accounting plane.
        """
        def _q(name: str, q: float, **labels: str) -> float:
            h = registry.get(name)
            if h is None or h.count == 0:
                return float("nan")
            child = h.labels(**labels) if labels else h
            return float(child.quantile(q))

        # a "rejected" child counts refused submissions (AdmissionTimeout /
        # ServiceSaturated), not jobs that ran — exclude it everywhere
        n_jobs = int(registry.value("s2c2_jobs_total")
                     - registry.value("s2c2_jobs_total", status="rejected"))
        n_rounds = int(registry.value("s2c2_rounds_total"))
        useful = registry.value("s2c2_useful_rows_total")
        wasted = registry.value("s2c2_wasted_rows_total")
        by: Dict[str, Dict[str, float]] = {}
        jobs_fam = registry.get("s2c2_jobs_total")
        if jobs_fam is not None:
            strat_i = jobs_fam.labelnames.index("strategy")
            status_i = jobs_fam.labelnames.index("status")
            strats: Dict[str, float] = {}
            for lv, child in jobs_fam.children().items():
                if lv[status_i] == "rejected":
                    continue
                strats[lv[strat_i]] = strats.get(lv[strat_i], 0) + child.value
            rounds_fam = registry.get("s2c2_rounds_total")
            lat_fam = registry.get("s2c2_job_latency_seconds")
            for strat, n in sorted(strats.items()):
                lat_child = None
                if lat_fam is not None:
                    lat_child = lat_fam.children().get((strat,))
                u = registry.value("s2c2_useful_rows_total", strategy=strat) \
                    if rounds_fam is not None else 0.0
                w = registry.value("s2c2_wasted_rows_total", strategy=strat) \
                    if rounds_fam is not None else 0.0
                by[strat] = {
                    "jobs": n,
                    "rounds": registry.value("s2c2_rounds_total",
                                             strategy=strat),
                    "jobs_per_s": n / wall_time if wall_time > 0 else 0.0,
                    "p50_latency": (lat_child.quantile(50) if lat_child
                                    else float("nan")),
                    "p99_latency": (lat_child.quantile(99) if lat_child
                                    else float("nan")),
                    "mean_service_time": (lat_child.sum / lat_child.count
                                          if lat_child and lat_child.count
                                          else 0.0),
                    "wasted_fraction": w / (u + w) if (u + w) > 0 else 0.0,
                }
        return cls(
            n_jobs=n_jobs, n_rounds=n_rounds, wall_time=wall_time,
            jobs_per_s=n_jobs / wall_time if wall_time > 0 else 0.0,
            rounds_per_s=n_rounds / wall_time if wall_time > 0 else 0.0,
            p50_latency=_q("s2c2_job_latency_seconds", 50),
            p99_latency=_q("s2c2_job_latency_seconds", 99),
            p50_queue_wait=_q("s2c2_job_queue_wait_seconds", 50),
            p99_queue_wait=_q("s2c2_job_queue_wait_seconds", 99),
            wasted_fraction=wasted / (useful + wasted)
            if (useful + wasted) > 0 else 0.0,
            by_strategy=by, max_inflight=max_inflight,
            peak_inflight=peak_inflight,
            total_steals=int(registry.value("s2c2_steals_total")),
            total_retracted=int(
                registry.value("s2c2_chunks_retracted_total")),
            coalesced_requests=int(
                registry.value("s2c2_coalesced_requests_total")),
            batched_rounds=int(
                registry.value("s2c2_batched_rounds_total")))

    def format(self) -> str:
        lines = [
            f"jobs={self.n_jobs} rounds={self.n_rounds} "
            f"wall={self.wall_time:.2f}s "
            f"throughput={self.jobs_per_s:.1f} jobs/s "
            f"({self.rounds_per_s:.1f} rounds/s) "
            f"inflight={self.peak_inflight}/{self.max_inflight}",
            f"latency p50={self.p50_latency * 1e3:.1f}ms "
            f"p99={self.p99_latency * 1e3:.1f}ms  "
            f"queue_wait p50={self.p50_queue_wait * 1e3:.1f}ms "
            f"p99={self.p99_queue_wait * 1e3:.1f}ms  "
            f"wasted={self.wasted_fraction * 100:.1f}%  "
            f"steals={self.total_steals} "
            f"(retracted_chunks={self.total_retracted})  "
            f"coalesced={self.coalesced_requests} reqs "
            f"in {self.batched_rounds} batched rounds",
        ]
        for strat, s in self.by_strategy.items():
            lines.append(
                f"  [{strat}] jobs={s['jobs']:.0f} "
                f"p50={s['p50_latency'] * 1e3:.1f}ms "
                f"p99={s['p99_latency'] * 1e3:.1f}ms "
                f"wasted={s['wasted_fraction'] * 100:.1f}%")
        return "\n".join(lines)
