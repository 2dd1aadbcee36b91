"""Multi-tenant job service: bounded queue of heterogeneous coded jobs.

Producers (any thread) submit :class:`Job` objects; ``max_inflight``
scheduler slots drain the queue concurrently and run each job's rounds on
the shared :class:`~repro_torch.cluster.master.CodedExecutionEngine` — one
engine, many tenants, each with its own encoded shards, strategy, and
accounting, with independent tenants' rounds pipelined over the same
worker pool.
``submit`` is non-blocking against a full queue (raises
:class:`ServiceSaturated` — backpressure, the admission-control behavior a
serving tier needs), and every job records queue wait, per-round execution
metrics, and wasted work, aggregated by :meth:`JobService.report`.

**Request coalescing.**  Serving traffic queries the *same* encoded
matrix from many concurrent jobs (the PageRank / graph-filter scenario),
so the service runs a :class:`RoundCoalescer` in front of the engine:
matvec requests from different jobs that are *compatible* — same shared
:class:`~repro_torch.cluster.data.CodedData` (see
:meth:`JobService.share_matrix`), structurally identical strategy, same
operand shape — are merged, up to ``max_batch`` at a time, into ONE
multi-RHS round (``engine.matmul``) whose ``(rows, B)`` chunks run as
single BLAS-3 passes over each shard, then fanned back out to the
per-job callers.  One set of dispatch/steal/decode/event overheads is
paid instead of B, and iterative jobs (PageRank, regression) re-coalesce
on every iteration.  Incompatible requests never merge, and a merged
round's failure propagates to each participant independently (per-job
fault isolation is unchanged).  ``coalesce=False`` restores the PR-3
service exactly.

Job kinds (the §6.3 workloads):

* :class:`MatvecJob`    — a batch of raw coded matvecs against one matrix
  (optionally ``batch``-ed into multi-RHS rounds by the job itself);
* :class:`PageRankJob`  — damped power iterations (x drifts every round);
* :class:`RegressionJob`— coded-gradient-descent epochs for logistic / SVM
  losses (the Ax product is the coded part, as in the paper).
"""

from __future__ import annotations

import dataclasses
import logging
import queue
import threading
import time
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.cluster import obs
from repro_torch.cluster.data import CodedData, replica_placement
from repro_torch.cluster.journal import decode_array, encode_array
from repro_torch.cluster.master import (_STRATEGY_CLASSES, CodedExecutionEngine,
                                        EngineClosed, RoundOutput,
                                        _resolve_strategy, _strategy_spec)
from repro_torch.cluster.metrics import JobMetrics, RoundMetrics, ServiceReport
from repro_torch.core.strategies import UncodedReplication

__all__ = ["Job", "MatvecJob", "PageRankJob", "RegressionJob",
           "JobService", "ServiceSaturated", "AdmissionTimeout", "JobHandle",
           "RoundCoalescer"]

logger = logging.getLogger("repro_torch.cluster.service")


class ServiceSaturated(RuntimeError):
    """The bounded admission queue is full — resubmit later."""


class AdmissionTimeout(ServiceSaturated):
    """A blocking submit (``submit_timeout``) waited its budget out without
    a queue slot opening.  Subclasses :class:`ServiceSaturated` so existing
    saturation handlers keep working."""


def _strategy_key(strategy) -> Tuple:
    """Structural compatibility fingerprint of a strategy instance.

    Two instances of the same class with the same scalar parameters plan
    identically, so their requests may share one batched round — jobs get
    their own strategy objects, and identity must not block merging.
    Non-scalar attributes (prediction snapshots, placements) are derived
    state, not plan inputs, and are excluded.
    """
    scalars = tuple(sorted(
        (name, v) for name, v in vars(strategy).items()
        if isinstance(v, (int, float, str, bool))))
    return (type(strategy).__name__,) + scalars


def _follower_metrics(m: RoundMetrics) -> RoundMetrics:
    """Ride-along round entry for a merged round's non-leader participants.

    Keeps the round's timing, width, and merge count (latency accounting
    per job stays truthful) but zeroes the resource counters so
    service-level row/steal totals count the shared round exactly once —
    on the leader's copy.
    """
    return dataclasses.replace(
        m, useful_rows=np.zeros_like(m.useful_rows),
        wasted_rows=np.zeros_like(m.wasted_rows),
        steals=0, retracted_chunks=0, worker_failures=())


class _CoalesceGroup:
    """One forming batch: requests accumulate until full or the hold expires."""

    __slots__ = ("xs", "closed", "full", "done", "outputs", "metrics",
                 "error")

    def __init__(self):
        self.xs: List[np.ndarray] = []
        self.closed = False                  # no further admissions
        self.full = threading.Event()        # max_batch reached early
        self.done = threading.Event()        # outputs/error published
        self.outputs: Optional[List[np.ndarray]] = None
        self.metrics: Optional[RoundMetrics] = None
        self.error: Optional[BaseException] = None


class RoundCoalescer:
    """Merge compatible concurrent matvec requests into multi-RHS rounds.

    The first request of a compatibility key becomes the group *leader*:
    it holds the round open for ``hold_s`` (or until ``max_batch``
    requests joined), then launches one ``engine.matmul`` over the stacked
    ``(d, B)`` block and hands each participant its own output column.  A
    group of one degenerates to a plain ``engine.matvec`` — bit-identical
    to the uncoalesced path.  Errors propagate to every participant
    independently; a group can never deadlock its followers because the
    leader publishes (result or error) in a ``finally``.
    """

    def __init__(self, engine: CodedExecutionEngine, max_batch: int = 8,
                 hold_s: float = 1e-3):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.engine = engine
        self.max_batch = max_batch
        self.hold_s = hold_s
        self._lock = threading.Lock()
        self._groups: Dict[Tuple, _CoalesceGroup] = {}  # guarded_by: _lock
        # batched rounds launched (B >= 2)
        self.merged_rounds = 0       # guarded_by: _lock
        # requests served via batched rounds
        self.merged_requests = 0     # guarded_by: _lock
        self._m_merged_rounds = engine.registry.counter(
            "s2c2_coalesced_rounds_total",
            "multi-RHS rounds launched by the coalescer (B >= 2)")
        self._m_merged_reqs = engine.registry.counter(
            "s2c2_coalesced_requests_total",
            "matvec requests served via a coalesced round")

    def matvec(self, data: CodedData, x: np.ndarray,
               strategy) -> RoundOutput:
        """Serve one matvec request, possibly as a column of a merged round."""
        x = np.asarray(x, dtype=np.float64)
        key = (data.shard_id, x.shape, _strategy_key(strategy))
        with self._lock:
            grp = self._groups.get(key)
            leader = grp is None or grp.closed
            if leader:
                grp = _CoalesceGroup()
                self._groups[key] = grp
            idx = len(grp.xs)
            grp.xs.append(x.copy())          # caller may mutate x after
            if len(grp.xs) >= self.max_batch:
                grp.closed = True
                grp.full.set()
        if leader:
            self._lead(key, grp, data, strategy)
        else:
            # the engine's own starvation detector is the liveness bound;
            # the leader publishes in a finally, so this always returns
            grp.done.wait()
        if grp.error is not None:
            raise grp.error
        assert grp.outputs is not None and grp.metrics is not None
        metrics = grp.metrics if idx == 0 else _follower_metrics(grp.metrics)
        return RoundOutput(y=grp.outputs[idx], metrics=metrics)

    def _lead(self, key: Tuple, grp: _CoalesceGroup, data: CodedData,
              strategy) -> None:
        grp.full.wait(self.hold_s)
        with self._lock:
            grp.closed = True                # freeze admissions
            if self._groups.get(key) is grp:
                del self._groups[key]
            xs = list(grp.xs)
        try:
            if len(xs) == 1:
                out = self.engine.matvec(data, xs[0], strategy)
                grp.outputs = [out.y]
                grp.metrics = out.metrics
            else:
                out = self.engine.matmul(data, np.stack(xs, axis=1),
                                         strategy)
                grp.outputs = [np.ascontiguousarray(out.y[:, j])
                               for j in range(len(xs))]
                grp.metrics = dataclasses.replace(out.metrics,
                                                  coalesced=len(xs))
                with self._lock:
                    self.merged_rounds += 1
                    self.merged_requests += len(xs)
                self._m_merged_rounds.inc()
                self._m_merged_reqs.inc(len(xs))
                tracer = self.engine.tracer
                if tracer.enabled:
                    tracer.emit(obs.KIND_COALESCE,
                                round_id=out.metrics.round_id,
                                merged=len(xs), shard=key[0])
                logger.debug("coalesced %d requests on shard %s into "
                             "round %d", len(xs), key[0],
                             out.metrics.round_id)
        except BaseException as exc:         # every participant re-raises
            grp.error = exc
        finally:
            grp.done.set()


class _CoalescingEngine:
    """Engine facade handed to :meth:`Job.rounds`.

    Routes coalescable matvecs — coded strategy against a matrix the
    service registered as shared — through the :class:`RoundCoalescer`;
    everything else (private tenant data, replicated strategies, direct
    ``matmul`` calls, attribute access) passes straight through, so jobs
    are written against the engine API and never see the difference.
    """

    def __init__(self, engine: CodedExecutionEngine,
                 coalescer: Optional[RoundCoalescer],
                 shared_ids: Set[str]):
        self._engine = engine
        self._coalescer = coalescer
        self._shared_ids = shared_ids

    def matvec(self, data, x: np.ndarray, strategy) -> RoundOutput:
        if (self._coalescer is not None
                and getattr(data, "shard_id", None) in self._shared_ids
                and not isinstance(strategy, UncodedReplication)):
            return self._coalescer.matvec(data, x, strategy)
        return self._engine.matvec(data, x, strategy)

    def __getattr__(self, name):
        return getattr(self._engine, name)


class Job:
    """One tenant workload: a matrix + a sequence of dependent rounds.

    ``data`` may carry an already-loaded :class:`CodedData` (typically from
    :meth:`JobService.share_matrix`): the job then skips its private
    encode/install, many jobs can query the same shards, and — when the
    service coalesces — their concurrent rounds become candidates for
    multi-RHS merging.  Shared data is owned by whoever loaded it; the
    service never unloads it at job end.
    """

    kind = "job"

    def __init__(self, a: np.ndarray, strategy, chunks: int = 20,
                 data: Optional[CodedData] = None):
        self.a = np.asarray(a, dtype=np.float64)
        self.strategy = strategy
        self.chunks = chunks
        self.data = data

    # -- engine interaction -------------------------------------------------
    def prepare(self, engine: CodedExecutionEngine):
        if self.data is not None:
            return self.data
        if isinstance(self.strategy, UncodedReplication):
            placement = replica_placement(engine.cfg.n_workers,
                                          self.strategy.replication,
                                          seed=self.strategy.seed)
            return engine.load_replicated(self.a, placement)
        return engine.load_matrix(self.a, chunks=self.chunks)

    def rounds(self, engine: CodedExecutionEngine, data, record):
        """Run all rounds; ``record(metrics)`` after each. Returns output."""
        raise NotImplementedError


class MatvecJob(Job):
    """Batch of independent matvecs A @ x_i (raw serving traffic).

    ``batch > 1`` groups the job's own vectors into ``(d, batch)``
    multi-RHS rounds (one GEMM round instead of ``batch`` matvec rounds);
    the default 1 preserves the one-round-per-vector behavior, and
    cross-job merging is the coalescer's business either way.
    """

    kind = "matvec"

    def __init__(self, a, xs: Sequence[np.ndarray], strategy,
                 chunks: int = 20, batch: int = 1,
                 data: Optional[CodedData] = None):
        super().__init__(a, strategy, chunks, data=data)
        self.xs = [np.asarray(x, dtype=np.float64) for x in xs]
        if batch < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        self.batch = batch

    def rounds(self, engine, data, record):
        outs = []
        for i in range(0, len(self.xs), self.batch):
            grp = self.xs[i:i + self.batch]
            if len(grp) == 1:
                out = engine.matvec(data, grp[0], self.strategy)
                record(out.metrics)
                outs.append(out.y)
            else:
                out = engine.matmul(data, np.stack(grp, axis=1),
                                    self.strategy)
                record(out.metrics)
                outs.extend(np.ascontiguousarray(out.y[:, j])
                            for j in range(len(grp)))
        return np.stack(outs)


class PageRankJob(Job):
    """Damped power iteration r ← (1-d)/N + d·M r (§6.3 graph workload)."""

    kind = "pagerank"

    def __init__(self, m, strategy, iters: int = 10, damping: float = 0.85,
                 chunks: int = 20, data: Optional[CodedData] = None):
        super().__init__(m, strategy, chunks, data=data)
        self.iters = iters
        self.damping = damping

    def rounds(self, engine, data, record):
        n = self.a.shape[0]
        r = np.ones(n) / n
        for _ in range(self.iters):
            out = engine.matvec(data, r, self.strategy)
            record(out.metrics)
            r = (1.0 - self.damping) / n + self.damping * out.y[:n]
        return r


class RegressionJob(Job):
    """Coded gradient descent: the Ax matvec runs on the cluster."""

    kind = "regression"

    def __init__(self, a, y, strategy, epochs: int = 5, loss: str = "logistic",
                 lr: float = 0.5, chunks: int = 20,
                 data: Optional[CodedData] = None):
        super().__init__(a, strategy, chunks, data=data)
        self.y = np.asarray(y, dtype=np.float64)
        self.epochs = epochs
        self.loss = loss
        self.lr = lr

    def rounds(self, engine, data, record):
        a, yv = self.a, self.y
        w = np.zeros(a.shape[1])
        for _ in range(self.epochs):
            out = engine.matvec(data, w, self.strategy)
            record(out.metrics)
            ax = out.y[: a.shape[0]]
            margin = yv * ax
            if self.loss == "logistic":
                g = a.T @ (-yv / (1.0 + np.exp(margin)))
            else:                                   # hinge (SVM)
                g = a.T @ (-yv * (margin < 1)) + 1e-3 * w
            w -= (self.lr / a.shape[0]) * g
        return w


# -- admission journaling ---------------------------------------------------

def _job_spec(job: Job) -> Optional[Dict]:
    """JSON-able admit payload for a journalable job, or ``None``.

    Jobs riding on shared service data (``data=``) reference engine-owned
    shards the journal does not capture, and replicated strategies have no
    registered spec — both are admitted without a durable record (their
    in-flight *rounds* are still journaled and resumed; only the job-level
    resubmission is unavailable for them).
    """
    if job.data is not None:
        return None
    if type(job.strategy).__name__ not in _STRATEGY_CLASSES:
        return None
    spec: Dict = {"kind": job.kind, "chunks": job.chunks,
                  "a": encode_array(job.a),
                  "strategy": _strategy_spec(job.strategy)}
    if isinstance(job, MatvecJob):
        spec["xs"] = [encode_array(x) for x in job.xs]
        spec["batch"] = job.batch
    elif isinstance(job, PageRankJob):
        spec["iters"] = job.iters
        spec["damping"] = job.damping
    elif isinstance(job, RegressionJob):
        spec["y"] = encode_array(job.y)
        spec["epochs"] = job.epochs
        spec["loss"] = job.loss
        spec["lr"] = job.lr
    else:
        return None                       # unknown subclass: can't rebuild
    return spec


def _job_from_spec(rec: Dict) -> Optional[Job]:
    """Rebuild a :class:`Job` from a replayed ``admit`` record."""
    spec = rec.get("job")
    if not spec:
        return None
    try:
        strategy = _resolve_strategy(spec["strategy"])
        a = decode_array(spec["a"])
        kind = spec.get("kind")
        if kind == "matvec":
            return MatvecJob(a, [decode_array(x) for x in spec["xs"]],
                             strategy, chunks=spec["chunks"],
                             batch=spec.get("batch", 1))
        if kind == "pagerank":
            return PageRankJob(a, strategy, iters=spec["iters"],
                               damping=spec["damping"],
                               chunks=spec["chunks"])
        if kind == "regression":
            return RegressionJob(a, decode_array(spec["y"]), strategy,
                                 epochs=spec["epochs"], loss=spec["loss"],
                                 lr=spec["lr"], chunks=spec["chunks"])
    except Exception as exc:
        logger.warning("journal: admit record not rebuildable: %s", exc)
    return None


@dataclasses.dataclass
class JobHandle:
    """Future-like handle returned by submit()."""

    job: Job
    metrics: JobMetrics
    done: threading.Event = dataclasses.field(default_factory=threading.Event)
    output: Optional[np.ndarray] = None
    #: journal identity (non-empty iff the admission was journaled)
    uid: str = ""
    journaled: bool = False

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self.done.wait(timeout)


class JobService:
    """Bounded-queue, multi-slot scheduler multiplexing jobs over one engine.

    ``max_inflight`` scheduler slots drain the admission queue
    concurrently; each slot runs one job's (internally sequential) rounds
    on the shared engine, which pipelines independent rounds chunk-by-chunk
    over the worker pool.  With ``max_inflight=1`` this degenerates to the
    old serialized run loop; higher values overlap one tenant's straggler /
    collect / decode slack with other tenants' useful compute.

    With ``coalesce=True`` (default) a :class:`RoundCoalescer` merges
    compatible concurrent requests against :meth:`share_matrix` data into
    multi-RHS rounds — up to ``max_batch`` requests per round, held open
    for at most ``coalesce_hold_s``.  Jobs on private (per-job) data never
    pay the hold and never merge.
    """

    def __init__(self, engine: CodedExecutionEngine, max_queue: int = 256,
                 max_inflight: int = 4, coalesce: bool = True,
                 max_batch: int = 8, coalesce_hold_s: float = 1e-3,
                 submit_timeout: Optional[float] = None):
        if max_inflight < 1:
            raise ValueError(f"max_inflight must be >= 1, got {max_inflight}")
        self.engine = engine
        self.max_inflight = max_inflight
        # default admission-wait budget: None/0 keeps the historical
        # non-blocking reject; > 0 lets submit() wait that long for a slot
        # before raising AdmissionTimeout (overridable per call)
        self.submit_timeout = submit_timeout
        self._closed = False           # guarded_by: _lock
        self.queue: "queue.Queue[Optional[JobHandle]]" = queue.Queue(max_queue)
        self.completed: List[JobMetrics] = []   # guarded_by: _lock
        self._seq = 0                  # guarded_by: _lock
        # jobs actually enqueued (≠ _seq on saturation — drain waits on
        # these); everything below down to _shared_data shares one lock
        self._accepted = 0             # guarded_by: _lock
        self._lock = threading.Lock()
        self._in_service = 0           # guarded_by: _lock
        # max jobs observed in service at once
        self._peak_inflight = 0        # guarded_by: _lock
        self._t_open = time.perf_counter()
        # throughput window
        self._t_first_submit: Optional[float] = None   # guarded_by: _lock
        # shard ids owned by the service
        self._shared_ids: Set[str] = set()      # guarded_by: _lock
        self._shared_data: List[CodedData] = []  # guarded_by: _lock
        # service-plane metrics live in the ENGINE's registry, so one
        # render() (or ServiceReport.from_registry) covers both planes
        reg = engine.registry
        self._tkind = getattr(engine.transport, "kind", "inproc")
        self._m_jobs = reg.counter(
            "s2c2_jobs_total", "jobs completed",
            ("kind", "strategy", "status", "transport"))
        self._m_latency = reg.histogram(
            "s2c2_job_latency_seconds",
            "job latency, submit to done (ok jobs)", ("strategy",))
        self._m_queue_wait = reg.histogram(
            "s2c2_job_queue_wait_seconds",
            "admission-queue wait, submit to slot start (ok jobs)")
        self._m_inflight_jobs = reg.gauge(
            "s2c2_inflight_jobs", "jobs currently holding a scheduler slot")
        self._m_rejected = reg.counter(
            "s2c2_jobs_rejected_total", "submissions refused at saturation")
        self.coalescer = (RoundCoalescer(engine, max_batch, coalesce_hold_s)
                          if coalesce else None)
        self._exec = _CoalescingEngine(engine, self.coalescer,
                                       self._shared_ids)
        self._threads = [
            threading.Thread(target=self._run, name=f"job-slot-{i}",
                             daemon=True)
            for i in range(max_inflight)]
        for t in self._threads:
            t.start()

    # -- shared tenant data -------------------------------------------------
    def share_matrix(self, a: np.ndarray, chunks: int = 20,
                     code=None) -> CodedData:
        """Encode + install a matrix ONCE, to be queried by many jobs.

        Jobs constructed with ``data=`` skip their private encode/load, and
        their concurrent rounds against the shared matrix are coalescing
        admission candidates.  The service owns the shards: they stay
        installed until :meth:`close`.
        """
        data = self.engine.load_matrix(a, chunks=chunks, code=code)
        with self._lock:
            self._shared_ids.add(data.shard_id)
            self._shared_data.append(data)
        return data

    # -- producer side ------------------------------------------------------
    def submit(self, job: Job,
               timeout: Optional[float] = None) -> JobHandle:
        with self._lock:
            if self._closed:
                raise EngineClosed("service is closed")
            self._seq += 1
            jid = self._seq
        metrics = JobMetrics(job_id=jid, kind=job.kind,
                             strategy=type(job.strategy).__name__,
                             t_submit=time.perf_counter())
        handle = JobHandle(job=job, metrics=metrics, uid=f"j{jid}")
        if self.engine.journal is not None:
            # write-ahead admission: durable BEFORE the scheduler can touch
            # it, so a crash at any later point can rebuild and resubmit
            spec = _job_spec(job)
            if spec is not None:
                self.engine._journal("admit", {"uid": handle.uid,
                                               "job": spec})
                handle.journaled = True
        # count BEFORE enqueueing: the scheduler may start (even finish) the
        # job the instant it is queued, and a drain() racing this submit
        # must not observe completed == accepted while the job is live
        with self._lock:
            self._accepted += 1
        wait = self.submit_timeout if timeout is None else timeout
        try:
            if wait is not None and wait > 0:
                self.queue.put(handle, timeout=wait)
            else:
                self.queue.put_nowait(handle)
        except (queue.Full,):
            with self._lock:
                self._accepted -= 1
            self._m_rejected.inc()
            self._m_jobs.labels(kind=job.kind, strategy=metrics.strategy,
                                status="rejected",
                                transport=self._tkind).inc()
            if handle.journaled:
                # the admit already hit the journal: retire it, or recovery
                # would resubmit a job the caller was told to retry
                self.engine._journal("job_done", {"uid": handle.uid,
                                                  "status": "rejected"})
            if wait is not None and wait > 0:
                logger.debug("job %d rejected: no queue slot within %.3fs",
                             jid, wait)
                raise AdmissionTimeout(
                    f"no admission-queue slot within {wait}s "
                    f"(queue {self.queue.maxsize}); retry later")
            logger.debug("job %d rejected: admission queue full (%d)",
                         jid, self.queue.maxsize)
            raise ServiceSaturated(
                f"job queue full ({self.queue.maxsize}); retry later")
        with self._lock:
            if self._t_first_submit is None:
                self._t_first_submit = metrics.t_submit
        return handle

    def drain(self, timeout: Optional[float] = None) -> None:
        """Block until every submitted job has completed."""
        deadline = None if timeout is None else time.perf_counter() + timeout
        while True:
            with self._lock:
                pending = self._accepted - len(self.completed)
            if pending == 0:
                return
            if deadline is not None and time.perf_counter() > deadline:
                raise TimeoutError(f"{pending} jobs still pending")
            time.sleep(0.002)

    def _resolve_closed(self, handle: "JobHandle") -> None:
        """Resolve a queued-but-never-started handle with a clean error."""
        m = handle.metrics
        now = time.perf_counter()
        m.t_start = m.t_start or now
        m.t_done = now
        m.error = "EngineClosed: service closed before the job started"
        self._m_jobs.labels(kind=m.kind, strategy=m.strategy,
                            status="error", transport=self._tkind).inc()
        if handle.journaled:
            self.engine._journal("job_done", {"uid": handle.uid,
                                              "status": "refused"})
        with self._lock:
            self.completed.append(m)
        handle.done.set()

    def close(self) -> None:
        """Stop the scheduler slots.  Idempotent and safe under load: a
        second call is a no-op; jobs already executing finish normally,
        while jobs still queued resolve with an ``EngineClosed`` error —
        every handle a caller holds is guaranteed to resolve."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        for _ in self._threads:
            self.queue.put(None)
        for t in self._threads:
            t.join(timeout=30.0)
        # defensive sweep: anything a slot didn't drain (e.g. a handle that
        # raced past a slot's exit) must still resolve
        while True:
            try:
                leftover = self.queue.get_nowait()
            except queue.Empty:
                break
            if leftover is not None:
                self._resolve_closed(leftover)
        with self._lock:
            shared, self._shared_data = self._shared_data, []
            self._shared_ids.clear()
        for data in shared:
            self.engine.unload(data)

    # -- crash recovery -----------------------------------------------------
    @classmethod
    def recover(cls, engine: CodedExecutionEngine,
                **kwargs) -> "JobService":
        """Rebuild the service tier on top of a recovered engine.

        Every job the crashed service durably admitted but never resolved
        is rebuilt from its ``admit`` record and resubmitted under a fresh
        uid (the old uid is retired with a ``job_done`` record pointing at
        the resubmission, so a second recovery never doubles it).  Jobs
        whose rounds the engine already resumed resolve through the
        engine's replay cache — the resubmission attaches to the resumed
        round's handle instead of recomputing.  Admissions that cannot be
        rebuilt (shared-data jobs, unknown kinds) are retired with a
        warning rather than silently dropped.
        """
        svc = cls(engine, **kwargs)
        st = getattr(engine, "journal_state", None)
        if st is None:
            return svc
        # float the uid sequence past every journaled admission, so fresh
        # submissions never reuse a uid the journal already knows
        floor = 0
        for uid in st.admits:
            if uid.startswith("j"):
                try:
                    floor = max(floor, int(uid[1:]))
                except ValueError:
                    pass
        with svc._lock:
            svc._seq = max(svc._seq, floor)
        for uid, rec in sorted(st.open_jobs.items()):
            job = _job_from_spec(rec)
            if job is None:
                logger.warning("recovery: admitted job %s is not "
                               "rebuildable — retired unresolved", uid)
                engine._journal("job_done", {"uid": uid,
                                             "status": "unrecoverable"})
                continue
            handle = svc.submit(job)
            engine._journal("job_done", {"uid": uid,
                                         "resubmitted_as": handle.uid})
            logger.info("recovery: job %s resubmitted as %s", uid,
                        handle.uid)
        return svc

    # -- scheduler side -----------------------------------------------------
    def _run(self) -> None:
        """One scheduler slot: drain the admission queue, one job at a time.

        Fault isolation is per job and per slot: a failing job records its
        error and the slot moves on; other slots never notice.
        """
        while True:
            handle = self.queue.get()
            if handle is None:
                return
            # the closed flag mutates under _lock (close() racing this
            # dequeue): an unlocked read here could start a job whose
            # handle close() has already decided must resolve as refused
            with self._lock:
                closed = self._closed
            if closed:
                # closing: refuse queued work with a clean resolution so
                # close() never waits out a backlog of unstarted jobs
                self._resolve_closed(handle)
                continue
            m = handle.metrics
            m.t_start = time.perf_counter()
            with self._lock:
                self._in_service += 1
                self._peak_inflight = max(self._peak_inflight,
                                          self._in_service)
                in_service = self._in_service
            self._m_inflight_jobs.set(in_service)
            data = None
            owned = False
            engine_closed = False
            try:
                data = handle.job.prepare(self.engine)
                owned = handle.job.data is None     # shared data outlives jobs
                handle.output = handle.job.rounds(
                    self._exec, data, m.rounds.append)
            except Exception as exc:          # record, don't kill the service
                m.error = f"{type(exc).__name__}: {exc}"
                engine_closed = isinstance(exc, EngineClosed)
                logger.warning("job %d (%s) failed: %s", m.job_id, m.kind,
                               m.error)
            finally:
                # EngineClosed is the crash itself: the children must keep
                # their installed shards so the recovery master's rejoin
                # handshake can revalidate them by digest.  Unloading here
                # would race the transport teardown and strip shards over
                # still-open connections, making rejoin unrecoverable.
                if data is not None and owned and not engine_closed:
                    self.engine.unload(data)
            m.t_done = time.perf_counter()
            status = "error" if m.error else "ok"
            if handle.journaled and not engine_closed:
                # resolution is durable before the caller can observe it
                # (errored jobs resolve too — resubmitting them on recovery
                # would only re-fail).  An EngineClosed resolution is the
                # crash itself: the admission must stay open so recovery
                # resubmits the job instead of losing it.
                self.engine._journal("job_done", {"uid": handle.uid,
                                                  "status": status})
            self._m_jobs.labels(kind=m.kind, strategy=m.strategy,
                                status=status, transport=self._tkind).inc()
            if m.error is None:
                # errored jobs may lack meaningful stamps (satellite fix in
                # metrics.py); only clean jobs feed the latency histograms
                self._m_latency.labels(strategy=m.strategy).observe(m.latency)
                self._m_queue_wait.observe(m.queue_wait)
            with self._lock:
                self._in_service -= 1
                in_service = self._in_service
                self.completed.append(m)
            self._m_inflight_jobs.set(in_service)
            handle.done.set()

    # -- reporting ----------------------------------------------------------
    @property
    def peak_inflight(self) -> int:
        with self._lock:
            return self._peak_inflight

    def report(self) -> ServiceReport:
        """Aggregate report over completed jobs.

        Throughput is measured over the first-submit → last-completion
        window, not the service's whole open time: a service that sat idle
        before its first job must not have that idleness counted against
        ``jobs_per_s``.  While jobs are still pending the window's right
        edge is "now" (work is ongoing); with no submissions yet it falls
        back to the open-time window.
        """
        now = time.perf_counter()
        with self._lock:
            jobs = list(self.completed)
            peak = self._peak_inflight
            pending = self._accepted - len(jobs)
            t_first = self._t_first_submit
        if t_first is None:
            wall = now - self._t_open
        else:
            end = now if pending > 0 else \
                max((j.t_done for j in jobs), default=now)
            wall = max(end - t_first, 1e-9)
        return ServiceReport.from_jobs(jobs, wall,
                                       max_inflight=self.max_inflight,
                                       peak_inflight=peak)
