"""Event-driven master: plan → dispatch → any-k collect → decode, pipelined.

The master drives the exact policy objects from
:mod:`repro_torch.core.strategies` against live worker threads:

* ``GeneralS2C2`` / ``BasicS2C2`` — ``strategy.plan(predicted_speeds)``
  produces the Algorithm-1 :class:`~repro_torch.core.s2c2.Allocation`; the master
  dispatches each worker its cyclic chunk range and collects chunk-level
  completions until every chunk index is covered by ≥ k distinct workers.
  If coverage is still short when the §4.3 timeout fires (mean of the first
  k finishers, floored by the master's own planned makespan, × (1+slack)),
  the master *reassigns* the missing chunk indices to already-finished
  workers — possible without any data movement because every worker holds a
  full coded partition — and cancels overdue workers whose remaining chunks
  are redundant.
* ``MDSCoded`` — the static (n, k) baseline: every worker is assigned all C
  chunks; collection stops at the k-th fastest full partition.
* ``UncodedReplication`` — uncoded partitions with Hadoop-style speculative
  re-execution on replica holders once ``detect_fraction`` of partitions
  have landed.

**Pipelining.**  Rounds are keyed by ``round_id`` on the shared event
queue: a collector thread routes every worker event to its round's own
inbox, so any number of independent rounds can be in flight at once over
the same worker pool.  :meth:`CodedExecutionEngine.matvec_async` plans,
dispatches, and returns a :class:`RoundHandle` immediately; a per-round
driver runs the §4.3 collect/timeout/reassign loop to completion.  Workers
drain their inboxes in FIFO order, so a fast worker that finishes its
share of round A immediately starts on round B instead of idling while A's
stragglers catch up — the cross-tenant analogue of the paper's
slack-squeezing.  Cancellation events carry their ``round_id`` and are
routed (or dropped, once the round retired) strictly by it, so a late
cancel ack can never count against another round.

**Work stealing.**  Worker inboxes are chunk-granular deques the master
may retract from and reorder (see :mod:`repro_torch.cluster.worker`), and the
engine runs an *idle-triggered steal pass*: whenever an event leaves a
worker idle while a round's coverage is incomplete, the round's driver
retracts queued (provably not-yet-started) coverage chunks from the most
backlogged workers and re-dispatches the same chunk indices to the idle
worker.  Stealing transfers the coverage *obligation*, never rows — every
worker computes a stolen chunk from its **own** coded shard (the S²C²
placement invariant), so the steal moves zero matrix bytes.  Steals
compose with §4.3: a retracted chunk is removed from the donor's
assignment and outstanding set atomically, so it can neither double-count
coverage nor earn the donor deadline credit, and reassign waves /
cancel-ack isolation see exactly the same per-round accounting they always
did.  ``ClusterConfig(enable_stealing=False)`` restores the pure-FIFO
engine; decoded outputs are a function of each chunk's coverage *set*
only (``CodedData.gather_used`` sorts responders), so the two modes decode
bit-identically whenever coverage matches.

Speed observation closes the paper's §6.2 loop: measured speeds
(rows · row_cost / response time) feed the shared
:class:`~repro_torch.core.predictor.SpeedPredictor`, whose predictions feed the
next round's plan.  A :class:`~repro_torch.runtime.elastic.FailureDetector`
accumulates timeout strikes and declares fail-stopped workers dead, which
zeroes their predicted speed (→ zero allocation) from then on.  Shared
predictor/detector state is updated under one lock at round boundaries.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import queue
import threading
import time
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.cluster import obs
from repro_torch.cluster.data import CodedData, ReplicatedData
from repro_torch.cluster.injectors import SlowdownInjector, TracedInjector
from repro_torch.cluster.journal import (JournalState, RoundJournal, decode_array,
                                         encode_array)
from repro_torch.cluster.metrics import RoundMetrics
from repro_torch.cluster.obs import MetricsRegistry, Tracer
from repro_torch.cluster.shm import SegmentPool, shm_prefix
from repro_torch.cluster.transport import (InProcTransport, SocketTransport,
                                           Transport)
from repro_torch.cluster.worker import (ChunkDone, ChunkTask, ComputeFn, Worker,
                                        WorkerDone, WorkerFailed, WorkerRejoined,
                                        kernel_backend, rhs_width, shard_digest)
from repro_torch.core.coding import MDSCode
from repro_torch.core.predictor import SpeedPredictor
from repro_torch.core.s2c2 import Allocation, expected_makespan
from repro_torch.core.strategies import (BasicS2C2, GeneralS2C2, MDSCoded,
                                         UncodedReplication)
from repro_torch.runtime.elastic import FailureDetector

__all__ = ["ClusterConfig", "CodedExecutionEngine", "RoundOutput",
           "RoundHandle", "EngineClosed"]

logger = logging.getLogger("repro_torch.cluster.master")


def _array_digest(arr: np.ndarray) -> str:
    """Content digest of an operand (journal replay-cache keying)."""
    arr = np.ascontiguousarray(arr)
    h = hashlib.sha256()
    h.update(str((arr.shape, str(arr.dtype))).encode())
    h.update(arr.tobytes())
    return h.hexdigest()


_STRATEGY_CLASSES = {c.__name__: c for c in (MDSCoded, BasicS2C2,
                                             GeneralS2C2)}


def _strategy_spec(strategy) -> Dict[str, Any]:
    """JSON-able (class, scalar init fields) spec of a coded strategy."""
    params = {}
    for f in dataclasses.fields(strategy):
        if not f.init:
            continue
        v = getattr(strategy, f.name)
        if isinstance(v, (int, float, str, bool)):
            params[f.name] = v
    return {"cls": type(strategy).__name__, "params": params}


def _strategy_key(strategy) -> str:
    spec = _strategy_spec(strategy)
    return spec["cls"] + ":" + ",".join(
        f"{k}={v}" for k, v in sorted(spec["params"].items()))


def _resolve_strategy(spec: Dict[str, Any]):
    cls = _STRATEGY_CLASSES[spec["cls"]]
    return cls(**spec["params"])


@dataclasses.dataclass(frozen=True)
class ClusterConfig:
    """Engine-level knobs (strategy knobs live on the strategy objects)."""

    n_workers: int
    k: int
    row_cost: float = 2.0e-5       # virtual seconds per row at speed 1.0
    timeout_slack: float = 0.15    # §4.3 slack (≈ predictor MAPE)
    max_reassign_waves: int = 4
    starvation_timeout: float = 30.0   # liveness: max event silence/round
    detector_slack: float = 4.0    # death is conservative: 5× first-k mean
    detector_dead_after: int = 3   # consecutive struck rounds ⇒ dead
    generator_kind: str = "systematic_cauchy"
    decode_with_kernel: bool = False   # opt-in: mds_decode kernel (float32)
    enable_stealing: bool = True       # idle-triggered chunk steal pass
    # how many chunks a steal pass retracts from a donor's queue:
    #   "half"  — flat half of the donor's queued chunks (rounded up to 1);
    #   "speed" — predicted-speed-proportional share, ⌈backlog ·
    #             s_idle/(s_idle+s_donor)⌉: a fast idle worker takes most of
    #             a slow donor's backlog, a slow one takes little
    steal_sizing: str = "half"
    # write-ahead journal directory: when set, the engine appends tenant
    # installs, round plans, and collected-chunk acks to
    # <journal_dir>/journal.jsonl so CodedExecutionEngine.recover() can
    # rebuild open rounds after a master crash without recompute
    journal_dir: Optional[str] = None
    # compact the journal every N retired rounds (0 = never): prunes
    # retired rounds' ack payloads behind a checkpoint record so replay
    # time is bounded by rounds in flight, not rounds ever run
    journal_compact_every: int = 0

    def __post_init__(self):
        if self.steal_sizing not in ("half", "speed"):
            raise ValueError(f"steal_sizing must be 'half' or 'speed', "
                             f"got {self.steal_sizing!r}")


@dataclasses.dataclass
class RoundOutput:
    y: np.ndarray
    metrics: RoundMetrics


class RoundHandle:
    """Future-like handle for one in-flight round (see ``matvec_async``)."""

    def __init__(self, round_id: int, strategy: str):
        self.round_id = round_id
        self.strategy = strategy
        self._done = threading.Event()
        self._output: Optional[RoundOutput] = None
        self._error: Optional[BaseException] = None

    def done(self) -> bool:
        return self._done.is_set()

    def _finish(self, output: Optional[RoundOutput],
                error: Optional[BaseException]) -> None:
        self._output = output
        self._error = error
        self._done.set()

    def result(self, timeout: Optional[float] = None) -> RoundOutput:
        if not self._done.wait(timeout):
            raise TimeoutError(f"round {self.round_id} still in flight")
        if self._error is not None:
            raise self._error
        assert self._output is not None
        return self._output


class _RoundState:
    """Mutable collection state of one in-flight round."""

    def __init__(self, n: int, k: int, chunks: int):
        self.covered_by: List[Set[int]] = [set() for _ in range(chunks)]
        self.used: List[List[int]] = [[] for _ in range(chunks)]
        self.partials: Dict[Tuple[int, int], np.ndarray] = {}
        self.need = k * chunks          # Σ max(0, k - |used[c]|)
        self.assigned: List[Set[int]] = [set() for _ in range(n)]
        # chunks with |used|<k — thread-confined to the round's driver
        # guarded_by: thread:round-driver
        self.pending: Set[int] = set(range(chunks))
        # chunks dispatched to w whose events have not yet been seen and
        # that were not retracted — the deadline clock and the steal pass
        # both key off this (retraction removes entries atomically, so a
        # stolen chunk never earns the donor deadline credit)
        # guarded_by: thread:round-driver
        self.outstanding: List[Set[int]] = [set() for _ in range(n)]
        self.chunks_done = np.zeros(n, dtype=np.int64)
        self.wasted_chunks = np.zeros(n, dtype=np.int64)
        self.finish_t = np.full(n, np.inf)      # WorkerDone wall time
        self.last_event_t = np.full(n, np.nan)
        self.dispatch_t = np.full(n, np.nan)    # latest task dispatched
        self.start_t = np.full(n, np.nan)       # latest task began serving
        self.first_start_t = np.full(n, np.nan)  # first task began serving
        self.tasks: Dict[int, ChunkTask] = {}   # latest task per worker
        self.cancelled: Set[int] = set()
        # chunks lost to a dead worker that failover could not place (no
        # idle / eligible target at verdict time) — retried whenever a
        # worker goes idle, so a verdict landing mid-burst is recovered as
        # soon as a survivor frees up instead of relying on a §4.3 wave
        # budget that may already be spent
        # guarded_by: thread:round-driver
        self.orphans: Set[int] = set()
        self.steals = 0                 # successful steal passes
        self.retracted = 0              # chunks retracted (== re-dispatched)
        self.failures: List[str] = []   # WorkerFailed reasons seen
        self.last_sweep = 0.0           # rate limiter for _steal_sweep
        # workers that failed THIS round and have not rejoined: a chunk
        # credit arriving from one of them is partition-era work replayed
        # after heal (counted as a partition credit, not recompute)
        # guarded_by: thread:round-driver
        self.failed_workers: Set[int] = set()
        # chunks a worker had in flight when it was fenced: if one of them
        # later arrives FROM THAT WORKER it is partition-era replay and is
        # credited even when the rejoin handshake (cheap control frames)
        # outran the buffered event retransmits that un-fenced the worker
        # guarded_by: thread:round-driver
        self.partition_claims: Dict[int, Set[int]] = {}
        self.partition_credits = 0
        self.recovered_chunks = 0       # coverage seeded from the journal


class _Shutdown:
    """Sentinel routed through the shared event queue to stop the collector."""


class EngineClosed(RuntimeError):
    """The engine (or its service) was shut down; the operation cannot run
    and any round in flight at close time resolves with this error."""


class _EngineClosedSentinel:
    """Dropped into every live round inbox by ``shutdown()``: the round
    driver raises :class:`EngineClosed` into its handle and exits."""


class CodedExecutionEngine:
    """N worker threads + one master, multiplexed over tenant datasets.

    Multiple rounds (of the same or different tenants) may be in flight
    concurrently; per-round state is private to the round's driver, while
    the predictor/detector/iteration state shared across rounds is guarded
    by ``_obs_lock``.
    """

    def __init__(self, cfg: ClusterConfig, injector: SlowdownInjector,
                 compute: Optional[ComputeFn] = None,
                 predictor: Optional[SpeedPredictor] = None,
                 tracer: Optional[Tracer] = None,
                 registry: Optional[MetricsRegistry] = None,
                 transport: Optional[Transport] = None,
                 device: "str | torch.device" = "cuda"):
        self.cfg = cfg
        # the master's device: the default compute backend's, the default
        # predictor's and the kernel decode's; the card unless the caller
        # passes device="cpu"
        self.device = resolve_device(device)
        if compute is None:
            compute = kernel_backend(self.device)
        # transport plane: in-process worker threads by default; pass a
        # SocketTransport/FaultyTransport for a real multi-process pool
        # (see repro_torch.cluster.transport) — the engine's planning/collection
        # logic is identical either way
        self.transport: Transport = (transport if transport is not None
                                     else InProcTransport())
        # observability plane: pass a Tracer to capture the chunk lifecycle
        # (or toggle engine.tracer.enable() later — the default tracer is
        # created disabled, so an untraced engine pays one attribute check
        # per would-be record).  The metrics registry is always on: it is
        # fed at round/job granularity, never on the per-chunk hot path.
        self.tracer = tracer if tracer is not None else Tracer(enabled=False)
        self.registry = registry if registry is not None else MetricsRegistry()
        self._declare_metrics()
        # the injected speed annotates the trace next to the observed speed
        # (TracedInjector dedups per worker and no-ops while disabled);
        # remote transports unwrap to `.inner` and re-wrap child-side
        injector = TracedInjector(injector, self.tracer)
        self.events: "queue.Queue" = queue.Queue()
        self.workers = self.transport.start(cfg, self.events, injector,
                                            compute, self.tracer,
                                            self.registry)
        # write-ahead journal (crash recovery): meta first, so a replay
        # knows the bound port + fencing epoch before any round state
        self.journal: Optional[RoundJournal] = (
            RoundJournal(cfg.journal_dir) if cfg.journal_dir else None)
        if self.journal is not None:
            self._journal("meta", {
                "n_workers": cfg.n_workers, "k": cfg.k,
                "row_cost": cfg.row_cost,
                "generator_kind": cfg.generator_kind,
                "port": getattr(self.transport, "bound_port", None),
                "epoch": getattr(self.transport, "epoch", 1),
                # shared-memory lineage id: recover() sweeps the dead
                # master's orphan segments under this prefix
                "shm_uid": getattr(self.transport, "shm_uid", None)})
        # retire counter driving periodic journal compaction
        self._retires_since_compact = 0     # guarded_by: _lock
        #: replay cache filled by recover(): (matrix_digest, x_digest,
        #: strategy_key) -> RoundHandle of the resumed round, letting the
        #: service resolve resubmitted work without recompute
        self.recovered: Dict[Tuple[str, str, str], "RoundHandle"] = {}
        #: replayed snapshot attached by recover() (service recovery reads
        #: open_jobs from it); None on a normally-constructed engine
        self.journal_state: Optional[JournalState] = None
        # shard_id -> content digest of the ORIGINAL matrix (plan records
        # reference tenants by it; filled by load_matrix and recovery)
        self._tenant_digests: Dict[str, str] = {}   # guarded_by: _lock
        self._closed = False                # guarded_by: _rounds_lock
        self.predictor = predictor or SpeedPredictor(cfg.n_workers,
                                                     device=self.device)
        self.detector = FailureDetector(cfg.n_workers, cfg.k,
                                        slack=cfg.detector_slack,
                                        dead_after=cfg.detector_dead_after)
        # `dead` is deliberately NOT lock-annotated: it only ever grows,
        # and the dispatch/steal paths take benign racy membership reads
        # (a worker missed by one read is fenced on the next) — mutation
        # and the authoritative reads happen under _obs_lock
        self.dead: Set[int] = set()
        # worker -> crash reason (logged)
        self.failed: Dict[int, str] = {}    # guarded_by: _obs_lock
        # drives the injectors
        self.iteration = 0                  # guarded_by: _obs_lock
        self._round_seq = 0                 # guarded_by: _lock
        self._tenant_seq = 0                # guarded_by: _lock
        self._lock = threading.Lock()       # seq counters only
        self._obs_lock = threading.Lock()   # predictor/detector/iteration
        # guarded_by: _obs_lock
        self._last_observed: Optional[np.ndarray] = None
        # round_id -> per-round event inbox, fed by the collector thread
        self._rounds: Dict[int, "queue.Queue"] = {}  # guarded_by: _rounds_lock
        self._rounds_lock = threading.Lock()
        # engine-wide per-worker last-event wall time (written only by the
        # collector; racy reads are benign).  Distinguishes "silent because
        # fail-stopped" from "silent because busy with another round's
        # queued work" — only the former may draw §4.4 strikes.
        self._worker_last_event = np.zeros(cfg.n_workers, dtype=np.float64)
        self._collector = threading.Thread(target=self._route_events,
                                           name="event-collector",
                                           daemon=True)
        self._collector.start()

    # ------------------------------------------------------------------
    # observability
    # ------------------------------------------------------------------

    def _declare_metrics(self) -> None:
        """Register the engine's metric families (idempotent per registry)."""
        reg = self.registry
        # engine-level families carry the transport kind so an in-process
        # and a multi-process engine sharing one registry stay separable
        # (MetricsRegistry.value() aggregates over unnamed labels, so
        # existing unlabeled reads keep working)
        self._transport_kind = getattr(self.transport, "kind", "inproc")
        self._m_rounds = reg.counter(
            "s2c2_rounds_total", "engine rounds completed",
            ("strategy", "transport"))
        self._m_chunks = reg.counter(
            "s2c2_chunks_done_total", "chunk completions", ("worker",))
        self._m_steals = reg.counter(
            "s2c2_steals_total", "successful idle-triggered steal passes")
        self._m_retracted = reg.counter(
            "s2c2_chunks_retracted_total",
            "chunks retracted from donor queues and re-dispatched")
        self._m_waves = reg.counter(
            "s2c2_reassign_waves_total", "§4.3 reassignment waves fired")
        self._m_failures = reg.counter(
            "s2c2_worker_failures_total", "worker backend crash reports")
        self._m_useful = reg.counter(
            "s2c2_useful_rows_total",
            "row-equivalents used in decodes", ("strategy", "transport"))
        self._m_wasted = reg.counter(
            "s2c2_wasted_rows_total",
            "row-equivalents computed but unused", ("strategy", "transport"))
        self._m_makespan = reg.histogram(
            "s2c2_round_makespan_seconds", "round wall time (dispatch "
            "to decoded)", ("strategy", "transport"))
        self._m_decode = reg.histogram(
            "s2c2_round_decode_seconds", "round decode time")
        self._m_inflight = reg.gauge(
            "s2c2_inflight_rounds", "rounds currently in flight")
        self._m_dead = reg.gauge(
            "s2c2_workers_dead", "workers declared dead (crash or §4.4)")
        self._m_batched = reg.counter(
            "s2c2_batched_rounds_total", "rounds executed with RHS "
            "width > 1")
        # partition/recovery plane
        self._m_partition_credits = reg.counter(
            "s2c2_partition_credits_total",
            "chunks credited from a SUSPECTED worker's partition-era "
            "replay", ("transport",))
        self._m_recoveries = reg.counter(
            "s2c2_recoveries_total",
            "master restart/recovery runs completed", ("transport",))
        self._m_recovered_chunks = reg.counter(
            "s2c2_recovered_chunks_total",
            "chunk coverage seeded from the journal (not recomputed)",
            ("transport",))
        self._m_journal_records = reg.counter(
            "s2c2_journal_records_total",
            "write-ahead journal records appended", ("kind",))
        self._m_journal_bytes = reg.counter(
            "s2c2_journal_bytes_total",
            "write-ahead journal bytes appended")
        self._m_journal_compactions = reg.counter(
            "s2c2_journal_compactions_total",
            "journal compaction passes completed")
        self._m_journal_reclaimed = reg.counter(
            "s2c2_journal_reclaimed_bytes_total",
            "journal bytes reclaimed by compaction")

    def _journal(self, kind: str, payload: Dict[str, Any]) -> None:
        """Append one write-ahead record (no-op without a journal)."""
        j = self.journal
        if j is None:
            return
        before = j.bytes_written
        j.append_record(kind, payload)
        self._m_journal_records.labels(kind=kind).inc()
        self._m_journal_bytes.inc(j.bytes_written - before)

    def _publish_round(self, m: RoundMetrics,
                       chunk_counts: Optional[np.ndarray] = None) -> None:
        """Fold one finished round into the registry (round granularity:
        one labeled increment per counter, never per chunk)."""
        tk = self._transport_kind
        self._m_rounds.labels(strategy=m.strategy, transport=tk).inc()
        self._m_makespan.labels(strategy=m.strategy,
                                transport=tk).observe(m.makespan)
        self._m_decode.observe(m.decode_time)
        self._m_useful.labels(strategy=m.strategy,
                              transport=tk).inc(m.total_useful)
        self._m_wasted.labels(strategy=m.strategy,
                              transport=tk).inc(m.total_wasted)
        if m.steals:
            self._m_steals.inc(m.steals)
        if m.retracted_chunks:
            self._m_retracted.inc(m.retracted_chunks)
        if m.reassign_waves:
            self._m_waves.inc(m.reassign_waves)
        if m.worker_failures:
            self._m_failures.inc(len(m.worker_failures))
        if m.rhs_width > 1:
            self._m_batched.inc()
        if chunk_counts is not None:
            for w, c in enumerate(chunk_counts):
                if c > 0:
                    self._m_chunks.labels(worker=w).inc(float(c))

    def dump_trace(self, path) -> int:
        """Export the buffered trace as Chrome trace-event JSON.

        Load the file in Perfetto (https://ui.perfetto.dev) or
        ``chrome://tracing``: workers render as processes with chunk
        execution spans and queue (enqueue/retract) instants, the master
        renders one lane per round with plan/dispatch/collect/decode
        spans plus §4.3 wave / steal / failover / coalesce instants, and
        injected-vs-observed speeds render as counter tracks.  Returns
        the number of exported events.
        """
        return self.tracer.dump(path)

    # ------------------------------------------------------------------
    # event routing (the pipelining substrate)
    # ------------------------------------------------------------------

    def _route_events(self) -> None:
        """Single consumer of the shared queue: fan events out by round_id.

        Events for retired rounds — late cancel acks, chunk results that
        raced the round's completion — are dropped here, which is what
        keeps one round's stragglers from ever polluting another round's
        collection state.
        """
        while True:
            ev = self.events.get()
            if isinstance(ev, _Shutdown):
                return
            worker = getattr(ev, "worker", None)
            if worker is not None:
                self._worker_last_event[worker] = getattr(
                    ev, "t", time.perf_counter())
            if isinstance(ev, WorkerFailed):
                # a crash (unlike fail-stop silence) is observable: log the
                # real reason, declare the worker dead engine-wide, and
                # broadcast to EVERY live round — each had (or may queue)
                # work on this worker and must fail over, not wait out the
                # §4.4 silence detector
                logger.warning("worker %d failed (round %d): %s",
                               ev.worker, ev.round_id, ev.error)
                with self._obs_lock:
                    self.dead.add(ev.worker)
                    self.failed[ev.worker] = ev.error
                with self._rounds_lock:
                    targets = list(self._rounds.items())
                for rid, inbox in targets:
                    inbox.put(dataclasses.replace(ev, round_id=rid))
                continue
            if isinstance(ev, WorkerRejoined):
                # the transport un-fenced a SUSPECTED worker (digest-valid
                # shards, partition healed): readmit it to planning with
                # FRESH learning state — its pre-partition speed history
                # and §4.4 strikes are both stale
                w = ev.worker
                logger.info("worker %d rejoined: readmitted to planning", w)
                with self._obs_lock:
                    self.dead.discard(w)
                    self.failed.pop(w, None)
                    self.detector.reset_worker(w)
                    self.predictor.reset_worker(w)
                    n_dead = len(self.dead)
                self._m_dead.set(n_dead)
                # broadcast so each open round stops classifying this
                # worker's future credits as partition-era replay
                with self._rounds_lock:
                    targets = list(self._rounds.items())
                for rid, inbox in targets:
                    inbox.put(dataclasses.replace(ev, round_id=rid))
                continue
            with self._rounds_lock:
                inbox = self._rounds.get(getattr(ev, "round_id", None))
            if inbox is not None:
                inbox.put(ev)

    def _register_round(self, rid: Optional[int] = None
                        ) -> Tuple[int, "queue.Queue", int]:
        if rid is None:
            with self._lock:
                self._round_seq += 1
                rid = self._round_seq
        inbox: "queue.Queue" = queue.Queue()
        with self._rounds_lock:
            # checked under the same lock shutdown() takes before it
            # snapshots live inboxes: a round is either registered (and
            # will receive the close sentinel) or refused here — never
            # silently orphaned between the two
            if self._closed:
                raise EngineClosed("engine is shut down")
            self._rounds[rid] = inbox
            inflight = len(self._rounds)
        self._m_inflight.set(inflight)
        return rid, inbox, inflight

    def _retire_round(self, rid: int) -> None:
        with self._rounds_lock:
            self._rounds.pop(rid, None)
            inflight = len(self._rounds)
        self._m_inflight.set(inflight)
        self.transport.round_retired(rid)

    def inflight_rounds(self) -> int:
        with self._rounds_lock:
            return len(self._rounds)

    def _engine_last_event(self) -> float:
        """Wall time of the most recent event from ANY worker (0 = never).

        The liveness bound must not starve a round whose tasks are merely
        queued behind other rounds' long work: as long as the pool emits
        events for anyone, FIFO guarantees this round's turn comes.
        """
        return float(self._worker_last_event.max())

    # ------------------------------------------------------------------
    # tenant data management
    # ------------------------------------------------------------------

    def load_matrix(self, a: np.ndarray, chunks: int = 20,
                    code: Optional[MDSCode] = None) -> CodedData:
        """MDS-encode ``a`` once and install one coded shard per worker."""
        with self._lock:
            self._tenant_seq += 1
            shard_id = f"t{self._tenant_seq}"
        code = code or MDSCode(self.cfg.n_workers, self.cfg.k,
                               self.cfg.generator_kind)
        data = CodedData.encode(shard_id, a, code, chunks)
        for w, worker in enumerate(self.workers):
            worker.install_shard(shard_id, data.partitions[w])
        if self.journal is not None:
            # per-worker partition digests let recovery revalidate adopted
            # children's shards without holding the rows; the matrix
            # digest keys the replay cache for resubmitted service jobs
            digest = _array_digest(a)
            with self._lock:
                self._tenant_digests[shard_id] = digest
            self._journal("install", {
                "shard_id": shard_id,
                "matrix_digest": digest,
                "n": code.n, "k": code.k,
                "generator_kind": code.kind,
                "chunks": data.chunks,
                "rows_per_chunk": data.rows_per_chunk,
                "orig_rows": data.orig_rows,
                "digests": [shard_digest(p) for p in data.partitions]})
        return data

    def load_replicated(self, a: np.ndarray,
                        placement: np.ndarray) -> ReplicatedData:
        """Partition ``a`` uncoded and install each partition's replicas."""
        with self._lock:
            self._tenant_seq += 1
            shard_id = f"t{self._tenant_seq}"
        data = ReplicatedData.partition(shard_id, a, self.cfg.n_workers,
                                        placement)
        for p in range(len(data.partitions)):
            for holder in data.placement[p]:
                self.workers[int(holder)].install_shard(
                    data.part_shard_id(p), data.partitions[p])
        return data

    def unload(self, data) -> None:
        if isinstance(data, ReplicatedData):
            for p in range(len(data.partitions)):
                for holder in data.placement[p]:
                    self.workers[int(holder)].drop_shard(data.part_shard_id(p))
        else:
            for worker in self.workers:
                worker.drop_shard(data.shard_id)

    def shutdown(self) -> None:
        """Stop the pool and the collector.  Idempotent and safe with
        rounds in flight: a second call is a no-op, and every in-flight
        handle resolves with :class:`EngineClosed` (never hangs)."""
        with self._rounds_lock:
            if self._closed:
                return
            self._closed = True
            inboxes = list(self._rounds.values())
        # wake every live round driver with the close sentinel FIRST so
        # their handles resolve even if teardown below is slow
        for inbox in inboxes:
            inbox.put(_EngineClosedSentinel())
        try:
            self.transport.shutdown()
        finally:
            self.events.put(_Shutdown())
            self._collector.join(timeout=10.0)
            if self.journal is not None:
                self.journal.close()

    def crash(self) -> None:
        """Simulate master death (recovery tests): sever the transport
        plane WITHOUT stopping the worker processes, sync the journal,
        and resolve every in-flight handle with :class:`EngineClosed`.

        The surviving children enter reconnect backoff exactly as after a
        real master SIGKILL; :meth:`recover` (same ``journal_dir``) then
        adopts them at a bumped epoch and resumes the open rounds from
        the journal floor.
        """
        with self._rounds_lock:
            if self._closed:
                return
            self._closed = True
            inboxes = list(self._rounds.values())
        for inbox in inboxes:
            inbox.put(_EngineClosedSentinel())
        if self.journal is not None:
            self.journal.sync()
            self.journal.close()
        crash = getattr(self.transport, "crash", None)
        if crash is not None:
            crash()
        else:
            self.transport.shutdown()
        self.events.put(_Shutdown())
        self._collector.join(timeout=10.0)

    # ------------------------------------------------------------------
    # master restart/recovery
    # ------------------------------------------------------------------

    @classmethod
    def recover(cls, cfg: ClusterConfig, injector: SlowdownInjector,
                compute: Optional[ComputeFn] = None,
                predictor: Optional[SpeedPredictor] = None,
                tracer: Optional[Tracer] = None,
                registry: Optional[MetricsRegistry] = None,
                transport: Optional[SocketTransport] = None,
                procs=None,
                device: "str | torch.device" = "cuda") -> "CodedExecutionEngine":
        """Rebuild a crashed master from its write-ahead journal.

        Replays ``cfg.journal_dir``, binds the journaled port at the old
        epoch + 1 in adopt mode (surviving worker processes reconnect and
        revalidate their shards by digest; no new pool is spawned), and
        resumes every journaled-but-unretired round from its ack floor —
        journaled chunks are seeded into coverage and into the
        transport's dedup sets, so they are never recomputed and their
        at-least-once replay never double-counts.  Resumed rounds are
        exposed through :attr:`recovered`, keyed by
        ``(matrix_digest, x_digest, strategy_key)``, which is how
        :meth:`repro_torch.cluster.service.JobService.recover` resolves
        resubmitted jobs without recompute.

        ``transport`` may supply a pre-configured :class:`SocketTransport`
        (e.g. a chaos-armed ``FaultyTransport``); its port/epoch/adopt
        fields are overridden from the journal.  ``procs`` optionally
        hands over the crashed transport's child process handles so
        in-process tests can still reap them at shutdown.  ``device`` is
        the master's device, as in the constructor.
        """
        if not cfg.journal_dir:
            raise ValueError("recover() requires cfg.journal_dir")
        st = RoundJournal.replay(cfg.journal_dir)
        if st.meta is None:
            raise RuntimeError(
                f"no meta record in {cfg.journal_dir}: nothing to recover")
        if transport is None:
            transport = SocketTransport()
        transport.port = int(st.meta.get("port") or 0)
        transport.epoch = int(st.meta.get("epoch", 1)) + 1
        transport.adopt = True
        transport.adopt_procs = procs
        shm_uid = st.meta.get("shm_uid")
        if shm_uid and hasattr(transport, "shm_uid"):
            # keep the lineage id: surviving children name their result
            # segments under it (the new master must be able to sweep a
            # victim's prefix), and the dead master's own orphans — it
            # crashed without unlinking — are reclaimed here, before any
            # new segment could share the prefix
            transport.shm_uid = shm_uid
            SegmentPool.sweep(shm_prefix(shm_uid, "m"))

        def seed_endpoint(ep) -> None:
            # digests let the Rejoin handshake revalidate adopted shards
            # the master no longer holds; seen-chunk floors make the
            # children's at-least-once replay idempotent across the epoch
            for sid, rec in st.installs.items():
                ep.shard_digests[sid] = rec["digests"][ep.worker_id]
            for rid, chunks in st.acks.items():
                if rid in st.retired:
                    continue
                for c, entries in chunks.items():
                    for w_, _res in entries:
                        if w_ == ep.worker_id:
                            ep.seed_seen(rid, c)
        transport.endpoint_seed = seed_endpoint

        engine = cls(cfg, injector, compute=compute, predictor=predictor,
                     tracer=tracer, registry=registry, transport=transport,
                     device=device)
        with engine._lock:
            engine._round_seq = max(engine._round_seq, st.round_floor)
            engine._tenant_seq = max(engine._tenant_seq, st.tenant_floor)
            for sid, rec in st.installs.items():
                engine._tenant_digests[sid] = rec["matrix_digest"]
        engine.journal_state = st
        open_rounds = st.open_rounds
        for rid, plan in sorted(open_rounds.items()):
            install = st.installs.get(plan["shard_id"])
            if install is None:
                logger.warning("recovery: round %d references unknown "
                               "shard %s — skipped", rid, plan["shard_id"])
                continue
            # skeleton tenant: decode needs only the code + dimensions,
            # never the partitions (those live on the adopted children)
            code = MDSCode(int(install["n"]), int(install["k"]),
                           install["generator_kind"])
            data = CodedData(shard_id=plan["shard_id"], code=code,
                             chunks=int(install["chunks"]),
                             rows_per_chunk=int(install["rows_per_chunk"]),
                             orig_rows=int(install["orig_rows"]),
                             partitions=[])
            x = decode_array(plan["x"])
            x.setflags(write=False)
            strategy = _resolve_strategy(plan["strategy"])
            handle = engine._resume_round(rid, data, x, strategy,
                                          st.acks.get(rid, {}))
            key = (plan["matrix_digest"], plan["x_digest"],
                   _strategy_key(strategy))
            engine.recovered[key] = handle
        engine._m_recoveries.labels(transport=engine._transport_kind).inc()
        if engine.tracer.enabled:
            engine.tracer.emit(
                obs.KIND_RECOVERY,
                epoch=getattr(transport, "epoch", 0),
                resumed_rounds=len(engine.recovered),
                open_jobs=len(st.open_jobs))
        logger.info("master recovered at epoch %d: %d round(s) resumed, "
                    "%d admitted job(s) pending",
                    getattr(transport, "epoch", 0), len(engine.recovered),
                    len(st.open_jobs))
        return engine

    def _resume_round(self, rid: int, data: CodedData, x: np.ndarray,
                      strategy,
                      seed_acks: Dict[int, List[Tuple[int, np.ndarray]]]
                      ) -> RoundHandle:
        """Restart one journaled round under its ORIGINAL round id.

        The id must be stable so the journal's ack floor, the endpoints'
        seen-chunk dedup sets, and any late partition-era replays all key
        onto the same round; ``_round_seq`` was already advanced past the
        journal floor, so fresh rounds never collide with a resumed id.
        """
        rid, inbox, inflight = self._register_round(rid=rid)
        handle = RoundHandle(rid, type(strategy).__name__)

        def drive() -> None:
            try:
                out = self._run_coded(rid, inbox, inflight, data, x,
                                      strategy, seed_acks=seed_acks)
                handle._finish(out, None)
            except BaseException as exc:    # surfaced via handle.result()
                handle._finish(None, exc)
            finally:
                self._retire_round(rid)

        threading.Thread(target=drive, name=f"round-{rid}-resumed",
                         daemon=True).start()
        return handle

    # ------------------------------------------------------------------
    # prediction / observation
    # ------------------------------------------------------------------

    def predicted_speeds(self) -> np.ndarray:
        with self._obs_lock:
            pred = np.asarray(self.predictor.predict(), dtype=np.float64)
            pred = np.clip(pred, 1e-3, None)
            if self.dead:
                pred[list(self.dead)] = 0.0
            return pred

    def _observe(self, speeds: np.ndarray, response: np.ndarray) -> None:
        """Feed measured speeds to the predictor and strikes to the detector.

        The detector sees a *heartbeat* view of the round: 1.0 for any
        worker that produced at least one event (however slow — slowness is
        the allocation's and §4.3's business, and the paper exploits slow
        workers rather than evicting them), inf for silent ones.  Death
        therefore requires ``dead_after`` consecutive silent rounds — the
        §4.4 fail-stop signal — and never fires on timing noise.

        Called at round boundaries, possibly from several concurrent round
        drivers — all shared learning state mutates under ``_obs_lock``.
        """
        with self._obs_lock:
            prev = (self._last_observed if self._last_observed is not None
                    else np.ones(self.cfg.n_workers))
            filled = np.where(np.isfinite(speeds), speeds, prev)
            # a censored (silent-worker) bound can only lower our belief
            silent = ~np.isfinite(response)
            filled = np.where(silent & np.isfinite(speeds),
                              np.minimum(speeds, prev), filled)
            filled = np.clip(filled, 1e-3, None)
            self._last_observed = filled
            self.predictor.observe(filled)
            heartbeat = np.where(np.isfinite(response), 1.0, np.inf)
            verdict = self.detector.evaluate(heartbeat)
            new_dead = verdict["dead"] - self.dead
            self.dead |= verdict["dead"]
            self.iteration += 1
            n_dead = len(self.dead)
        if new_dead:
            logger.info("§4.4 fail-stop verdict: workers %s declared dead",
                        sorted(new_dead))
            if self.tracer.enabled:
                for w in sorted(new_dead):
                    self.tracer.emit(obs.KIND_FAILSTOP_VERDICT, worker=w)
        self._m_dead.set(n_dead)

    # ------------------------------------------------------------------
    # public entry: matvec rounds under a strategy
    # ------------------------------------------------------------------

    def matvec(self, data, x: np.ndarray, strategy) -> RoundOutput:
        """Execute one coded (or replicated) matrix–vector round (blocking)."""
        return self.matvec_async(data, x, strategy).result()

    def matmul(self, data, x: np.ndarray, strategy) -> RoundOutput:
        """Execute one multi-RHS round against an ``(d, B)`` block (blocking)."""
        return self.matmul_async(data, x, strategy).result()

    def matvec_async(self, data, x: np.ndarray, strategy) -> RoundHandle:
        """Start one matvec round; the B=1 special case of ``matmul_async``."""
        x = np.asarray(x)
        if x.ndim != 1:
            raise ValueError(f"matvec_async needs a 1-D x, got shape "
                             f"{x.shape}; use matmul_async for (d, B) blocks")
        return self._start_round(data, x, strategy)

    def matmul_async(self, data, x: np.ndarray, strategy) -> RoundHandle:
        """Start one multi-RHS round: ``y = A @ X`` for an ``(d, B)`` block.

        The whole substrate is width-generic — a chunk is still the unit
        of dispatch/coverage/stealing/timeout, only its payload widens to
        ``(rows, B)`` — so §4.3 timeouts, work stealing, failover, and
        fail-stop detection operate exactly as for matvec rounds, while
        each worker's chunk compute becomes one BLAS-3 GEMM pass over its
        shard instead of B BLAS-2 sweeps, and one coverage pattern's
        decode weights apply to all B columns in a single contraction.
        """
        x = np.asarray(x)
        if x.ndim != 2:
            raise ValueError(f"matmul_async needs a (d, B) block, got shape "
                             f"{x.shape}")
        return self._start_round(data, x, strategy)

    def _start_round(self, data, x: np.ndarray, strategy) -> RoundHandle:
        """Plan, dispatch, and return a :class:`RoundHandle` immediately.

        The round runs on its own driver thread: planning, dispatch, any-k
        collection, §4.3 timeout/reassign, and decode all proceed while the
        caller does other work (or starts more rounds — independent rounds
        share the worker pool chunk-by-chunk).
        """
        # snapshot: the caller is free to mutate x the moment this returns
        # (iterative algorithms update in place), while workers read it for
        # the whole round.  The snapshot is marked immutable so shard-aware
        # backends may soundly identity-key their device copy of it.
        x = np.array(x, dtype=np.float64, copy=True)
        x.setflags(write=False)
        # NOTE: keep an explicit flag rather than comparing ``target is
        # self._run_coded`` below — each attribute access builds a fresh
        # bound method, so identity is always False
        coded = False
        if isinstance(strategy, UncodedReplication):
            if not isinstance(data, ReplicatedData):
                raise TypeError("UncodedReplication needs ReplicatedData "
                                "(use engine.load_replicated)")
            target = self._run_replicated
        elif isinstance(strategy, (MDSCoded, BasicS2C2, GeneralS2C2)):
            if not isinstance(data, CodedData):
                raise TypeError(f"{type(strategy).__name__} needs CodedData "
                                "(use engine.load_matrix)")
            target = self._run_coded
            coded = True
        else:
            raise TypeError(f"unsupported strategy {type(strategy).__name__}")

        if coded and self.recovered:
            # replay-cache hit: a resumed recovery round already computes
            # this exact (matrix, operand, strategy) content — hand back
            # its handle instead of planning a duplicate round, so
            # resubmitted service jobs resolve with zero recompute
            with self._lock:
                mdigest = self._tenant_digests.get(data.shard_id, "")
            key = (mdigest, _array_digest(x), _strategy_key(strategy))
            cached = self.recovered.pop(key, None)
            if cached is not None:
                logger.info("round request resolved from the recovery "
                            "replay cache (resumed round %d)",
                            cached.round_id)
                return cached

        rid, inbox, inflight = self._register_round()
        handle = RoundHandle(rid, type(strategy).__name__)
        if self.journal is not None and coded:
            # write-ahead: the plan is durable before any chunk is
            # dispatched, so a crash mid-round can always rebuild it
            with self._lock:
                mdigest = self._tenant_digests.get(data.shard_id, "")
            self._journal("plan", {
                "rid": rid, "shard_id": data.shard_id,
                "matrix_digest": mdigest,
                "x_digest": _array_digest(x),
                "x": encode_array(x),
                "strategy": _strategy_spec(strategy)})

        def drive() -> None:
            try:
                out = target(rid, inbox, inflight, data, x, strategy)
                handle._finish(out, None)
            except BaseException as exc:    # surfaced via handle.result()
                handle._finish(None, exc)
            finally:
                self._retire_round(rid)

        threading.Thread(target=drive, name=f"round-{rid}",
                         daemon=True).start()
        return handle

    # ------------------------------------------------------------------
    # coded path (MDSCoded / BasicS2C2 / GeneralS2C2)
    # ------------------------------------------------------------------

    def _plan(self, data: CodedData, strategy,
              width: int = 1) -> Tuple[Allocation, float]:
        """Allocation + planned (virtual-seconds) makespan for this round.

        ``width`` is the round's RHS width: a B-wide chunk is B× the
        virtual work (the workers stretch it accordingly), so every
        planned-makespan estimate — and with it the §4.3 deadline clock —
        scales by B.
        """
        n, k, C = data.n, data.k, data.chunks
        row_cost = self.cfg.row_cost * width
        pred = self.predicted_speeds()
        if isinstance(strategy, MDSCoded):
            count = np.full(n, C, dtype=np.int64)
            alloc = Allocation(n=n, k=k, chunks=C,
                               begin=np.zeros(n, dtype=np.int64), count=count)
            # completion is at the k-th fastest full partition
            live = np.sort(pred)[::-1]
            planned = C * data.rows_per_chunk * row_cost / \
                max(float(live[k - 1]), 1e-6)
            return alloc, planned
        if isinstance(strategy, (BasicS2C2, GeneralS2C2)):
            if strategy.chunks != C:
                raise ValueError(f"strategy.chunks={strategy.chunks} != "
                                 f"data.chunks={C}")
            alloc = strategy.plan(pred)
            planned = expected_makespan(alloc, pred, data.rows_per_chunk,
                                        row_cost)
            if not np.isfinite(planned):
                # a zero-speed (declared-dead) worker still holding chunks
                # can blow the estimate up to inf/nan: fall back to a plain
                # full-partition bound so deadlines stay meaningful
                planned = C * data.rows_per_chunk * row_cost
            return alloc, planned
        raise TypeError(f"unsupported strategy {type(strategy).__name__}")

    # thread: round-driver
    def _dispatch(self, state: _RoundState, rid: int, iteration: int,
                  data: CodedData, x: np.ndarray, worker: int,
                  chunk_ids: List[int]) -> None:
        chunk_ids = [c for c in chunk_ids if c not in state.assigned[worker]]
        if not chunk_ids:
            return
        state.assigned[worker].update(chunk_ids)
        state.outstanding[worker].update(chunk_ids)
        state.cancelled.discard(worker)     # re-tasked: await it again
        task = ChunkTask(
            round_id=rid, iteration=iteration, shard_id=data.shard_id,
            chunks=[(c, *data.chunk_range(c)) for c in chunk_ids],
            x=x, row_cost=self.cfg.row_cost, cancel=threading.Event())
        state.tasks[worker] = task
        state.finish_t[worker] = np.inf
        now = time.perf_counter()
        state.dispatch_t[worker] = now
        state.start_t[worker] = np.nan
        if self.tracer.enabled:
            for c in chunk_ids:
                self.tracer.emit(obs.KIND_ENQUEUE, worker=worker,
                                 round_id=rid, chunk_id=c, t=now)
        self.workers[worker].submit(task)

    # thread: round-driver
    def _run_coded(self, rid: int, inbox: "queue.Queue", inflight: int,
                   data: CodedData, x: np.ndarray, strategy,
                   seed_acks: Optional[
                       Dict[int, List[Tuple[int, np.ndarray]]]] = None
                   ) -> RoundOutput:
        cfg = self.cfg
        n, k, C = data.n, data.k, data.chunks
        rpc = data.rows_per_chunk
        width = rhs_width(x)            # 1 = matvec, B = multi-RHS round
        # every per-chunk work estimate this round scales by the RHS width:
        # the workers stretch B-wide chunks to B× the virtual time, so the
        # deadline clock, measured speeds, and row accounting must follow
        work_per_chunk = rpc * width * cfg.row_cost
        t_plan0 = time.perf_counter()
        alloc, planned = self._plan(data, strategy, width)
        slack = getattr(strategy, "timeout_slack", cfg.timeout_slack)
        # snapshot the injector step under the observation lock (concurrent
        # round drivers bump it in _observe): every dispatch this round —
        # including §4.3 waves and steals — must see one consistent value
        with self._obs_lock:
            iteration = self.iteration

        state = _RoundState(n, k, C)
        if seed_acks:
            # recovery: journaled chunk credits become coverage BEFORE any
            # dispatch — these chunks are never recomputed
            for c, entries in sorted(seed_acks.items()):
                for w_, res in entries:
                    if len(state.used[c]) >= k or w_ in state.covered_by[c]:
                        continue
                    state.covered_by[c].add(w_)
                    state.used[c].append(w_)
                    state.partials[(w_, c)] = res
                    state.need -= 1
                    state.recovered_chunks += 1
                if len(state.used[c]) >= k:
                    state.pending.discard(c)
            if state.recovered_chunks:
                self._m_recovered_chunks.labels(
                    transport=self._transport_kind).inc(
                        state.recovered_chunks)
                if self.tracer.enabled:
                    self.tracer.emit(obs.KIND_ROUND_RESUME, round_id=rid,
                                     recovered=state.recovered_chunks,
                                     need=state.need)
                logger.info("round %d resumed from journal: %d chunk "
                            "credit(s) seeded, need=%d", rid,
                            state.recovered_chunks, state.need)
        t0 = time.perf_counter()
        fenced: List[int] = []
        for w in range(n):
            if alloc.count[w] > 0:
                ids = [int((alloc.begin[w] + j) % C)
                       for j in range(int(alloc.count[w]))]
                # a resumed round dispatches only what the journal floor
                # does not already cover (no-op without seeded coverage)
                ids = [c for c in ids if len(state.used[c]) < k
                       and w not in state.covered_by[c]]
                if not ids:
                    continue
                if w in self.dead:
                    # the planner can still allocate to a CONFIRMED-dead
                    # worker (its verdict raced this round's plan):
                    # dispatching into the black hole would strand those
                    # coverage slots until starvation, so divert them.
                    # Only the engine-level fence counts here — a worker
                    # whose private dead flag is set but that the §4.4
                    # detector has not yet confirmed must still receive
                    # its allocation, because its SILENCE on dispatched
                    # work is exactly the evidence the detector needs.
                    state.cancelled.add(w)
                    fenced.extend(ids)
                    continue
                self._dispatch(state, rid, iteration, data, x, w, ids)
        if fenced:
            state.orphans |= self._failover_dispatch(
                state, rid, iteration, data, x, -1, sorted(set(fenced)))
        t_disp = time.perf_counter()

        active = {w for w in range(n) if alloc.count[w] > 0}
        # MDSCoded is the conventional baseline: pure any-k collection, no
        # §4.3 reassignment (that is exactly what S²C² adds on top of it) —
        # its allowance is only a generous liveness bound.
        use_timeout = isinstance(strategy, (BasicS2C2, GeneralS2C2))
        factor = 1.0 + slack if use_timeout else 20.0
        # §4.3 under pipelining: the timeout clock runs on each worker's
        # SERVICE time (from when it began the task — workers stamp
        # ``t_start`` into their events), not from dispatch.  A task still
        # queued behind other rounds' work gets a dispatch-anchored
        # allowance stretched by the live backlog instead.  At inflight=1
        # start ≈ dispatch and this reduces exactly to the paper's rule.
        window = max(planned, 1e-3)     # per-worker virtual-time allowance
        window_frozen = False           # set by k-finisher arming / waves
        floor_deadline = 0.0            # explicit extensions (no-target case)
        waves = 0
        mispredicted = False

        def current_deadline() -> float:
            backlog = max(1, self.inflight_rounds())
            dls = [floor_deadline]
            for w in state.tasks:
                # a worker with no outstanding chunks owes nothing — its
                # work completed, was retracted away, or it was cancelled /
                # declared failed.  Retracted chunks therefore never earn
                # their (former) owner deadline credit.
                if w in state.cancelled or not state.outstanding[w]:
                    continue
                if np.isfinite(state.start_t[w]):
                    dls.append(state.start_t[w] + window * factor)
                else:
                    dls.append(state.dispatch_t[w]
                               + window * factor * backlog)
            return max(dls)

        last_arrival = t0
        while state.need > 0:
            now = time.perf_counter()
            # clamp every wait to the starvation bound: starvation_timeout
            # of total event silence is a liveness failure no matter how
            # far away the (possibly enormous, e.g. dead-worker-dominated)
            # planned deadline sits
            deadline = current_deadline()
            wait = min(max(deadline - now, 1e-4), cfg.starvation_timeout)
            try:
                ev = inbox.get(timeout=wait)
                if isinstance(ev, _EngineClosedSentinel):
                    raise EngineClosed(
                        f"round {rid}: engine shut down mid-round")
            except queue.Empty:
                now = time.perf_counter()
                # liveness reference: while reassign waves remain, a busy
                # pool (events for ANY round) buys this round time — FIFO
                # guarantees its queued tasks get served.  Once waves are
                # exhausted, only events for THIS round count: other
                # tenants' progress must not keep an undecodable round
                # (> n-k fail-stopped workers) blocked forever.
                ref = (last_arrival if waves > cfg.max_reassign_waves
                       else max(last_arrival, self._engine_last_event()))
                if now - ref >= cfg.starvation_timeout:
                    # dump the stuck coverage state: which chunks are
                    # short, who covers them, who still owes them
                    detail = "; ".join(
                        f"chunk {c}: covered={sorted(state.used[c])} "
                        f"assigned={sorted(w for w in range(n) if c in state.assigned[w])} "
                        f"outstanding={sorted(w for w in range(n) if c in state.outstanding[w])}"
                        for c in range(C) if len(state.used[c]) < k)
                    raise RuntimeError(
                        f"cluster starved: round {rid} got no events for "
                        f"{cfg.starvation_timeout}s (need={state.need}; "
                        f"cancelled={sorted(state.cancelled)}; "
                        f"dead={sorted(self.dead)}; "
                        f"orphans={sorted(state.orphans)}; {detail})")
                if now < current_deadline():
                    continue            # clamped probe, deadline not reached
                if not np.isfinite(state.finish_t).any():
                    # nobody has finished yet — a §4.3 wave needs a finished
                    # worker to reassign TO, so extend instead of burning
                    # one; the clamped wait above still errors out a fully
                    # dead cluster.
                    floor_deadline = time.perf_counter() + window * factor
                    continue
                # timeout fired with coverage incomplete (§4.3 mis-prediction
                # path; for MDSCoded only the generous liveness bound)
                mispredicted = mispredicted or use_timeout
                waves += 1
                if self.tracer.enabled:
                    self.tracer.emit(obs.KIND_WAVE, round_id=rid, wave=waves,
                                     need=state.need)
                logger.debug("round %d: §4.3 wave %d fired (need=%d)",
                             rid, waves, state.need)
                if waves > cfg.max_reassign_waves:
                    # final: wait out the starvation bound (the no-events
                    # check above trips it if nothing more arrives)
                    floor_deadline = time.perf_counter() + \
                        2 * cfg.starvation_timeout
                    continue
                extra_planned = self._reassign_wave(state, rid, iteration,
                                                    data, x, t0)
                window = max(extra_planned, 1e-3)
                window_frozen = True
                floor_deadline = time.perf_counter() + window * factor
                continue

            last_arrival = time.perf_counter()
            if isinstance(ev, WorkerFailed):
                if ev.round_id != rid:
                    continue
                w = ev.worker
                state.last_event_t[w] = ev.t
                state.failures.append(f"worker {w}: {ev.error}")
                state.failed_workers.add(w)
                # remember what the worker had in flight at fence time: any
                # of these chunks arriving FROM IT later is partition-era
                # replay, however the rejoin races the event retransmits
                state.partition_claims.setdefault(w, set()).update(
                    state.outstanding[w])
                state.cancelled.add(w)      # stop awaiting it on deadlines
                lost = sorted(c for c in state.outstanding[w]
                              if len(state.used[c]) < k)
                logger.debug("round %d: worker %d failed with outstanding=%s"
                             " lost=%s", rid, w,
                             sorted(state.outstanding[w]), lost)
                state.outstanding[w].clear()
                # fail over NOW: the crashed worker's uncovered obligation
                # moves to live workers without waiting for a §4.3 timeout.
                # Whatever cannot be placed yet (all survivors busy) is
                # parked as an orphan and retried at each idle transition.
                if lost:
                    state.orphans |= self._failover_dispatch(
                        state, rid, iteration, data, x, w, lost)
                continue
            if isinstance(ev, WorkerRejoined):
                # the worker is back in planning: credits it earns from
                # here on are fresh work, not partition-era replay
                state.failed_workers.discard(ev.worker)
                continue
            if isinstance(ev, WorkerDone):
                if ev.round_id != rid:
                    continue
                if ev.cancelled:
                    # ack (cancel / eviction / fully-retracted task): the
                    # now-idle worker may be refilled by a steal.  Its
                    # outstanding ledger is NOT cleared here — the ack does
                    # not say which task it closes, and a stale drained-ack
                    # racing a fresh re-dispatch must not wipe the fresh
                    # chunks' deadline tracking.  The master clears the
                    # ledger itself at each point it abandons work
                    # (retraction, wave cancel, failure).
                    self._retry_orphans(state, rid, iteration, data, x)
                    self._steal_pass(state, rid, iteration, data, x,
                                     ev.worker)
                    continue
                # a stale done (new work dispatched since) must not mark
                # the worker finished — nor re-anchor the §4.3 deadline
                # clock to the OLD task's start — while fresh chunks are
                # pending (the fresh task's own events will stamp start_t)
                if not state.outstanding[ev.worker]:
                    state.finish_t[ev.worker] = ev.t
                    state.start_t[ev.worker] = ev.t_start
                state.last_event_t[ev.worker] = ev.t
                if not np.isfinite(state.first_start_t[ev.worker]):
                    state.first_start_t[ev.worker] = ev.t_start
                if use_timeout and not window_frozen:
                    finished = np.isfinite(state.finish_t)
                    if int(finished.sum()) >= k:
                        # §4.3: clock = mean SERVICE time of the first k
                        # responders, floored by the master's own planned
                        # makespan
                        service = state.finish_t[finished] - \
                            state.start_t[finished]
                        durations = np.sort(service)[:k]
                        window = max(float(durations.mean()), planned)
                        window_frozen = True
                # the finisher is idle (or about to be): place any parked
                # failover orphans first, then steal queued coverage from
                # the most backlogged workers into it
                self._retry_orphans(state, rid, iteration, data, x)
                self._steal_pass(state, rid, iteration, data, x, ev.worker)
                continue
            if not isinstance(ev, ChunkDone) or ev.round_id != rid:
                continue
            w, c = ev.worker, ev.chunk_id
            state.last_event_t[w] = ev.t
            state.start_t[w] = ev.t_start
            if not np.isfinite(state.first_start_t[w]):
                state.first_start_t[w] = ev.t_start
            state.chunks_done[w] += 1
            state.outstanding[w].discard(c)
            if len(state.used[c]) < k and w not in state.covered_by[c]:
                state.covered_by[c].add(w)
                state.used[c].append(w)
                state.partials[(w, c)] = ev.result
                state.need -= 1
                if self.journal is not None:
                    # durable ack: recovery seeds this credit verbatim
                    # (the result rides along for a bit-identical decode)
                    self._journal("ack", {
                        "rid": rid, "chunk": c, "worker": w,
                        "result": encode_array(ev.result)})
                claims = state.partition_claims.get(w)
                if w in state.failed_workers or (claims and c in claims):
                    # partition-era work replayed after heal: credited,
                    # never recomputed (arXiv:1804.10331's argument that
                    # every unit of completed work should count).  The
                    # claim set matters because the rejoin handshake rides
                    # cheap control frames and usually un-fences the worker
                    # BEFORE its buffered event retransmits drain.
                    if claims:
                        claims.discard(c)
                    state.partition_credits += 1
                    self._m_partition_credits.labels(
                        transport=self._transport_kind).inc()
                    if self.tracer.enabled:
                        self.tracer.emit(obs.KIND_PARTITION_CREDIT,
                                         worker=w, round_id=rid,
                                         chunk_id=c)
                if len(state.used[c]) >= k:
                    state.pending.discard(c)    # fully covered
                    state.orphans.discard(c)
            else:
                state.wasted_chunks[w] += 1
            if not state.outstanding[w]:
                # this worker just went idle-in-round: an earlier verdict
                # may have parked orphans waiting for exactly this moment
                self._retry_orphans(state, rid, iteration, data, x)
            # chunk-granular idle scan: a worker idled by ANOTHER round's
            # completion sends this round no event, so piggyback a cheap
            # sweep on our own chunk stream
            self._steal_sweep(state, rid, iteration, data, x)

        t_collected = time.perf_counter()
        # cancel everything still running — the round is decodable
        for w, task in state.tasks.items():
            if not np.isfinite(state.finish_t[w]):
                self.workers[w].cancel_task(task)
                state.cancelled.add(w)

        # decode from exactly-k coverage: gather the used results compactly
        # (no dense (n, C, rpc) scratch) and run one batched contraction
        # into a preallocated block-major buffer (CodedData.decode_compact).
        # gather_used sorts each chunk's responders, so the decode depends
        # only on the coverage SET — stealing-on and stealing-off decode
        # bit-identically whenever coverage matches.
        ids, y_parts = data.gather_used(state.used, state.partials)
        dms = data.code.decode_submats(ids)
        y = data.decode_compact(dms, y_parts,
                                use_kernel=cfg.decode_with_kernel,
                                device=self.device)
        t_done = time.perf_counter()

        if self.tracer.enabled:
            emit = self.tracer.emit
            emit(obs.KIND_ROUND_PLAN, round_id=rid, t=t_plan0,
                 dur=t0 - t_plan0, strategy=type(strategy).__name__)
            emit(obs.KIND_ROUND_DISPATCH, round_id=rid, t=t0,
                 dur=t_disp - t0)
            emit(obs.KIND_ROUND_COLLECT, round_id=rid, t=t_disp,
                 dur=t_collected - t_disp, waves=waves,
                 steals=state.steals, retracted=state.retracted)
            emit(obs.KIND_ROUND_DECODE, round_id=rid, t=t_collected,
                 dur=t_done - t_collected)

        # measured speeds: rows · row_cost / response time (§6.2's l_i/t_i).
        # Only silent workers (zero events while allocated) count as
        # non-responders — slow-but-alive workers are the *normal* case the
        # allocation handles; silence is the §4.4 fail-stop signal.
        speeds = np.full(n, np.nan)
        response = np.full(n, np.nan)
        for w in range(n):
            if w not in active or not state.assigned[w]:
                # zero allocation — or every chunk stolen away before it
                # began (an empty assignment proves nothing about speed)
                continue
            # clock from when the worker actually began serving (== t0 at
            # inflight=1): queue wait behind other rounds must not read as
            # slowness or the predictor unlearns every busy worker
            w_t0 = (state.first_start_t[w]
                    if np.isfinite(state.first_start_t[w]) else t0)
            if np.isfinite(state.finish_t[w]):
                el = max(state.finish_t[w] - w_t0, 1e-9)
                speeds[w] = len(state.assigned[w]) * work_per_chunk / el
                response[w] = el
            elif state.chunks_done[w] > 0:
                el = max(state.last_event_t[w] - w_t0, 1e-9)
                speeds[w] = state.chunks_done[w] * work_per_chunk / el
                response[w] = el
            elif self._worker_last_event[w] >= t0:
                # silent for THIS round but demonstrably alive (events for
                # other in-flight rounds): its task is just queued behind
                # other tenants' work.  No measurement, no §4.4 strike —
                # pipelined queueing must never read as fail-stop.
                continue
            else:
                # silent: censored observation — it had work for the whole
                # round and finished not even one chunk, so its speed is at
                # most one chunk per round (prevents a collapsed worker from
                # keeping its stale fast prediction forever)
                speeds[w] = work_per_chunk / max(t_done - t0, 1e-9)
                response[w] = np.inf
        # inactive workers: neutral response (neither skews the first-k mean
        # nor draws a strike)
        finite = response[np.isfinite(response)]
        neutral = float(np.median(finite)) if finite.size else 0.0
        response = np.where(np.isnan(response), neutral, response)
        if self.tracer.enabled:
            # measured speeds render as counter tracks next to the
            # injected ones (TracedInjector) — the misprediction gap
            for w in range(n):
                if np.isfinite(speeds[w]):
                    self.tracer.emit(obs.KIND_OBS_SPEED, worker=w,
                                     round_id=rid, t=t_done,
                                     speed=float(speeds[w]))
        self._observe(speeds, response)

        # row accounting is in row-equivalents: a B-wide chunk is rpc·B
        # rows of work, so useful/wasted stay comparable across widths
        useful = np.array(
            [sum(1 for c in range(C) if w in state.covered_by[c])
             for w in range(n)], dtype=np.float64) * rpc * width
        wasted = state.wasted_chunks.astype(np.float64) * rpc * width
        metrics = RoundMetrics(
            round_id=rid, strategy=type(strategy).__name__,
            makespan=t_done - t0, compute_time=t_collected - t0,
            decode_time=t_done - t_collected, useful_rows=useful,
            wasted_rows=wasted,
            speeds_measured=np.where(np.isfinite(speeds), speeds, 0.0),
            planned_makespan=planned, reassign_waves=waves,
            mispredicted=mispredicted,
            cancelled_workers=len(state.cancelled),
            inflight=inflight, rhs_width=width,
            steals=state.steals, retracted_chunks=state.retracted,
            worker_failures=tuple(state.failures),
            recovered_chunks=state.recovered_chunks,
            partition_credits=state.partition_credits)
        self._publish_round(metrics, state.chunks_done)
        if self.journal is not None:
            self._journal("retire", {"rid": rid})
            self._maybe_compact()
        return RoundOutput(y=y, metrics=metrics)

    def _maybe_compact(self) -> None:
        """Compact the journal every ``journal_compact_every`` retires."""
        every = self.cfg.journal_compact_every
        if not every or self.journal is None:
            return
        with self._lock:
            self._retires_since_compact += 1
            if self._retires_since_compact < every:
                return
            self._retires_since_compact = 0
        stats = self.journal.compact()
        self._m_journal_compactions.inc()
        self._m_journal_reclaimed.inc(stats["bytes_reclaimed"])

    # thread: round-driver
    def _reassign_wave(self, state: _RoundState, rid: int, iteration: int,
                       data: CodedData, x: np.ndarray, t0: float) -> float:
        """§4.3: re-target missing chunk indices to available workers.

        Returns the planned (virtual-seconds) makespan of the extra work.
        Workers still running whose remaining chunks are all redundant are
        cancelled (their completed chunks stay counted — the engine keeps
        real partial results, which is strictly better than the paper's
        discard accounting).
        """
        n, k, C = data.n, data.k, data.chunks
        pending = [c for c in range(C) if len(state.used[c]) < k]
        finished = [w for w in range(n)
                    if np.isfinite(state.finish_t[w]) and w not in self.dead
                    and not self.workers[w].dead]
        # fastest measured first
        rate = state.chunks_done / np.maximum(
            np.where(np.isfinite(state.finish_t),
                     state.finish_t - t0, time.perf_counter() - t0), 1e-9)
        finished.sort(key=lambda w: -rate[w])
        extra: Dict[int, List[int]] = {w: [] for w in finished}
        short: Set[int] = set()
        for c in pending:
            needed = k - len(state.used[c])
            for w in finished:
                if needed == 0:
                    break
                if c in state.assigned[w] or w in state.covered_by[c]:
                    continue
                extra[w].append(c)
                needed -= 1
            if needed > 0:
                short.add(c)    # must wait for a straggler covering it
        # cancel overdue workers not needed for the still-short chunks
        for w in range(n):
            if not np.isfinite(state.finish_t[w]) and w in state.tasks \
                    and w not in state.cancelled:
                still_needed = any(c in short for c in state.assigned[w])
                if not still_needed:
                    self.workers[w].cancel_task(state.tasks[w])
                    state.cancelled.add(w)
                    # master-initiated abandonment clears the ledger HERE
                    # (never from the ack, which could race a re-dispatch)
                    state.outstanding[w].clear()
        max_extra = 0
        for w, ids in extra.items():
            if ids:
                state.orphans.difference_update(ids)
                self._dispatch(state, rid, iteration, data, x, w, ids)
                # recovery work is deadline-critical: jump the cross-round
                # FIFO instead of queueing behind other tenants
                self.workers[w].promote_round(rid)
                max_extra = max(max_extra, len(ids))
        row_cost = self.cfg.row_cost * rhs_width(x)
        planned_extra = max_extra * data.rows_per_chunk * row_cost
        if short:
            planned_extra = max(planned_extra,
                                C * data.rows_per_chunk * row_cost)
        return planned_extra

    # ------------------------------------------------------------------
    # chunk-granular work stealing
    # ------------------------------------------------------------------

    # thread: round-driver
    def _steal_pass(self, state: _RoundState, rid: int, iteration: int,
                    data: CodedData, x: np.ndarray, wi: int) -> int:
        """Refill idle worker ``wi`` with coverage stolen from backlogs.

        Retracts queued (provably not-yet-started) chunks of THIS round
        from the most backlogged donor and re-dispatches the same chunk
        indices to ``wi``, which computes them from its **own** coded
        shard — stealing moves the coverage obligation, not rows, so no
        data ever travels (the S²C² placement constraint).  Returns the
        number of chunks stolen.  Composition with §4.3 is by accounting:
        a retracted chunk leaves the donor's ``assigned``/``outstanding``
        sets in the same breath, so it can neither double-count coverage
        (the any-k guard still sees one completion per worker per chunk)
        nor hold the donor's deadline open.
        """
        cfg = self.cfg
        if not cfg.enable_stealing or state.need <= 0:
            return 0
        # workers[wi].dead catches a silent fail-stop the §4.4 detector has
        # not yet confirmed — a fail-stopped worker consumes dispatched
        # items without ever emitting events, so stealing into it would
        # move chunks from a live donor into a black hole
        if wi in self.dead or self.workers[wi].dead:
            return 0
        if state.outstanding[wi] or not self.workers[wi].idle():
            return 0
        # state.pending is maintained incrementally (chunks still short of
        # k coverage), so this scan shrinks with the round instead of
        # re-walking all C chunks on every event
        eligible = {c for c in state.pending
                    if wi not in state.covered_by[c]
                    and c not in state.assigned[wi]}
        if not eligible:
            return 0
        donors = [w for w in range(data.n)
                  if w != wi and state.outstanding[w] & eligible]
        # most backlogged first — TOTAL queue length (all rounds), because
        # that is what actually delays the donor's queued chunks
        donors.sort(key=lambda w: -self.workers[w].backlog())
        # speed-aware sizing uses one predicted-speed snapshot per pass
        pred = (self.predicted_speeds() if cfg.steal_sizing == "speed"
                else None)
        for wb in donors:
            queued = self.workers[wb].backlog(rid)
            if queued <= 0:
                continue        # everything already executing / completed
            want = sorted(state.outstanding[wb] & eligible)
            if pred is not None:
                # predicted-speed share: the idle worker takes the fraction
                # of the donor's backlog it would finish first if the two
                # split it in proportion to their speeds — a fast idle
                # worker drains most of a straggler's queue in one pass, a
                # slow one takes a sliver instead of half
                s_idle = max(float(pred[wi]), 1e-3)
                s_donor = max(float(pred[wb]), 1e-3)
                cap = int(np.ceil(queued * s_idle / (s_idle + s_donor)))
            else:
                # flat half of the donor's queue: the donor keeps the work
                # it can start soonest, wi fills from the tail that would
                # otherwise run last
                cap = queued // 2
            taken = self.workers[wb].retract(rid, want, limit=max(1, cap))
            if not taken:
                continue        # raced: the executor got there first
            for c in taken:
                state.assigned[wb].discard(c)
                state.outstanding[wb].discard(c)
            state.retracted += len(taken)
            state.steals += 1
            if self.tracer.enabled:
                self.tracer.emit(obs.KIND_STEAL, worker=wi, round_id=rid,
                                 donor=wb, n=len(taken),
                                 chunks=tuple(taken))
            logger.debug("round %d: worker %d stole chunks %s from "
                         "worker %d", rid, wi, taken, wb)
            self._dispatch(state, rid, iteration, data, x, wi, taken)
            return len(taken)
        return 0

    # thread: round-driver
    def _steal_sweep(self, state: _RoundState, rid: int, iteration: int,
                     data: CodedData, x: np.ndarray) -> None:
        """Offer stolen work to every currently idle worker.

        Runs on the round driver's chunk stream; cost is one lock-guarded
        ``idle()`` probe per worker, and the per-idle-worker eligibility
        scan is bounded by the shrinking ``state.pending`` set.
        """
        if not self.cfg.enable_stealing or state.need <= 0 \
                or not state.pending:
            return
        # rate-limit the piggybacked sweep: the per-worker idle() probes
        # contend with the executors' own queue locks, and an idle worker
        # is also refilled immediately by its own WorkerDone trigger — the
        # sweep only exists to catch workers idled by OTHER rounds
        now = time.perf_counter()
        if now - state.last_sweep < 2e-3:
            return
        state.last_sweep = now
        for wi in range(data.n):
            if self.workers[wi].idle():
                self._steal_pass(state, rid, iteration, data, x, wi)

    # thread: round-driver
    def _failover_dispatch(self, state: _RoundState, rid: int,
                           iteration: int, data: CodedData, x: np.ndarray,
                           failed_w: int, chunk_ids: List[int]) -> Set[int]:
        """Re-dispatch a crashed worker's uncovered chunks immediately.

        Targets are workers with nothing outstanding for this round (so the
        one-active-task-per-round invariant holds), alive, and not already
        computing/covering the chunk; least backlogged first.  Returns the
        chunks that found no legal target — the caller parks them in
        ``state.orphans`` and they are retried at every idle transition
        (``_retry_orphans``), so a verdict that lands while every survivor
        is busy still gets its lost coverage re-placed once one frees up.
        """
        per_target: Dict[int, List[int]] = {}
        unplaced: Set[int] = set()
        for c in chunk_ids:
            if len(state.used[c]) >= data.k:
                continue                        # covered since it was lost
            cands = [w for w in range(data.n)
                     if w != failed_w and w not in self.dead
                     and not self.workers[w].dead
                     and not state.outstanding[w]
                     and c not in state.assigned[w]
                     and w not in state.covered_by[c]]
            if not cands:
                unplaced.add(c)
                continue
            w = min(cands, key=lambda w_: (self.workers[w_].backlog()
                                           + len(per_target.get(w_, []))))
            per_target.setdefault(w, []).append(c)
        for w, ids in per_target.items():
            if self.tracer.enabled:
                self.tracer.emit(obs.KIND_FAILOVER, worker=w, round_id=rid,
                                 failed=failed_w, n=len(ids),
                                 chunks=tuple(ids))
            logger.debug("round %d: failover of chunks %s from crashed "
                         "worker %d to worker %d", rid, ids, failed_w, w)
            self._dispatch(state, rid, iteration, data, x, w, ids)
            self.workers[w].promote_round(rid)
        return unplaced

    # thread: round-driver
    def _retry_orphans(self, state: _RoundState, rid: int, iteration: int,
                       data: CodedData, x: np.ndarray) -> None:
        """Retry placement of failover orphans (cheap no-op when empty)."""
        if not state.orphans:
            return
        state.orphans = self._failover_dispatch(
            state, rid, iteration, data, x, -1, sorted(state.orphans))

    def worker_stats(self) -> Dict[str, np.ndarray]:
        """Per-worker busy/idle/retraction counters (pool instrumentation)."""
        now = time.perf_counter()
        return {
            "busy_s": np.array([w.busy_s for w in self.workers]),
            # idle_seconds includes each worker's in-progress wait, so the
            # tail idle after a worker's last task is counted too
            "idle_s": np.array([w.idle_seconds(now) for w in self.workers]),
            "retracted_chunks": np.array([w.retracted_total
                                          for w in self.workers]),
        }

    # ------------------------------------------------------------------
    # uncoded replication path (speculative re-execution)
    # ------------------------------------------------------------------

    def _run_replicated(self, rid: int, inbox: "queue.Queue", inflight: int,
                        data: ReplicatedData, x: np.ndarray,
                        strategy: UncodedReplication) -> RoundOutput:
        cfg = self.cfg
        n_parts = len(data.partitions)
        n = cfg.n_workers
        # same snapshot rule as the coded path: _observe mutates iteration
        # under _obs_lock from every concurrent driver
        with self._obs_lock:
            iteration = self.iteration
        t0 = time.perf_counter()
        rpp = data.rows_per_part
        width = rhs_width(x)            # replicated rounds are width-generic
        work_per_part = rpp * width * cfg.row_cost

        results: List[Optional[np.ndarray]] = [None] * n_parts
        attempt_owner: Dict[int, List[int]] = {p: [] for p in range(n_parts)}
        tasks: Dict[Tuple[int, int], ChunkTask] = {}
        busy: Set[int] = set()
        finish_t = np.full(n, np.nan)
        rows_done = np.zeros(n)
        wasted = np.zeros(n)

        def launch(p: int, w: int) -> None:
            task = ChunkTask(round_id=rid, iteration=iteration,
                             shard_id=data.part_shard_id(p),
                             chunks=[(p, 0, rpp)], x=x,
                             row_cost=cfg.row_cost, cancel=threading.Event())
            tasks[(p, w)] = task
            attempt_owner[p].append(w)
            busy.add(w)
            if self.tracer.enabled:
                self.tracer.emit(obs.KIND_ENQUEUE, worker=w, round_id=rid,
                                 chunk_id=p)
            self.workers[w].submit(task)

        for p in range(n_parts):
            launch(p, int(data.placement[p][0]))
        t_disp = time.perf_counter()

        spec_budget = strategy.max_speculative
        n_done = 0
        deadline = t0 + n_parts * work_per_part * 20    # liveness bound
        speculated = False
        last_arrival = t0
        while n_done < n_parts:
            now = time.perf_counter()
            wait = min(max(deadline - now, 1e-4), cfg.starvation_timeout)
            try:
                ev = inbox.get(timeout=wait)
                if isinstance(ev, _EngineClosedSentinel):
                    raise EngineClosed(
                        f"replicated round {rid}: engine shut down mid-round")
            except queue.Empty:
                now = time.perf_counter()
                if now - max(last_arrival, self._engine_last_event()) >= \
                        cfg.starvation_timeout:
                    raise RuntimeError(
                        f"replicated round {rid}: no events for "
                        f"{cfg.starvation_timeout}s "
                        f"({n_parts - n_done} partitions pending)")
                if now < deadline:
                    continue            # clamped probe, deadline not reached
                # a primary died with no idle replica holder: force-launch
                # every pending partition on ANY idle alive worker holding a
                # replica.  Keep waiting while an already-launched attempt
                # is still in flight on a worker not known dead — the
                # deadline here is VIRTUAL time, and a loaded host can
                # stretch real service far past it, so in-flight attempts
                # are only abandoned on REAL silence: if the round has seen
                # no event at all for starvation_timeout, the attempts are
                # presumed fail-stopped.  (An extension-count cap here used
                # to mis-declare busy-but-alive attempts unrecoverable
                # whenever the host was contended.)
                progressed = False
                in_flight = False
                for p in range(n_parts):
                    if results[p] is not None:
                        continue
                    holders = [int(h) for h in data.placement[p]
                               if int(h) not in busy
                               and int(h) not in self.dead
                               and int(h) not in attempt_owner[p]]
                    if holders:
                        launch(p, holders[0])
                        progressed = True
                    elif any(w in busy and w not in self.dead
                             for w in attempt_owner[p]):
                        in_flight = True
                if not progressed and not in_flight:
                    raise RuntimeError(
                        f"replicated round {rid}: {n_parts - n_done} "
                        "partitions unrecoverable (all replicas dead?)")
                if not progressed and \
                        now - last_arrival >= cfg.starvation_timeout:
                    raise RuntimeError(
                        f"replicated round {rid}: {n_parts - n_done} "
                        "partitions stuck — in-flight attempts silent for "
                        f"{cfg.starvation_timeout}s (fail-stopped replicas?)")
                deadline = time.perf_counter() + n_parts * work_per_part * 20
                continue

            last_arrival = time.perf_counter()
            if isinstance(ev, WorkerFailed):
                if ev.round_id != rid:
                    continue
                # crashed worker: relaunch its pending partitions on idle
                # alive replica holders right away (no waiting for the
                # liveness probe; the collector already marked it dead)
                busy.discard(ev.worker)
                for p in range(n_parts):
                    if results[p] is not None or \
                            ev.worker not in attempt_owner[p]:
                        continue
                    holders = [int(h) for h in data.placement[p]
                               if int(h) not in busy
                               and int(h) not in self.dead
                               and int(h) not in attempt_owner[p]]
                    if holders:
                        launch(p, holders[0])
                continue
            if isinstance(ev, WorkerDone):
                if ev.round_id == rid:
                    busy.discard(ev.worker)     # idle again either way
                    if not ev.cancelled:
                        finish_t[ev.worker] = ev.t
                continue
            if not isinstance(ev, ChunkDone) or ev.round_id != rid:
                continue
            p, w = ev.chunk_id, ev.worker
            rows_done[w] += rpp
            if results[p] is None:
                results[p] = ev.result
                n_done += 1
                # losers of the race: cancel + account their work as wasted
                for ow in attempt_owner[p]:
                    if ow != w and (p, ow) in tasks:
                        self.workers[ow].cancel_task(tasks[(p, ow)])
            else:
                wasted[w] += rpp

            # LATE-style speculation once detect_fraction of tasks landed
            if (n_done >= strategy.detect_fraction * n_parts
                    and spec_budget > 0):
                speculated = True
                pending = [p2 for p2 in range(n_parts) if results[p2] is None]
                for p2 in pending:
                    if spec_budget == 0:
                        break
                    idle_holders = [
                        int(h) for h in data.placement[p2]
                        if int(h) not in busy and int(h) not in self.dead
                        and int(h) not in attempt_owner[p2]]
                    if idle_holders:
                        launch(p2, idle_holders[0])
                        spec_budget -= 1

        t_collected = time.perf_counter()
        for (_p, w), task in tasks.items():
            self.workers[w].cancel_task(task)
        y = data.assemble(results)
        t_done = time.perf_counter()

        if self.tracer.enabled:
            emit = self.tracer.emit
            emit(obs.KIND_ROUND_DISPATCH, round_id=rid, t=t0,
                 dur=t_disp - t0, strategy=type(strategy).__name__)
            emit(obs.KIND_ROUND_COLLECT, round_id=rid, t=t_disp,
                 dur=t_collected - t_disp, speculated=speculated)
            emit(obs.KIND_ROUND_DECODE, round_id=rid, t=t_collected,
                 dur=t_done - t_collected)

        speeds = np.full(n, np.nan)
        response = np.full(n, np.nan)
        primaries = {int(data.placement[p][0]) for p in range(n_parts)}
        for w in range(n):
            if w not in primaries:
                continue
            if rows_done[w] > 0:
                # responded: the round may end before its WorkerDone drains,
                # so fall back to collection end as the response time
                el = max((finish_t[w] if np.isfinite(finish_t[w])
                          else t_collected) - t0, 1e-9)
                speeds[w] = rows_done[w] * width * cfg.row_cost / el
                response[w] = el
            elif self._worker_last_event[w] >= t0:
                continue    # alive on other rounds: no measurement/strike
            else:
                # silent primary: censored bound (see coded path)
                speeds[w] = work_per_part / max(t_done - t0, 1e-9)
                response[w] = np.inf
        finite = response[np.isfinite(response)]
        neutral = float(np.median(finite)) if finite.size else 0.0
        response = np.where(np.isnan(response), neutral, response)
        self._observe(speeds, response)

        # row-equivalents, matching the coded path: width scales the work
        useful = (rows_done - wasted) * width
        metrics = RoundMetrics(
            round_id=rid, strategy=type(strategy).__name__,
            makespan=t_done - t0, compute_time=t_collected - t0,
            decode_time=t_done - t_collected, useful_rows=useful,
            wasted_rows=wasted * width,
            speeds_measured=np.where(np.isfinite(speeds), speeds, 0.0),
            planned_makespan=work_per_part,
            mispredicted=speculated,
            inflight=inflight, rhs_width=width)
        self._publish_round(metrics)
        return RoundOutput(y=y, metrics=metrics)
