"""Observability plane for the cluster engine: tracing, metrics, logging.

Three instruments, all overhead-guarded so a production round pays nothing
measurable when they are off:

* :class:`Tracer` — a bounded, thread-safe ring buffer of typed
  :class:`TraceRecord` events with monotonic (``perf_counter``)
  timestamps.  Emission is one ``enabled`` check plus a GIL-atomic deque
  append; every call site in the engine additionally guards with
  ``if tracer.enabled:`` so a disabled tracer costs a single attribute
  read per would-be event and never packs kwargs.  The buffer is a ring
  (``capacity`` newest records win) so a tracer can stay attached to a
  long-lived service without unbounded growth.
* :func:`chrome_trace_events` / :meth:`Tracer.dump` — export the record
  stream as Chrome trace-event JSON (loadable in Perfetto /
  ``chrome://tracing``): each worker renders as its own process with a
  compute lane (chunk spans) and a queue lane (enqueue/retract instants),
  the master renders as pid 0 with one thread lane per round (plan /
  dispatch / collect / decode spans, §4.3 wave and steal and failover
  instants, coalescer merges, §4.4 fail-stop verdicts), and
  injected-vs-observed worker speeds render as counter tracks so a
  mispredicted straggler is visually attributable.
* :class:`MetricsRegistry` — Prometheus-style :class:`Counter` /
  :class:`Gauge` / :class:`Histogram` families with per-label-set
  children.  Increments are lock-striped (each labeled child carries its
  own lock, so concurrent rounds touching different strategies/workers
  never contend), histograms use fixed log-spaced buckets, and
  :meth:`MetricsRegistry.render` emits the Prometheus text exposition
  format.  The engine and :class:`~repro_torch.cluster.service.JobService`
  publish into the registry continuously;
  :meth:`~repro_torch.cluster.metrics.ServiceReport.from_registry` rebuilds the
  service report as a view over the registry.

Logging: :func:`configure_logging` wires per-component child loggers
(``repro_torch.cluster.master`` / ``.worker`` / ``.service``) to stderr with
round/chunk ids in the message, so DEBUG log lines cross-reference trace
records one-to-one.
"""

from __future__ import annotations

import json
import logging
import sys
import threading
import time
from collections import deque
from typing import (Dict, Iterable, List, NamedTuple, Optional, Sequence,
                    Tuple)

__all__ = [
    "TraceRecord", "Tracer", "NULL_TRACER", "chrome_trace_events",
    "export_chrome_trace",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "log_buckets",
    "configure_logging",
]


# ---------------------------------------------------------------------------
# tracing
# ---------------------------------------------------------------------------

class TraceRecord(NamedTuple):
    """One typed trace event.

    ``worker``/``round_id``/``chunk_id`` are -1 when not applicable
    (master-scope or engine-scope events).  ``dur`` is the span length in
    seconds (0.0 for instant events).  ``args`` is a sorted tuple of
    ``(key, value)`` annotation pairs — a tuple, not a dict, so records
    stay cheap to build on the hot path and hashable for tests.
    """

    kind: str
    t: float
    worker: int
    round_id: int
    chunk_id: int
    dur: float
    args: Tuple[Tuple[str, object], ...]


#: chunk lifecycle: enqueue (master → worker inbox) → chunk (worker-stamped
#: execution span) → or retract (provably never started).
KIND_ENQUEUE = "enqueue"
KIND_CHUNK = "chunk"
KIND_RETRACT = "retract"
#: master decisions, one instant each
KIND_STEAL = "steal"
KIND_WAVE = "wave"
KIND_FAILOVER = "failover"
KIND_COALESCE = "coalesce"
KIND_FAILSTOP_VERDICT = "failstop_verdict"
#: worker-side terminal / ack instants
KIND_CANCEL_ACK = "cancel_ack"
KIND_FAIL_STOP = "fail_stop"           # injected s == 0 (silent death)
KIND_WORKER_FAILED = "worker_failed"   # backend crash (loud death)
#: round phase spans (pid 0, one lane per round)
KIND_ROUND_PLAN = "round_plan"
KIND_ROUND_DISPATCH = "round_dispatch"
KIND_ROUND_COLLECT = "round_collect"
KIND_ROUND_DECODE = "round_decode"
#: speed annotations (rendered as counter tracks)
KIND_INJ_SPEED = "inj_speed"
KIND_OBS_SPEED = "obs_speed"
#: transport-plane instants (multi-process mode): a worker connection was
#: lost, a worker reconnected after backoff, or the chaos layer injected a
#: fault (drop/dup/delay/reorder/kill — the action rides in ``args``)
KIND_CONN_LOST = "conn_lost"
KIND_RECONNECT = "reconnect"
KIND_CHAOS = "chaos"
#: partition/recovery instants: a SUSPECTED worker completed the Rejoin
#: handshake and was un-fenced; a chunk computed during a partition was
#: credited to a still-open round on heal; a recovered master resumed a
#: journaled round from its ack floor; recovery itself completed
KIND_REJOIN = "rejoin"
KIND_PARTITION_CREDIT = "partition_credit"
KIND_ROUND_RESUME = "round_resume"
KIND_RECOVERY = "recovery"
#: shared-memory data-plane instants: a payload moved into (share) or out
#: of (attach) a /dev/shm segment — name/bytes/generation ride in ``args``
KIND_SHM = "shm"

SPAN_KINDS = frozenset({KIND_CHUNK, KIND_ROUND_PLAN, KIND_ROUND_DISPATCH,
                        KIND_ROUND_COLLECT, KIND_ROUND_DECODE})
COUNTER_KINDS = frozenset({KIND_INJ_SPEED, KIND_OBS_SPEED})
MASTER_KINDS = frozenset({KIND_STEAL, KIND_WAVE, KIND_FAILOVER,
                          KIND_COALESCE, KIND_FAILSTOP_VERDICT,
                          KIND_PARTITION_CREDIT, KIND_ROUND_RESUME,
                          KIND_RECOVERY,
                          KIND_ROUND_PLAN, KIND_ROUND_DISPATCH,
                          KIND_ROUND_COLLECT, KIND_ROUND_DECODE})


class Tracer:
    """Thread-safe bounded ring buffer of :class:`TraceRecord` events.

    ``enabled=False`` makes :meth:`emit` a single attribute check; the
    engine's call sites additionally pre-check ``tracer.enabled`` so the
    disabled path never even builds the kwargs.  Appends rely on
    ``deque.append`` being atomic under the GIL — no lock on the emit
    path; snapshots copy under a lock for a consistent read.
    """

    __slots__ = ("enabled", "capacity", "_buf", "_lock")

    def __init__(self, capacity: int = 1 << 18, enabled: bool = True):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.enabled = enabled
        self.capacity = capacity
        # the ring itself; consistent multi-record reads (snapshot/clear)
        # take the lock, while the emit/drain/absorb hot paths ride
        # single GIL-atomic deque ops by contract — those sites carry
        # explicit s2c2lint suppressions documenting it
        # guarded_by: _lock
        self._buf: "deque[TraceRecord]" = deque(maxlen=capacity)
        self._lock = threading.Lock()

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def emit(self, kind: str, worker: int = -1, round_id: int = -1,
             chunk_id: int = -1, t: Optional[float] = None,
             dur: float = 0.0, **args) -> None:
        """Record one event (no-op when disabled)."""
        if not self.enabled:
            return
        # s2c2lint: ignore[S2C201] hot-path contract: one GIL-atomic
        # deque.append, no lock — the PR-6 overhead budget for emission
        self._buf.append(TraceRecord(
            kind, time.perf_counter() if t is None else t,
            worker, round_id, chunk_id, dur,
            tuple(sorted(args.items())) if args else ()))

    def __len__(self) -> int:
        # s2c2lint: ignore[S2C201] single GIL-atomic len() probe; an
        # approximate size under concurrent emits is the documented API
        return len(self._buf)

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()

    def snapshot(self) -> List[TraceRecord]:
        """Consistent copy of the buffered records, oldest first."""
        with self._lock:
            return list(self._buf)

    def drain(self) -> List[TraceRecord]:
        """Atomically remove and return the buffered records, oldest first.

        Used by remote workers to forward their record stream in batches:
        ``popleft`` is GIL-atomic against concurrent ``emit`` appends, so
        a record emitted mid-drain is never lost (it simply rides the next
        batch).
        """
        out: List[TraceRecord] = []
        # s2c2lint: ignore[S2C201] popleft is GIL-atomic against emit's
        # append (see docstring): records emitted mid-drain ride the next
        # batch, and taking the lock here would stall every emitter
        buf = self._buf
        while True:
            try:
                out.append(buf.popleft())
            except IndexError:
                return out

    def absorb(self, records: Iterable[TraceRecord],
               offset: float = 0.0) -> int:
        """Append externally produced records, rebasing their clocks.

        ``offset`` is added to every record's timestamp — the master uses
        the per-worker clock offset it estimated from handshake/heartbeat
        samples, so remote workers' worker-stamped monotonic times land on
        the master's ``perf_counter`` axis and one Chrome trace renders a
        single coherent timeline.  No-op while disabled; returns the
        number of records absorbed.
        """
        if not self.enabled:
            return 0
        # s2c2lint: ignore[S2C201] same GIL-atomic append contract as
        # emit — absorb is the remote workers' bulk emit path
        append = self._buf.append
        n = 0
        for r in records:
            append(r._replace(t=r.t + offset))
            n += 1
        return n

    def dump(self, path) -> int:
        """Write the buffer as Chrome trace-event JSON; returns #events."""
        return export_chrome_trace(self.snapshot(), path)


#: shared disabled tracer — the engine default, so every emit site can
#: unconditionally hold a tracer and pay one attribute check when tracing
#: is off
NULL_TRACER = Tracer(capacity=1, enabled=False)


def _pid(worker: int) -> int:
    """Chrome pid for a record: 0 = master, 1 + worker id per worker."""
    return 0 if worker < 0 else 1 + worker


def chrome_trace_events(records: Sequence[TraceRecord],
                        t_base: Optional[float] = None) -> List[dict]:
    """Map trace records to Chrome trace-event dicts (``ph`` X/i/C/M).

    Layout: pid 0 is the master (one tid lane per round — phase spans and
    decision instants render per round); pid ``1 + w`` is worker ``w``
    with tid 0 the compute lane (chunk spans, terminal instants) and tid 1
    the queue lane (enqueue/retract instants).  Speed annotations become
    per-worker counter tracks.  Timestamps are rebased to the earliest
    record and expressed in microseconds, as the format requires.
    """
    if not records:
        return []
    if t_base is None:
        t_base = min(r.t for r in records)
    events: List[dict] = []
    pids: Dict[int, str] = {}
    master_tids: Dict[int, str] = {}
    for r in records:
        ts = (r.t - t_base) * 1e6
        args = dict(r.args)
        if r.round_id >= 0:
            args["round"] = r.round_id
        if r.chunk_id >= 0:
            args["chunk"] = r.chunk_id
        if r.kind in MASTER_KINDS:
            pid, tid = 0, max(r.round_id, 0)
            pids.setdefault(0, "master")
            master_tids.setdefault(tid, f"round {tid}")
            if r.worker >= 0:
                args["worker"] = r.worker
        else:
            pid = _pid(r.worker)
            tid = 1 if r.kind in (KIND_ENQUEUE, KIND_RETRACT) else 0
            pids.setdefault(pid, f"worker {r.worker}")
        if r.kind in COUNTER_KINDS:
            name = ("injected_speed" if r.kind == KIND_INJ_SPEED
                    else "observed_speed")
            events.append({"ph": "C", "name": name, "pid": pid, "tid": 0,
                           "ts": ts, "args": {"speed": args.get("speed",
                                                               0.0)}})
        elif r.kind in SPAN_KINDS:
            name = (f"chunk {r.chunk_id} r{r.round_id}"
                    if r.kind == KIND_CHUNK else r.kind)
            events.append({"ph": "X", "name": name, "cat": r.kind,
                           "pid": pid, "tid": tid, "ts": ts,
                           "dur": max(r.dur, 0.0) * 1e6, "args": args})
        else:
            events.append({"ph": "i", "name": r.kind, "cat": r.kind,
                           "pid": pid, "tid": tid, "ts": ts, "s": "t",
                           "args": args})
    meta: List[dict] = []
    for pid, name in sorted(pids.items()):
        meta.append({"ph": "M", "name": "process_name", "pid": pid,
                     "tid": 0, "args": {"name": name}})
        meta.append({"ph": "M", "name": "process_sort_index", "pid": pid,
                     "tid": 0, "args": {"sort_index": pid}})
        if pid > 0:
            meta.append({"ph": "M", "name": "thread_name", "pid": pid,
                         "tid": 0, "args": {"name": "compute"}})
            meta.append({"ph": "M", "name": "thread_name", "pid": pid,
                         "tid": 1, "args": {"name": "queue"}})
    for tid, name in sorted(master_tids.items()):
        meta.append({"ph": "M", "name": "thread_name", "pid": 0,
                     "tid": tid, "args": {"name": name}})
    return meta + events


def export_chrome_trace(records: Sequence[TraceRecord], path) -> int:
    """Write records as a Chrome trace-event JSON file; returns #events."""
    events = chrome_trace_events(records)
    with open(path, "w") as fh:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, fh)
    return len(events)


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------

def log_buckets(lo: float = 1e-5, hi: float = 100.0,
                per_decade: int = 3) -> Tuple[float, ...]:
    """Fixed log-spaced histogram bucket upper bounds, ``lo`` … ``hi``."""
    out: List[float] = []
    e = 0
    while True:
        v = lo * 10.0 ** (e / per_decade)
        if v > hi * 1.0000001:
            break
        out.append(v)
        e += 1
    return tuple(out)


DEFAULT_BUCKETS = log_buckets()


def _escape_label(v: str) -> str:
    return v.replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")


def _fmt_labels(labelnames: Tuple[str, ...],
                labelvalues: Tuple[str, ...], extra: str = "") -> str:
    parts = [f'{k}="{_escape_label(v)}"'
             for k, v in zip(labelnames, labelvalues)]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class _Child:
    """One labeled time series; carries its own lock (the lock stripe)."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    @property
    def value(self) -> float:
        return self._value


class _CounterChild(_Child):
    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counters only go up, got {amount}")
        with self._lock:
            self._value += amount


class _GaugeChild(_Child):
    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value -= amount


class _HistogramChild:
    __slots__ = ("_lock", "buckets", "counts", "sum", "count")

    def __init__(self, buckets: Tuple[float, ...]):
        self._lock = threading.Lock()
        self.buckets = buckets
        self.counts = [0] * (len(buckets) + 1)   # +1: the +Inf bucket
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        i = 0
        for i, ub in enumerate(self.buckets):
            if value <= ub:
                break
        else:
            i = len(self.buckets)
        with self._lock:
            self.counts[i] += 1
            self.sum += value
            self.count += 1

    def quantile(self, q: float) -> float:
        """Bucket-interpolated quantile (the Prometheus estimator)."""
        with self._lock:
            counts = list(self.counts)
            total = self.count
        if total == 0:
            return float("nan")
        rank = q / 100.0 * total
        seen = 0.0
        for i, c in enumerate(counts):
            if seen + c >= rank and c > 0:
                lo = self.buckets[i - 1] if i > 0 else 0.0
                hi = (self.buckets[i] if i < len(self.buckets)
                      else self.buckets[-1])
                frac = (rank - seen) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
            seen += c
        return self.buckets[-1]


class _MetricFamily:
    """Base: name + label schema + per-label-set children (lock-striped)."""

    kind = "untyped"
    _child_cls = _Child

    def __init__(self, name: str, help: str,
                 labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()       # children map only
        # guarded_by: _lock
        self._children: Dict[Tuple[str, ...], object] = {}
        if not self.labelnames:             # unlabeled: one default child
            self._children[()] = self._make_child()

    def _make_child(self):
        return self._child_cls()

    def labels(self, *labelvalues, **labelkw):
        if labelkw:
            labelvalues = tuple(str(labelkw[k]) for k in self.labelnames)
        else:
            labelvalues = tuple(str(v) for v in labelvalues)
        if len(labelvalues) != len(self.labelnames):
            raise ValueError(f"{self.name}: expected labels "
                             f"{self.labelnames}, got {labelvalues}")
        # s2c2lint: ignore[S2C201] double-checked fast path: children are
        # only ever ADDED (under the lock below), so a racy hit is a real
        # child and a racy miss just falls through to the locked setdefault
        child = self._children.get(labelvalues)
        if child is None:
            with self._lock:
                child = self._children.setdefault(labelvalues,
                                                  self._make_child())
        return child

    def _default(self):
        if self.labelnames:
            raise ValueError(f"{self.name} is labeled "
                             f"{self.labelnames}; use .labels(...)")
        # s2c2lint: ignore[S2C201] an unlabeled family's map holds exactly
        # the () child installed in __init__ and never mutates after
        return self._children[()]

    def children(self) -> Dict[Tuple[str, ...], object]:
        with self._lock:
            return dict(self._children)


class Counter(_MetricFamily):
    """Monotonic counter family (per-label-set children, striped locks)."""

    kind = "counter"
    _child_cls = _CounterChild

    def inc(self, amount: float = 1.0) -> None:
        self._default().inc(amount)

    @property
    def value(self) -> float:
        return self._default().value

    def total(self) -> float:
        return sum(c.value for c in self.children().values())


class Gauge(_MetricFamily):
    """Instantaneous value family."""

    kind = "gauge"
    _child_cls = _GaugeChild

    def set(self, value: float) -> None:
        self._default().set(value)

    def inc(self, amount: float = 1.0) -> None:
        self._default().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._default().dec(amount)

    @property
    def value(self) -> float:
        return self._default().value


class Histogram(_MetricFamily):
    """Histogram family with fixed log-spaced buckets."""

    kind = "histogram"

    def __init__(self, name: str, help: str, labelnames: Sequence[str] = (),
                 buckets: Optional[Sequence[float]] = None):
        self.buckets = tuple(buckets) if buckets else DEFAULT_BUCKETS
        if list(self.buckets) != sorted(self.buckets):
            raise ValueError("buckets must be sorted ascending")
        super().__init__(name, help, labelnames)

    def _make_child(self):
        return _HistogramChild(self.buckets)

    def observe(self, value: float) -> None:
        self._default().observe(value)

    def quantile(self, q: float) -> float:
        """Quantile over ALL children merged (q in percent, like np)."""
        merged = _HistogramChild(self.buckets)
        for c in self.children().values():
            with c._lock:
                for i, n in enumerate(c.counts):
                    merged.counts[i] += n
                merged.count += c.count
                merged.sum += c.sum
        return merged.quantile(q)

    @property
    def count(self) -> int:
        return sum(c.count for c in self.children().values())

    @property
    def sum(self) -> float:
        return sum(c.sum for c in self.children().values())


class MetricsRegistry:
    """Get-or-create registry of metric families + Prometheus-text render.

    ``counter`` / ``gauge`` / ``histogram`` are idempotent: re-registering
    an existing name returns the existing family (and raises if the kind
    or label schema conflicts), so every component can declare the metrics
    it publishes without coordination.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _MetricFamily] = {}  # guarded_by: _lock

    def _get_or_create(self, cls, name: str, help: str,
                       labelnames: Sequence[str], **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls) or \
                        m.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{m.kind}{m.labelnames}")
                return m
            m = cls(name, help, labelnames, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets)

    def get(self, name: str) -> Optional[_MetricFamily]:
        with self._lock:
            return self._metrics.get(name)

    def value(self, name: str, **labels) -> float:
        """Scalar convenience reader: 0.0 when absent (counter semantics).

        ``labels`` may name a *subset* of the family's label schema: the
        values of all children matching the given labels are summed (for
        histograms, their ``sum``).  This keeps strategy-level reads like
        ``value("s2c2_rounds_total", strategy="GeneralS2C2")`` working
        unchanged when a family gains an extra dimension (the ``transport``
        label) — the read aggregates over the unnamed labels.
        """
        m = self.get(name)
        if m is None:
            return 0.0
        if labels:
            unknown = set(labels) - set(m.labelnames)
            if unknown:
                raise ValueError(f"{name}: unknown labels {sorted(unknown)}; "
                                 f"schema is {m.labelnames}")
            if set(labels) == set(m.labelnames) and \
                    not isinstance(m, Histogram):
                return m.labels(**labels).value
            want = {m.labelnames.index(k): str(v)
                    for k, v in labels.items()}
            total = 0.0
            for lv, child in m.children().items():
                if all(lv[i] == v for i, v in want.items()):
                    total += (child.sum if isinstance(m, Histogram)
                              else child.value)
            return total
        if isinstance(m, Histogram):
            return float(m.sum)
        return m.total() if isinstance(m, Counter) else m.value

    def families(self) -> List[_MetricFamily]:
        with self._lock:
            return list(self._metrics.values())

    def render(self) -> str:
        """Prometheus text exposition format (0.0.4)."""
        lines: List[str] = []
        for m in sorted(self.families(), key=lambda f: f.name):
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            for lv, child in sorted(m.children().items()):
                if isinstance(m, Histogram):
                    cum = 0
                    with child._lock:
                        counts = list(child.counts)
                        s, n = child.sum, child.count
                    for ub, c in zip(m.buckets, counts):
                        cum += c
                        lab = _fmt_labels(m.labelnames, lv,
                                          extra=f'le="{ub:g}"')
                        lines.append(f"{m.name}_bucket{lab} {cum}")
                    lab = _fmt_labels(m.labelnames, lv, extra='le="+Inf"')
                    lines.append(f"{m.name}_bucket{lab} {n}")
                    lab = _fmt_labels(m.labelnames, lv)
                    lines.append(f"{m.name}_sum{lab} {s:g}")
                    lines.append(f"{m.name}_count{lab} {n}")
                else:
                    lab = _fmt_labels(m.labelnames, lv)
                    lines.append(f"{m.name}{lab} {child.value:g}")
        return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# logging
# ---------------------------------------------------------------------------

_LOG_MARK = "_repro_cluster_handler"


def configure_logging(level: int = logging.INFO, stream=None) -> logging.Logger:
    """Wire ``repro_torch.cluster`` logging to a stream handler at ``level``.

    Per-component child loggers (``repro_torch.cluster.master`` / ``.worker`` /
    ``.service``) propagate here, so one call surfaces the whole engine;
    at ``logging.DEBUG`` every steal / retract / failover / §4.3 wave /
    coalesce decision is logged with its round and chunk ids, matching
    the trace records one-to-one.  Idempotent: re-calling replaces the
    previously installed handler instead of stacking duplicates.
    """
    root = logging.getLogger("repro_torch.cluster")
    for h in list(root.handlers):
        if getattr(h, _LOG_MARK, False):
            root.removeHandler(h)
    handler = logging.StreamHandler(stream if stream is not None
                                    else sys.stderr)
    handler.setFormatter(logging.Formatter(
        "%(asctime)s %(name)s %(levelname)s %(message)s"))
    setattr(handler, _LOG_MARK, True)
    root.addHandler(handler)
    root.setLevel(level)
    return root
