"""Transport plane: in-process queues or a socket-backed process pool.

Everything above this module — planning, any-k collection, §4.3 waves,
work stealing, failover — talks to workers through a narrow worker-shaped
surface (``install_shard`` / ``submit`` / ``retract`` / ``promote_round``
/ ``cancel_task`` / ``backlog`` / ``idle`` / ``abort`` plus the stats
attributes).  A :class:`Transport` builds that pool:

* :class:`InProcTransport` — the original thread pool over one shared
  ``queue.Queue`` (zero-copy, deterministic; the test double and the
  default);
* :class:`SocketTransport` — a **process-based** pool: each worker is a
  real child process (``multiprocessing`` spawn) running the exact same
  :class:`~repro_torch.cluster.worker.Worker` loop, connected to the master
  over a localhost TCP socket with length-prefixed pickle frames.  The
  child's ``ChunkDone``/``WorkerDone``/``WorkerFailed`` events terminate
  at the engine's collector thread unchanged — the engine cannot tell the
  difference, which is the point;
* :class:`FaultyTransport` — :class:`SocketTransport` plus a seeded chaos
  layer injecting message drop / duplication / delay / reorder, forced
  connection drops, and mid-chunk worker SIGKILL.

Robustness machinery (socket transport):

* **Heartbeats** — each child runs a heartbeat pump that also carries its
  busy/idle/backlog stats and flushes its local trace buffer.  The pump
  goes *silent* the moment the local worker fail-stops (injected
  ``s == 0``), so the paper's §4.4 silence semantics extend to the wire.
* **Fail-stop verdicts** — a master-side monitor feeds per-worker
  liveness (heartbeat freshness, process aliveness, reconnect grace) to a
  dedicated :class:`~repro_torch.runtime.elastic.FailureDetector`; a verdict
  fences the worker (kill + refuse reconnect) and injects a synthetic
  ``WorkerFailed`` that the collector broadcasts to every live round —
  the normal ``_failover_dispatch`` path completes the round.
* **Reconnect + backoff** — a child that loses its socket reconnects
  with exponential backoff; the master grants a grace window before
  silence counts toward a verdict, re-attaches the connection, and the
  child re-delivers events produced while disconnected.
* **Clock rebasing** — remote events and forwarded ``TraceRecord``s are
  worker-clock-stamped; the master estimates each worker's clock offset
  (min over handshake/heartbeat samples of ``recv_time - worker_time``)
  and rebases, so one ``engine.dump_trace`` renders a single coherent
  Perfetto timeline across processes.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
import logging
import multiprocessing as mp
import os
import pickle
import queue
import random
import socket
import struct
import threading
import time
from typing import (Any, Callable, Dict, List, Optional, Protocol, Sequence,
                    Set, Tuple)

import numpy as np

from repro_torch.cluster import obs
from repro_torch.cluster.injectors import TracedInjector
from repro_torch.cluster.obs import MetricsRegistry, Tracer
from repro_torch.cluster.shm import (DEFAULT_SHM_THRESHOLD, SHM_AVAILABLE,
                                     SegmentPool, ShmDescriptor, shm_prefix)
from repro_torch.cluster.worker import (ChunkDone, ChunkTask, KernelBackend, Worker,
                                        WorkerDone, WorkerFailed, WorkerRejoined,
                                        kernel_backend, numpy_backend, shard_digest)
from repro_torch.runtime.elastic import FailureDetector

__all__ = ["Transport", "InProcTransport", "SocketTransport",
           "FaultyTransport", "ChaosConfig", "RemoteWorkerEndpoint",
           "encode_frame", "encode_frame_parts", "decode_frame",
           "shard_digest", "ShmDescriptor", "SegmentPool"]

logger = logging.getLogger("repro_torch.cluster.transport")


# ---------------------------------------------------------------------------
# framing: length-prefixed pickle, protocol-5 out-of-band buffers
# ---------------------------------------------------------------------------
#
# Frame layout (everything after the u32 total-length header is "body"):
#
#   !I  body length
#   !I  number of out-of-band buffers
#   !Q  length of each buffer, repeated
#   ... raw buffer bytes, concatenated
#   ... pickle stream (protocol 5, buffers externalized)
#
# Large ndarray payloads that ride inline (the shm fallback path) are
# externalized by ``buffer_callback`` so the sender never concatenates
# them into the pickle stream (gather-write via ``sendmsg``) and the
# receiver reconstructs arrays as zero-copy views over the received
# body — one fewer memcpy per direction on the hot path.

_HDR = struct.Struct("!I")
_NBUF = struct.Struct("!I")
_BLEN = struct.Struct("!Q")


def encode_frame_parts(obj) -> List[Any]:
    """Encode one frame as a list of bytes-like parts (gather-write).

    ``parts[0]`` is the header + buffer directory; the remainder are the
    raw out-of-band buffers (zero-copy memoryviews over the payload
    arrays) followed by the pickle stream.  ``b"".join(parts)`` is the
    exact wire image.  Bitwise-faithful for ndarrays: the buffer bytes
    cross verbatim, so a float64 payload decodes bit-identically (the
    wire never rounds).
    """
    raw: List[pickle.PickleBuffer] = []
    try:
        payload = pickle.dumps(obj, protocol=5,
                               buffer_callback=raw.append)
        bufs = [b.raw() for b in raw]
    except BufferError:             # non-contiguous exotic buffer: inline
        payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
        bufs = []
    directory = bytearray(_NBUF.pack(len(bufs)))
    total = _NBUF.size + len(payload)
    for b in bufs:
        directory += _BLEN.pack(b.nbytes)
        total += _BLEN.size + b.nbytes
    parts: List[Any] = [_HDR.pack(total) + bytes(directory)]
    parts.extend(bufs)
    parts.append(payload)
    return parts


def encode_frame(obj) -> bytes:
    """Length-prefixed pickle frame (joined wire image)."""
    return b"".join(encode_frame_parts(obj))


def _frame_nbytes(parts: List[Any]) -> int:
    return sum(len(p) if isinstance(p, (bytes, bytearray)) else p.nbytes
               for p in parts)


def _send_parts(sock: socket.socket, parts: List[Any]) -> None:
    """Gather-write one frame without concatenating the parts."""
    if not hasattr(sock, "sendmsg"):        # pragma: no cover - exotic OS
        sock.sendall(b"".join(parts))
        return
    mvs = [memoryview(p).cast("B") for p in parts]
    while mvs:
        sent = sock.sendmsg(mvs)
        while mvs and sent >= len(mvs[0]):
            sent -= len(mvs[0])
            mvs.pop(0)
        if mvs and sent:
            mvs[0] = mvs[0][sent:]


def _decode_body(body: memoryview) -> Any:
    (nbufs,) = _NBUF.unpack(body[:_NBUF.size])
    off = _NBUF.size
    lens = []
    for _ in range(nbufs):
        (ln,) = _BLEN.unpack(body[off:off + _BLEN.size])
        off += _BLEN.size
        lens.append(ln)
    bufs = []
    for ln in lens:
        bufs.append(body[off:off + ln])
        off += ln
    return pickle.loads(body[off:], buffers=bufs)


def decode_frame(data: bytes) -> Tuple[Any, int]:
    """Decode one frame from ``data``; returns (object, bytes consumed).

    Reconstructed ndarrays are read-only zero-copy views over ``data``.
    """
    if len(data) < _HDR.size:
        raise ValueError("short frame: no length header")
    (n,) = _HDR.unpack(data[:_HDR.size])
    end = _HDR.size + n
    if len(data) < end:
        raise ValueError(f"short frame: need {end} bytes, have {len(data)}")
    return _decode_body(memoryview(data)[_HDR.size:end]), end


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf.extend(chunk)
    return bytes(buf)


def _recv_frame(sock: socket.socket) -> Tuple[Any, int]:
    (n,) = _HDR.unpack(_recv_exact(sock, _HDR.size))
    return _decode_body(memoryview(_recv_exact(sock, n))), n + _HDR.size


# ---------------------------------------------------------------------------
# wire messages
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Hello:                       # child -> master, first frame per conn
    worker_id: int
    pid: int
    t_worker: float                 # child perf_counter (clock sample)


@dataclasses.dataclass
class _HelloAck:                    # master -> child
    t_master: float
    trace_enabled: bool
    hb_interval: float
    epoch: int = 1                  # fencing token: the master's current
    #                                 epoch — the child adopts it and stamps
    #                                 it into every frame it sends from here


@dataclasses.dataclass
class _InstallShard:
    shard_id: str
    rows: np.ndarray


@dataclasses.dataclass
class _InstallShardShm:             # master -> child: shard via descriptor
    shard_id: str
    desc: ShmDescriptor             # the rows live in a shared segment;
    #                                 the child maps it (keeping the mapping
    #                                 for the shard's lifetime) and replies
    #                                 _ShmAck so the master can unlink the
    #                                 name — one resident copy, zero socket
    #                                 bytes for the rows themselves


@dataclasses.dataclass
class _ShmAck:                      # child -> master: segments mapped
    names: List[str]                # the owner may release/unlink these


@dataclasses.dataclass
class _ShmRelease:                  # master -> child: round retired —
    round_id: int                   # recycle result segments tagged with
    epoch: int = 0                  # it (fenced: a zombie pre-crash master
    #                                 must not recycle a live round's data)


@dataclasses.dataclass
class _DropShard:
    shard_id: str


@dataclasses.dataclass
class _SubmitTask:
    task_id: int
    round_id: int
    iteration: int
    shard_id: str
    chunks: List[Tuple[int, int, int]]
    x: Optional[np.ndarray]         # inline RHS block; None when x_desc set
    row_cost: float
    epoch: int = 0                  # stamped by the master; the child
    #                                 rejects epochs older than its own
    x_desc: Optional[ShmDescriptor] = None  # shared-memory RHS descriptor


@dataclasses.dataclass
class _SubmitAck:                   # child -> master: submit received
    task_id: int


@dataclasses.dataclass
class _CancelTask:
    task_id: int


@dataclasses.dataclass
class _RetractReq:
    req_id: int
    round_id: int
    chunk_ids: Tuple[int, ...]
    limit: Optional[int]


@dataclasses.dataclass
class _RetractReply:
    req_id: int
    taken: List[int]


@dataclasses.dataclass
class _Promote:
    round_id: int


@dataclasses.dataclass
class _Stop:
    pass


@dataclasses.dataclass
class _Heartbeat:                   # child -> master, every hb_interval
    worker_id: int
    seq: int
    t_worker: float                 # child perf_counter (clock sample)
    busy_s: float
    idle_s: float
    retracted_total: int
    backlog: int
    backlog_by_round: Dict[int, int]
    idle: bool
    epoch: int = 0                  # fencing token (see _HelloAck.epoch)


@dataclasses.dataclass
class _EventMsg:                    # child -> master: one worker event
    event: Any                      # ChunkDone | WorkerDone | WorkerFailed
    seq: int = 0                    # per-child monotone id (at-least-once)
    epoch: int = 0                  # fencing token; the seq namespace is
    #                                 PER-EPOCH (the child renumbers its
    #                                 unacked buffer when it adopts a new
    #                                 epoch, so a restarted master's fresh
    #                                 floor and the replayed stream agree)
    shm: Optional[ShmDescriptor] = None  # ChunkDone.result rides a shared
    #                                 segment; the event carries result=None
    #                                 and the master re-attaches at delivery


@dataclasses.dataclass
class _EventAck:                    # master -> child: cumulative event ack
    cum_seq: int                    # all seqs <= cum_seq are safe to drop


@dataclasses.dataclass
class _RejoinReq:                   # master -> child: prove your shards
    epoch: int                      # the epoch the rejoin would re-enter


@dataclasses.dataclass
class _Rejoin:                      # child -> master: rejoin handshake reply
    worker_id: int
    epoch: int
    digests: Dict[str, str]         # shard_id -> content digest of the
    #                                 child's installed copy; the master
    #                                 reinstalls over the wire only on
    #                                 mismatch, then un-fences the worker


@dataclasses.dataclass
class _TraceBatch:                  # child -> master: forwarded TraceRecords
    worker_id: int
    records: List


@dataclasses.dataclass(frozen=True)
class WireSpec:
    """Protocol-table entry for one frame kind.

    ``direction`` is who sends it (``"c2m"`` child→master, ``"m2c"``
    master→child, ``"both"``); ``protected`` frames are exempt from
    chaos injection.  A protected frame is a control-plane message whose
    loss is not a fault the §4.3/§4.4 machinery is meant to absorb (a
    dropped shard install is a provisioning bug, not a straggler), a
    retract RPC that degrades safely on its own timeout without needing
    injected loss, or an ACK — the *recovery* half of at-least-once
    delivery (chaos attacks the payload message itself; attacking the
    ack too would only turn loss into duplication, which dup covers).
    ``fenced`` frames carry the epoch fencing token: the dataclass must
    declare an ``epoch`` field and the receiving side must compare it
    against its current epoch (s2c2lint S2C205 enforces both).
    """

    direction: str
    protected: bool = False
    fenced: bool = False


#: THE protocol table — the single source of truth the chaos exemption
#: set derives from and that ``s2c2lint`` rule S2C205 cross-checks
#: against the send sites and the isinstance dispatch on each side.
#: Adding a frame means adding it here, or the lint fails the build.
WIRE_PROTOCOL: Dict[type, WireSpec] = {
    _Hello: WireSpec("c2m", protected=True),
    _HelloAck: WireSpec("m2c", protected=True),
    _InstallShard: WireSpec("m2c", protected=True),
    _InstallShardShm: WireSpec("m2c", protected=True),
    _ShmAck: WireSpec("c2m", protected=True),
    _ShmRelease: WireSpec("m2c", protected=True, fenced=True),
    _DropShard: WireSpec("m2c", protected=True),
    _SubmitTask: WireSpec("m2c", fenced=True),
    _SubmitAck: WireSpec("c2m", protected=True),
    _CancelTask: WireSpec("m2c"),
    _RetractReq: WireSpec("m2c", protected=True),
    _RetractReply: WireSpec("c2m", protected=True),
    _Promote: WireSpec("m2c"),
    _Stop: WireSpec("m2c", protected=True),
    _Heartbeat: WireSpec("c2m", fenced=True),
    _EventMsg: WireSpec("c2m", fenced=True),
    _EventAck: WireSpec("m2c", protected=True),
    _RejoinReq: WireSpec("m2c", protected=True, fenced=True),
    _Rejoin: WireSpec("c2m", protected=True, fenced=True),
    _TraceBatch: WireSpec("c2m"),
}

#: chaos-exempt frame kinds, derived — never hand-listed — from the
#: protocol table so the exemption set cannot silently diverge from it
_PROTECTED = tuple(cls for cls, spec in WIRE_PROTOCOL.items()
                   if spec.protected)


# ---------------------------------------------------------------------------
# Transport protocol + in-process implementation
# ---------------------------------------------------------------------------

class Transport(Protocol):
    """Builds and owns the engine's worker pool."""

    kind: str

    def start(self, cfg, events: "queue.Queue", injector, compute,
              tracer: Tracer, registry: MetricsRegistry) -> List:
        """Create the pool; returns worker-shaped objects, one per slot."""
        ...

    def shutdown(self) -> None:
        """Tear the pool down (idempotent)."""
        ...

    def round_retired(self, round_id: int) -> None:
        """Round bookkeeping hook: the engine retired ``round_id``."""
        ...


class InProcTransport:
    """The original thread pool: workers share the master's event queue.

    Kept as the default and as the deterministic test double — message
    delivery is exact, ordered, and zero-copy.
    """

    kind = "inproc"

    def __init__(self):
        self.workers: List[Worker] = []

    def start(self, cfg, events, injector, compute, tracer, registry):
        self.workers = [Worker(w, events, injector, compute, tracer=tracer)
                        for w in range(cfg.n_workers)]
        for w in self.workers:
            w.start()
        return self.workers

    def shutdown(self) -> None:
        for w in self.workers:
            w.abort()
        for w in self.workers:
            w.join(timeout=10.0)

    def round_retired(self, round_id: int) -> None:
        pass


# ---------------------------------------------------------------------------
# chaos configuration
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    """Seeded fault schedule for :class:`FaultyTransport`.

    Per-message fault draws come from one ``random.Random`` stream per
    connection, derived from ``(seed, worker, epoch)`` and restarted at
    every (re)attach — so the decision *schedule* is seed-determined and
    reproducible across reconnects and master restarts (exact
    interleaving across workers still depends on wall-clock arrival
    order).  ``kill_worker`` SIGKILLs that worker's process after its
    ``kill_after_chunks``-th delivered chunk result — a mid-round
    fail-stop the §4.4 heartbeat monitor must catch.  ``drop_conn_worker``
    force-closes that worker's socket instead (the process survives),
    exercising the reconnect/backoff path.

    ``partition_worker`` arms an **asymmetric one-way partition**: after
    that worker's ``partition_after_chunks``-th delivered chunk, chaos
    drops every frame of ``partition_mode`` ("events" = the worker's
    ``_EventMsg`` stream child→master, "submits" = the master's
    ``_SubmitTask`` stream master→child) for ``partition_duration_s``
    seconds, then heals.  Heartbeats keep flowing either way — the
    monitor must tell "events silent but heartbeats arriving" apart from
    true silence, fence the worker as SUSPECTED, and rejoin it on heal.
    """

    seed: int = 0
    p_drop: float = 0.0
    p_dup: float = 0.0
    p_delay: float = 0.0
    delay_range: Tuple[float, float] = (0.001, 0.02)
    p_reorder: float = 0.0
    reorder_range: Tuple[float, float] = (0.002, 0.01)
    kill_worker: Optional[int] = None
    kill_after_chunks: int = 3
    drop_conn_worker: Optional[int] = None
    drop_conn_after_chunks: int = 3
    partition_worker: Optional[int] = None
    partition_mode: str = "events"          # "events" | "submits"
    partition_after_chunks: int = 1
    partition_duration_s: float = 2.0

    def __post_init__(self):
        for name in ("p_drop", "p_dup", "p_delay", "p_reorder"):
            p = getattr(self, name)
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"ChaosConfig.{name} must be a "
                                 f"probability in [0, 1], got {p!r}")
        for name in ("delay_range", "reorder_range"):
            lo, hi = getattr(self, name)
            if not 0.0 <= lo <= hi:
                raise ValueError(f"ChaosConfig.{name} must satisfy "
                                 f"0 <= lo <= hi, got ({lo!r}, {hi!r})")
        if self.partition_mode not in ("events", "submits"):
            raise ValueError("ChaosConfig.partition_mode must be 'events' "
                             f"or 'submits', got {self.partition_mode!r}")
        if self.partition_duration_s < 0.0:
            raise ValueError("ChaosConfig.partition_duration_s must be "
                             f">= 0, got {self.partition_duration_s!r}")


class _DelayScheduler(threading.Thread):
    """Min-heap timer thread that runs delayed chaos deliveries."""

    def __init__(self):
        super().__init__(name="chaos-scheduler", daemon=True)
        self._cv = threading.Condition()
        self._heap: List[Tuple[float, int, Callable[[], None]]] = []
        self._seq = 0
        self._stopped = False

    def schedule(self, delay_s: float, fn: Callable[[], None]) -> None:
        with self._cv:
            heapq.heappush(self._heap,
                           (time.perf_counter() + max(delay_s, 0.0),
                            self._seq, fn))
            self._seq += 1
            self._cv.notify()

    def stop(self) -> None:
        with self._cv:
            self._stopped = True
            self._cv.notify()

    def run(self) -> None:
        while True:
            with self._cv:
                while not self._stopped:
                    now = time.perf_counter()
                    if self._heap and self._heap[0][0] <= now:
                        break
                    self._cv.wait(self._heap[0][0] - now
                                  if self._heap else None)
                if self._stopped:
                    return
                _, _, fn = heapq.heappop(self._heap)
            try:
                fn()
            except Exception:       # a chaos mishap must not kill delivery
                logger.exception("chaos-delayed delivery failed")


class _Chaos:
    """Master-side fault injector for one :class:`SocketTransport`.

    Routed around every non-protected message in both directions: rx
    (child → master, after the frame is parsed) and tx (master → child,
    instead of the raw send).  Faults are drop / duplicate / delay /
    reorder (a short hold that lets later messages overtake); triggers
    fire the SIGKILL / connection-drop events off the victim's delivered
    chunk count.
    """

    def __init__(self, cfg: ChaosConfig, transport: "SocketTransport"):
        self.cfg = cfg
        self.transport = transport
        # per-connection fault streams, derived from (seed, worker, epoch)
        # and RESTARTED at every attach (see reset_stream): a reconnect or
        # a master restart replays the same schedule from the top instead
        # of resuming a shared consumed RNG — that is what keeps the CI
        # chaos matrix deterministic across partition/recovery scenarios
        self._rngs = [self._stream(w, transport.epoch)
                      for w in range(transport.n_workers)]  # guarded_by: _locks[worker]
        self._locks = [threading.Lock() for _ in range(transport.n_workers)]
        self._sched = _DelayScheduler()
        self._sched.start()
        self._chunks_seen: Dict[int, int] = {}   # guarded_by: _trig_lock
        self._killed = False                     # guarded_by: _trig_lock
        self._conn_dropped = False               # guarded_by: _trig_lock
        # asymmetric one-way partition window (master clock); None = not
        # started; heal is the window's scheduled end
        self._partition_until: Optional[float] = None  # guarded_by: _trig_lock
        self._partition_started = False          # guarded_by: _trig_lock
        self._partition_healed = False           # guarded_by: _trig_lock
        self._trig_lock = threading.Lock()

    def stop(self) -> None:
        self._sched.stop()

    def _stream(self, worker: int, epoch: int) -> random.Random:
        return random.Random((self.cfg.seed << 20) ^ (epoch << 10) ^ worker)

    def reset_stream(self, worker: int, epoch: int) -> None:
        """Restart worker's fault stream for a fresh connection at epoch."""
        with self._locks[worker]:
            self._rngs[worker] = self._stream(worker, epoch)

    # -- fault draw --------------------------------------------------------
    def _decide(self, worker: int) -> Tuple[str, float]:
        c = self.cfg
        with self._locks[worker]:
            rng = self._rngs[worker]
            r = rng.random()
            if r < c.p_drop:
                return "drop", 0.0
            r -= c.p_drop
            if r < c.p_dup:
                return "dup", 0.0
            r -= c.p_dup
            if r < c.p_delay:
                return "delay", rng.uniform(*c.delay_range)
            r -= c.p_delay
            if r < c.p_reorder:
                return "reorder", rng.uniform(*c.reorder_range)
            return "pass", 0.0

    def _note(self, action: str, worker: int, direction: str) -> None:
        t = self.transport
        t._m_chaos.labels(transport=t.kind, action=action).inc()
        if t.tracer is not None and t.tracer.enabled:
            t.tracer.emit(obs.KIND_CHAOS, worker=worker, action=action,
                          direction=direction)
        logger.debug("chaos: %s %s message of worker %d",
                     action, direction, worker)

    # -- kill / conn-drop / partition triggers ----------------------------
    def _check_triggers(self, worker: int, msg) -> None:
        c = self.cfg
        if not isinstance(msg, _EventMsg) or \
                not isinstance(msg.event, ChunkDone):
            return
        with self._trig_lock:
            seen = self._chunks_seen.get(worker, 0) + 1
            self._chunks_seen[worker] = seen
            kill = (not self._killed and c.kill_worker == worker
                    and seen >= c.kill_after_chunks)
            drop = (not self._conn_dropped and c.drop_conn_worker == worker
                    and seen >= c.drop_conn_after_chunks)
            part = (not self._partition_started
                    and c.partition_worker == worker
                    and seen >= c.partition_after_chunks)
            self._killed = self._killed or kill
            self._conn_dropped = self._conn_dropped or drop
            if part:
                self._partition_started = True
                self._partition_until = (time.perf_counter()
                                         + c.partition_duration_s)
        if kill:
            self._note("kill", worker, "proc")
            self.transport._kill_child(worker, reason="chaos SIGKILL")
        if drop:
            self._note("conn_drop", worker, "rx")
            self.transport.endpoints[worker]._force_close()
        if part:
            self._note("partition", worker,
                       "rx" if c.partition_mode == "events" else "tx")
            logger.warning("chaos: one-way partition of worker %d (%s) "
                           "for %.2fs", worker, c.partition_mode,
                           c.partition_duration_s)

    def _partitioned(self, worker: int, msg, direction: str) -> bool:
        """True iff the active one-way partition window swallows msg."""
        c = self.cfg
        if c.partition_worker != worker:
            return False
        if c.partition_mode == "events":
            hit = direction == "rx" and isinstance(msg, _EventMsg)
        else:
            hit = direction == "tx" and isinstance(msg, _SubmitTask)
        if not hit:
            return False
        healed = False
        with self._trig_lock:
            until = self._partition_until
            inside = until is not None and time.perf_counter() < until
            if until is not None and not inside and \
                    not self._partition_healed:
                self._partition_healed = True
                healed = True
        if healed:
            self._note("heal", worker, direction)
            logger.warning("chaos: partition of worker %d healed", worker)
        return inside

    # -- routing -----------------------------------------------------------
    def route(self, worker: int, msg, deliver: Callable[[], None],
              direction: str) -> None:
        """Apply the schedule to one message; ``deliver`` performs the
        real delivery (master-side handle, or the raw socket send)."""
        if self._partitioned(worker, msg, direction):
            # one-way drop: the frame type targeted by the partition never
            # crosses during the window; everything else (heartbeats, acks,
            # the other direction) flows normally — that asymmetry is the
            # point.  No trigger count: a swallowed result is not delivered.
            self._note("partition_drop", worker, direction)
            return
        if isinstance(msg, _PROTECTED):
            deliver()
            return
        action, delay = self._decide(worker)
        if action == "pass":
            deliver()
        elif action == "drop":
            self._note("drop", worker, direction)
        elif action == "dup":
            self._note("dup", worker, direction)
            deliver()
            deliver()
        else:                       # delay / reorder: both are a late
            self._note(action, worker, direction)  # delivery; reorder's
            self._sched.schedule(delay, deliver)   # hold is short enough
            return                  # for in-flight traffic to overtake
        # triggers count DELIVERED chunks (a dropped result can't be the
        # kill's cause — the victim must have visibly produced work first)
        if action in ("pass", "dup"):
            self._check_triggers(worker, msg)


# ---------------------------------------------------------------------------
# master side: remote worker endpoint
# ---------------------------------------------------------------------------

class RemoteWorkerEndpoint:
    """Master-side proxy for one worker process — worker-shaped.

    Implements the same surface the engine uses on an in-process
    :class:`~repro_torch.cluster.worker.Worker` (dispatch, retraction,
    promotion, shard management, stats), backed by the socket.  Fire-and-
    forget sends swallow connection errors: a lost message is exactly the
    failure mode the §4.3/§4.4 machinery recovers from, and the reader /
    monitor threads own the reconnect-or-verdict decision.
    """

    def __init__(self, worker_id: int, transport: "SocketTransport"):
        self.worker_id = worker_id
        self.transport = transport
        self.shards: Dict[str, np.ndarray] = {}
        #: expected content digest per installed shard — filled at
        #: install time (or seeded from the journal on recovery, where the
        #: master no longer holds the rows themselves); the Rejoin
        #: handshake compares the child's digests against this map and
        #: reinstalls over the wire only on mismatch
        self.shard_digests: Dict[str, str] = {}
        self.dead = False
        self.proc: Optional[mp.process.BaseProcess] = None
        self.pid: Optional[int] = None
        self._lock = threading.Lock()       # conn swap + offset + hb stats
        #                                     + epoch/rejoin/partition state
        self._tx_lock = threading.Lock()    # frame writes
        self._conn: Optional[socket.socket] = None
        self.connected = False
        self.connected_evt = threading.Event()   # first successful attach
        self._ever_connected = False
        self.disconnect_t = 0.0
        self.last_seen = 0.0    # guarded_by: _lock  (master clock, any rx)
        # SUSPECTED fence: a §4.4 verdict whose victim may still be alive
        # (partition / disconnect, not a dead process) — fenced from
        # dispatch exactly like dead, but rejoin-eligible
        self.suspected = False               # guarded_by: _lock
        # set on recovery-adopted endpoints: the next attach must run the
        # Rejoin handshake to revalidate shards against shard_digests
        self.revalidate = False              # guarded_by: _lock
        self._rejoin_pending = False         # guarded_by: _lock
        # master clock of the last _EventMsg received (post-chaos) and the
        # start of the current busy-with-no-events stretch heartbeats
        # report — together they distinguish "events silent but heartbeats
        # arriving" (partition suspicion) from true §4.4 silence
        self.last_event_rx = 0.0             # guarded_by: _lock
        self._busy_since: Optional[float] = None  # guarded_by: _lock
        # cross-epoch chunk dedup: (round_id, chunk_id) pairs this worker
        # already delivered — per-epoch seq numbering can't dedup a replay
        # that crosses an epoch boundary (fresh floor), this set can.
        # Seeded from the journal floor on recovery.
        self._seen_chunks: Set[Tuple[int, int]] = set()  # guarded_by: _lock
        # round releases the child missed while disconnected; flushed at
        # the next attach so its pool recycles parked result segments
        self._pending_shm_releases: Set[int] = set()  # guarded_by: _lock
        self._offset: Optional[float] = None
        # task bookkeeping: engine task object <-> wire task id
        self._task_seq = itertools.count(1)
        self._task_meta: Dict[int, Tuple[int, ChunkTask]] = {}  # guarded_by: _task_lock
        self._task_ids: Dict[int, int] = {}      # guarded_by: _task_lock
        self._task_lock = threading.Lock()
        # at-least-once event RECEIPT: the child numbers its events with a
        # process-lifetime sequence; we dedup retransmits/dups here and ack
        # the highest contiguous seq so the child can drop its buffer
        self._ev_floor = 0               # guarded_by: _lock
        self._ev_buf: Dict[int, object] = {}  # guarded_by: _lock
        self._rx_thread: Optional[threading.Thread] = None
        # at-least-once submit delivery: tid -> [msg, last_send_t, attempts];
        # entries clear on the child's _SubmitAck, and the transport monitor
        # retransmits overdue ones (lost to chaos OR to a disconnect window).
        # The child dedups by task id; a duplicate that slips through anyway
        # just recomputes — duplicate results are idempotent master-side.
        self._unacked: Dict[int, List] = {}      # guarded_by: _task_lock
        # sync retract RPC slots
        self._rpc_seq = itertools.count(1)
        self._rpcs: Dict[int, Tuple[threading.Event, List[List[int]]]] = {}  # guarded_by: _rpc_lock
        self._rpc_lock = threading.Lock()
        # heartbeat-carried stats (stale by <= hb_interval; good enough
        # for steal sizing and pool instrumentation)
        self.busy_s = 0.0                        # guarded_by: _lock
        self.idle_s = 0.0                        # guarded_by: _lock
        self.retracted_total = 0                 # guarded_by: _lock
        self._hb_backlog = 0                     # guarded_by: _lock
        self._hb_backlog_by_round: Dict[int, int] = {}  # guarded_by: _lock
        self._hb_idle = True                     # guarded_by: _lock

    # -- clock -------------------------------------------------------------
    @property
    def offset(self) -> float:
        off = self._offset
        return 0.0 if off is None else off

    def _sample_clock(self, t_worker: float, recv_t: float) -> None:
        # transit is nonnegative, so recv_t - t_worker over-estimates the
        # true offset by the (varying) transit time: the min over samples
        # converges onto the fastest observed path
        off = recv_t - t_worker
        with self._lock:
            if self._offset is None or off < self._offset:
                self._offset = off

    # -- connection lifecycle ---------------------------------------------
    def attach(self, conn: socket.socket, hello: _Hello,
               recv_t: float) -> None:
        t = self.transport
        refused = False
        closing = False
        with self._lock:
            # a permanently fenced worker (dead, not suspected) must never
            # come back; a SUSPECTED one may — through the Rejoin handshake
            rejoinable = self.suspected and t.allow_rejoin
            if t._closing or (self.dead and not rejoinable):
                refused = True
                closing = t._closing
            else:
                old = self._conn
                self._conn = conn
                reconnect = self._ever_connected
                self._ever_connected = True
                self.connected = True
                self.pid = hello.pid
                self.last_seen = recv_t
                needs_rejoin = self.suspected or self.revalidate
        if refused:
            try:
                # _Stop is a PERMANENT verdict: the child gives up its
                # reconnect loop and exits.  A crashing/closing transport
                # must instead go silent (exactly like a SIGKILLed
                # master) so survivors keep retrying until a recovery
                # transport adopts them — only a fence sends _Stop.
                if not closing:
                    conn.sendall(encode_frame(_Stop()))
                conn.close()
            except OSError:
                pass
            return
        self._sample_clock(hello.t_worker, recv_t)
        if old is not None and old is not conn:
            try:
                old.close()
            except OSError:
                pass
        if t.chaos is not None:
            # fresh connection, fresh fault stream: (seed, worker, epoch)
            t.chaos.reset_stream(self.worker_id, t.epoch)
        self._raw_send(_HelloAck(
            t_master=time.perf_counter(),
            trace_enabled=t.tracer is not None and t.tracer.enabled,
            hb_interval=t.hb_interval,
            epoch=t.epoch))
        if reconnect:
            t._m_reconnects.labels(transport=t.kind).inc()
            if t.tracer is not None and t.tracer.enabled:
                t.tracer.emit(obs.KIND_RECONNECT, worker=self.worker_id)
            logger.info("worker %d reconnected (pid %d)",
                        self.worker_id, hello.pid)
        with self._lock:
            missed = sorted(self._pending_shm_releases)
            self._pending_shm_releases.clear()
        for rid in missed:
            self._raw_send(_ShmRelease(rid, epoch=t.epoch))
        self.connected_evt.set()
        self._rx_thread = threading.Thread(
            target=self._read_loop, args=(conn,),
            name=f"transport-rx-{self.worker_id}", daemon=True)
        self._rx_thread.start()
        if needs_rejoin:
            self._begin_rejoin()

    def _on_conn_lost(self, conn: socket.socket) -> None:
        t = self.transport
        with self._lock:
            if self._conn is not conn:
                return                      # an old connection's reader
            self._conn = None
            self.connected = False
            self.disconnect_t = time.perf_counter()
        try:
            conn.close()
        except OSError:
            pass
        if not t._closing:
            if t.tracer is not None and t.tracer.enabled:
                t.tracer.emit(obs.KIND_CONN_LOST, worker=self.worker_id)
            logger.warning("worker %d: connection lost", self.worker_id)

    def _force_close(self) -> None:
        """Chaos hook: drop the live connection out from under the child."""
        with self._lock:
            conn = self._conn
        if conn is not None:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass

    def _read_loop(self, conn: socket.socket) -> None:
        t = self.transport
        while True:
            try:
                msg, nbytes = _recv_frame(conn)
            except (OSError, EOFError, ConnectionError, pickle.PickleError):
                self._on_conn_lost(conn)
                return
            recv_t = time.perf_counter()
            t._m_msgs_rx.inc()
            t._m_bytes_rx.inc(nbytes)
            with self._lock:
                self.last_seen = recv_t
            if t.chaos is not None:
                t.chaos.route(self.worker_id, msg,
                              lambda m=msg, r=recv_t: self._handle(m, r),
                              direction="rx")
            else:
                self._handle(msg, recv_t)

    # -- inbound handling --------------------------------------------------
    def _deliver(self, ev, desc: Optional[ShmDescriptor] = None) -> None:
        # called with self._lock held (keeps puts from different
        # chaos-timer threads in seq order and guards the dedup set);
        # must not take the lock itself.  Lock order here is
        # ep._lock -> pool._lock (attach); the pool never calls back
        # into the endpoint, so the pair cannot invert.
        if isinstance(ev, ChunkDone):
            # cross-epoch dedup: per-epoch seqs restart at an epoch bump,
            # so an at-least-once replay straddling the boundary (master
            # restart, rejoin) re-presents results the old epoch already
            # delivered — (round, chunk) content identity catches what
            # the fresh seq floor cannot.  Within a round a worker is
            # assigned each chunk at most once, so the key never
            # collides with legitimate work.
            key = (ev.round_id, ev.chunk_id)
            # s2c2lint: ignore[S2C201] _deliver's contract: caller holds _lock
            if key in self._seen_chunks:
                t = self.transport
                t._m_stale.labels(transport=t.kind).inc()
                return
            if desc is not None:
                # the result rides a shared segment: map it and hand the
                # engine a zero-copy read-only view — decode's gather
                # reads the (rows, B) block straight out of the mapping.
                # A miss (child died and was swept, or the round retired
                # and the tag is fenced) drops the event: a live round
                # re-covers the chunk via §4.3 reassignment, a retired
                # round never wanted it.
                pool = self.transport.shm_pool
                result = None if pool is None else \
                    pool.attach(desc, tag=ev.round_id)
                if result is None:
                    return
                ev = dataclasses.replace(ev, result=result)
            # s2c2lint: ignore[S2C201] _deliver's contract: caller holds _lock
            self._seen_chunks.add(key)
        off = self.offset
        # rebase worker-stamped clocks onto the master's perf_counter
        # axis so §4.3 deadlines, starvation refs, and the trace all
        # share one timeline
        ev = dataclasses.replace(ev, t=ev.t + off,
                                 t_start=ev.t_start + off
                                 if ev.t_start else 0.0)
        if isinstance(ev, WorkerFailed):
            self.dead = True
        self.transport.events.put(ev)

    def seed_seen(self, round_id: int, chunk_id: int) -> None:
        """Recovery hook: mark a journaled chunk as already delivered."""
        with self._lock:
            self._seen_chunks.add((round_id, chunk_id))

    def _handle(self, msg, recv_t: float) -> None:
        t = self.transport
        if isinstance(msg, _EventMsg):
            if msg.epoch and msg.epoch < t.epoch:
                # stale-epoch traffic: a frame stamped before the latest
                # fencing-token bump must not feed the engine
                t._m_stale.labels(transport=t.kind).inc()
                return
            rejoin = False
            with self._lock:
                self.last_event_rx = recv_t
                # an event arriving on a SUSPECTED worker's conn proves
                # the events path works again (partition healed) — run
                # the rejoin handshake exactly once per suspicion
                if self.suspected and t.allow_rejoin and \
                        not self._rejoin_pending:
                    self._rejoin_pending = True
                    rejoin = True
            if rejoin:
                self._begin_rejoin(already_pending=True)
            if msg.seq:
                # in-ORDER at-least-once delivery: the engine's collection
                # loop inherits the in-process queue's FIFO guarantee (e.g.
                # a WorkerDone never overtakes the ChunkDones it summarises
                # — §4.3 sets finish_t off exactly that ordering), so hold
                # out-of-order arrivals (chaos delay/reorder, retransmit
                # racing the original) until the gap fills.  The ack is
                # cumulative: the child keeps retransmitting the missing
                # seq, which is what plugs the gap.
                with self._lock:
                    dup = (msg.seq <= self._ev_floor
                           or msg.seq in self._ev_buf)
                    if not dup:
                        self._ev_buf[msg.seq] = (msg.event, msg.shm)
                        while self._ev_floor + 1 in self._ev_buf:
                            self._ev_floor += 1
                            ev, desc = self._ev_buf.pop(self._ev_floor)
                            self._deliver(ev, desc)
                    cum = self._ev_floor
                self._raw_send(_EventAck(cum))
                if dup:
                    return          # retransmit/chaos-dup of a seen event
            else:
                with self._lock:
                    self._deliver(msg.event, msg.shm)
        elif isinstance(msg, _Heartbeat):
            if msg.epoch and msg.epoch < t.epoch:
                t._m_stale.labels(transport=t.kind).inc()
                return
            self._sample_clock(msg.t_worker, recv_t)
            with self._lock:
                self.busy_s = msg.busy_s
                self.idle_s = msg.idle_s
                self.retracted_total = msg.retracted_total
                self._hb_backlog = msg.backlog
                self._hb_backlog_by_round = msg.backlog_by_round
                self._hb_idle = msg.idle
                # busy-with-no-events stretch: heartbeats claim queued or
                # running work; the monitor pairs this with last_event_rx
                # to call an events-path partition (§4.4 SUSPECTED)
                if msg.backlog > 0 or not msg.idle:
                    if self._busy_since is None:
                        self._busy_since = recv_t
                else:
                    self._busy_since = None
        elif isinstance(msg, _Rejoin):
            self._complete_rejoin(msg, recv_t)
        elif isinstance(msg, _TraceBatch):
            if t.tracer is not None and t.tracer.enabled:
                t.tracer.absorb(msg.records, self.offset)
        elif isinstance(msg, _SubmitAck):
            with self._task_lock:
                self._unacked.pop(msg.task_id, None)
        elif isinstance(msg, _ShmAck):
            # the child mapped these install segments: unlink the names so
            # exactly one resident copy (the child's mapping) remains
            if t.shm_pool is not None:
                t.shm_pool.release_names(msg.names)
        elif isinstance(msg, _RetractReply):
            with self._rpc_lock:
                slot = self._rpcs.pop(msg.req_id, None)
            if slot is not None:
                evt, box = slot
                box.append(list(msg.taken))
                evt.set()
        elif isinstance(msg, _Hello):
            # re-hello on an existing conn is a protocol error; ignore
            logger.debug("worker %d: unexpected re-hello", self.worker_id)
        else:
            logger.debug("worker %d: unknown message %r",
                         self.worker_id, type(msg).__name__)

    # -- rejoin handshake --------------------------------------------------
    def _begin_rejoin(self, already_pending: bool = False) -> None:
        """Ask the child to prove its shard contents (digest handshake)."""
        t = self.transport
        if not already_pending:
            with self._lock:
                if self._rejoin_pending:
                    return
                self._rejoin_pending = True
        logger.info("worker %d: rejoin handshake started (epoch %d)",
                    self.worker_id, t.epoch)
        self._raw_send(_RejoinReq(epoch=t.epoch))

    def _complete_rejoin(self, msg: "_Rejoin", recv_t: float) -> None:
        """Digest-validate the child's shards, reinstall mismatches, and
        un-fence a SUSPECTED worker back into the planner's speed table.

        Chunk results the worker completed during the partition ride the
        normal at-least-once event stream (its unacked buffer replays once
        frames flow again) — they are credited to coverage engine-side if
        their round is still open, which is the whole point of SUSPECTED
        over dead: completed work is never thrown away.
        """
        t = self.transport
        if msg.epoch != t.epoch:
            t._m_stale.labels(transport=t.kind).inc()
            with self._lock:
                self._rejoin_pending = False
            return
        expected = dict(self.shard_digests)
        mismatch = [sid for sid, d in expected.items()
                    if msg.digests.get(sid) != d]
        reinstalled = []
        unrecoverable = []
        for sid in mismatch:
            rows = self.shards.get(sid)
            if rows is None:
                # recovery-adopted endpoint: the master holds digests from
                # the journal but not the rows — a mismatch here cannot be
                # repaired over the wire, so the worker stays fenced
                unrecoverable.append(sid)
            else:
                self._send_install(sid, rows)
                reinstalled.append(sid)
        if unrecoverable:
            logger.warning(
                "worker %d: rejoin refused — shard(s) %s fail digest "
                "validation and the master holds no rows to reinstall",
                self.worker_id, unrecoverable)
            with self._lock:
                self._rejoin_pending = False
                was_live = not self.dead
                self.dead = True
                self.suspected = False
            if was_live:
                # a revalidation failure on a never-fenced worker (master
                # recovery) must fence it NOW: its shard contents are
                # wrong and any chunk it computed would corrupt decodes
                t.events.put(WorkerFailed(
                    self.worker_id, -1, time.perf_counter(),
                    f"rejoin: shard digest validation failed "
                    f"({sorted(unrecoverable)})"))
            return
        was_fenced = False
        with self._lock:
            was_fenced = self.dead or self.suspected
            self.dead = False
            self.suspected = False
            self.revalidate = False
            self._rejoin_pending = False
            self._busy_since = None
            self.last_event_rx = recv_t
        t._unfence(self.worker_id)
        if t.tracer is not None and t.tracer.enabled:
            t.tracer.emit(obs.KIND_REJOIN, worker=self.worker_id,
                          transport=t.kind, epoch=t.epoch,
                          reinstalled=len(reinstalled),
                          source="suspected" if was_fenced else "recovery")
        logger.info("worker %d: rejoin complete (%d shard(s) reinstalled, "
                    "%s)", self.worker_id, len(reinstalled),
                    "un-fenced" if was_fenced else "revalidated")
        if was_fenced:
            t._m_rejoins.labels(transport=t.kind).inc()
            # the collector un-fences the worker engine-side: clears it
            # from engine.dead, resets its predictor/detector state, and
            # new rounds plan it again
            t.events.put(WorkerRejoined(
                self.worker_id, -1, time.perf_counter()))

    # -- outbound ----------------------------------------------------------
    def _raw_send(self, msg) -> bool:
        with self._lock:
            conn = self._conn
        if conn is None:
            return False
        parts = encode_frame_parts(msg)
        nbytes = _frame_nbytes(parts)
        try:
            with self._tx_lock:
                # s2c2lint: ignore[S2C203] _tx_lock exists only to keep
                # concurrent frame writes from interleaving on the wire;
                # nothing else ever waits on it
                _send_parts(conn, parts)
        except OSError:
            return False
        t = self.transport
        t._m_msgs_tx.inc()
        t._m_bytes_tx.inc(nbytes)
        return True

    def _send(self, msg) -> None:
        t = self.transport
        if t.chaos is not None:
            t.chaos.route(self.worker_id, msg,
                          lambda m=msg: self._raw_send(m), direction="tx")
        else:
            self._raw_send(msg)

    def _send_install(self, shard_id: str, rows: np.ndarray) -> None:
        """Install over the data plane when possible, the socket otherwise.

        Install segments are ``recycle=False``: the child keeps its
        mapping for the shard's lifetime, so the name is unlinked on the
        child's ``_ShmAck`` (one resident copy) and must never be reused.
        """
        t = self.transport
        desc = None
        if t.shm_pool is not None:
            desc = t.shm_pool.share(
                rows, tag=("install", self.worker_id, shard_id),
                recycle=False)
        if desc is not None:
            self._raw_send(_InstallShardShm(shard_id, desc))
        else:
            self._raw_send(_InstallShard(shard_id, rows))

    # -- worker-shaped surface (what the engine calls) ---------------------
    def install_shard(self, shard_id: str, rows: np.ndarray) -> None:
        rows = np.ascontiguousarray(rows, dtype=np.float64)
        self.shards[shard_id] = rows
        self.shard_digests[shard_id] = shard_digest(rows)
        self._send_install(shard_id, rows)

    def drop_shard(self, shard_id: str) -> None:
        self.shards.pop(shard_id, None)
        self.shard_digests.pop(shard_id, None)
        self._raw_send(_DropShard(shard_id))

    def submit(self, task: ChunkTask) -> None:
        tid = next(self._task_seq)
        t = self.transport
        x = np.asarray(task.x)
        # one shared segment per round carries the RHS block to every
        # worker (the round snapshot is immutable); descriptor or inline,
        # never both
        desc = t._share_x(task.round_id, x)
        msg = _SubmitTask(tid, task.round_id, task.iteration,
                          task.shard_id, list(task.chunks),
                          None if desc is not None else x,
                          task.row_cost, epoch=t.epoch, x_desc=desc)
        with self._task_lock:
            self._task_meta[tid] = (task.round_id, task)
            self._task_ids[id(task)] = tid
            self._unacked[tid] = [msg, time.perf_counter(), 0]
        self._send(msg)

    def _resend_unacked(self, now: float) -> None:
        """Monitor tick: retransmit submits the child never acked."""
        t = self.transport
        if self.dead:
            with self._task_lock:
                self._unacked.clear()
            return
        due = []
        with self._task_lock:
            for tid, rec in list(self._unacked.items()):
                if now - rec[1] < t.ack_timeout:
                    continue
                if rec[2] >= t.max_submit_attempts or \
                        tid not in self._task_meta or \
                        self._task_meta[tid][1].cancel.is_set():
                    del self._unacked[tid]
                    continue
                rec[1] = now
                rec[2] += 1
                due.append(rec[0])
        for msg in due:
            logger.debug("worker %d: retransmitting submit %d",
                         self.worker_id, msg.task_id)
            self._send(msg)

    def cancel_task(self, task: ChunkTask) -> None:
        task.cancel.set()           # keep master-side bookkeeping coherent
        with self._task_lock:
            tid = self._task_ids.get(id(task))
            if tid is not None:
                self._unacked.pop(tid, None)
        if tid is not None:
            self._send(_CancelTask(tid))

    def retract(self, round_id: int, chunk_ids: Sequence[int],
                limit: Optional[int] = None) -> List[int]:
        """Synchronous retract RPC; degrades to ``[]`` on timeout/loss.

        Safe degradation: an unanswered retract means the chunks simply
        stay with the donor — nothing is double-counted, and §4.3 waves
        still recover the round if the donor never delivers.
        """
        if self.dead or not self.connected:
            return []
        req_id = next(self._rpc_seq)
        evt = threading.Event()
        box: List[List[int]] = []
        with self._rpc_lock:
            self._rpcs[req_id] = (evt, box)
        self._send(_RetractReq(req_id, round_id, tuple(chunk_ids), limit))
        if not evt.wait(self.transport.rpc_timeout):
            with self._rpc_lock:
                self._rpcs.pop(req_id, None)
            return []
        return box[0] if box else []

    def promote_round(self, round_id: int) -> int:
        self._send(_Promote(round_id))
        # the backlog map is swapped wholesale by the heartbeat handler;
        # reading it unlocked raced a dict replacement mid-lookup
        with self._lock:
            return self._hb_backlog_by_round.get(round_id, 0)

    def backlog(self, round_id: Optional[int] = None) -> int:
        with self._lock:
            if round_id is None:
                return self._hb_backlog
            return self._hb_backlog_by_round.get(round_id, 0)

    def idle(self) -> bool:
        # never steal INTO a disconnected or dead worker; heartbeat
        # staleness (<= hb_interval) only delays steals, never corrupts
        # accounting — retract() on the donor side stays authoritative
        with self._lock:
            return self.connected and not self.dead and self._hb_idle

    def idle_seconds(self, now: Optional[float] = None) -> float:
        with self._lock:
            return self.idle_s

    def stop(self) -> None:
        self._raw_send(_Stop())

    def abort(self) -> None:
        self._raw_send(_Stop())

    def round_retired(self, round_id: int) -> None:
        with self._task_lock:
            stale = [tid for tid, (rid, _) in self._task_meta.items()
                     if rid == round_id]
            for tid in stale:
                _, task = self._task_meta.pop(tid)
                self._task_ids.pop(id(task), None)
                self._unacked.pop(tid, None)
        with self._lock:
            self._hb_backlog_by_round.pop(round_id, None)
        t = self.transport
        if t.shm_pool is not None:
            # tell the child its result segments for this round may be
            # recycled; if the child is offline, queue the release and
            # flush it at the next attach (its pool keeps the segments
            # parked until then — bounded by rounds in flight)
            if not self._raw_send(_ShmRelease(round_id, epoch=t.epoch)):
                with self._lock:
                    self._pending_shm_releases.add(round_id)


# ---------------------------------------------------------------------------
# master side: the socket transport
# ---------------------------------------------------------------------------

class SocketTransport:
    """Process-based worker pool over localhost TCP.

    ``start`` spawns one child process per worker (``multiprocessing``
    ``spawn`` context — no forked locks), waits for every child's
    handshake, and returns :class:`RemoteWorkerEndpoint` proxies.  The
    monitor thread then drives heartbeat-based fail-stop detection for
    the life of the pool.
    """

    kind = "proc"

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 hb_interval: float = 0.1, hb_miss: int = 5,
                 dead_after: int = 3, rpc_timeout: float = 1.0,
                 reconnect_backoff: float = 0.05, reconnect_tries: int = 5,
                 connect_timeout: float = 60.0, mp_method: str = "spawn",
                 ack_timeout: Optional[float] = None,
                 max_submit_attempts: int = 10,
                 chaos: Optional[ChaosConfig] = None,
                 epoch: int = 1, allow_rejoin: bool = True,
                 adopt: bool = False,
                 event_silence_factor: float = 8.0,
                 shm: bool = True,
                 shm_threshold: int = DEFAULT_SHM_THRESHOLD,
                 shm_uid: Optional[str] = None):
        self.host = host
        self.port = port
        self.hb_interval = hb_interval
        self.hb_miss = hb_miss
        self.dead_after = dead_after
        self.rpc_timeout = rpc_timeout
        self.reconnect_backoff = reconnect_backoff
        self.reconnect_tries = reconnect_tries
        self.connect_timeout = connect_timeout
        self.mp_method = mp_method
        # at-least-once dispatch: a submit unacked for ack_timeout is
        # retransmitted (the child dedups), up to max_submit_attempts
        self.ack_timeout = (ack_timeout if ack_timeout is not None
                            else max(4 * hb_interval, 0.2))
        self.max_submit_attempts = max_submit_attempts
        self.chaos_cfg = chaos
        self.chaos: Optional[_Chaos] = None
        #: fencing token stamped into every master frame; a recovered
        #: master starts a NEW transport at the old epoch + 1 and both
        #: sides reject traffic stamped with an older epoch
        self.epoch = epoch
        #: a SUSPECTED worker may re-enter through the Rejoin handshake;
        #: off = every verdict is permanent (pre-rejoin semantics)
        self.allow_rejoin = allow_rejoin
        #: adopt mode (master recovery): bind the journaled port and wait
        #: for the SURVIVING children of the previous epoch to reconnect
        #: instead of spawning a fresh pool
        self.adopt = adopt
        #: optional process handles for adopted children (in-process
        #: recovery tests hand over the crashed transport's pool so
        #: shutdown can still reap them; a truly restarted master has none)
        self.adopt_procs: Optional[List[mp.process.BaseProcess]] = None
        #: recovery hook: called once per endpoint BEFORE the accept loop
        #: starts, so journal-derived state (shard digests, seen-chunk
        #: floors) is in place when the first adopted child attaches
        self.endpoint_seed: Optional[Callable[["RemoteWorkerEndpoint"],
                                              None]] = None
        #: partition suspicion threshold, as a multiple of the heartbeat
        #: silence window: a worker whose heartbeats claim queued/running
        #: work for this long while zero events arrive is SUSPECTED —
        #: generous enough that a straggler's long chunk doesn't trip it
        self.event_silence_factor = event_silence_factor
        #: shared-memory data plane: bulk ndarray payloads (installs, RHS
        #: blocks, results) ride /dev/shm segments and the socket carries
        #: only descriptors.  ``shm=False`` (or an unsupported platform,
        #: or a payload under shm_threshold) falls back to inline pickle.
        self.shm = shm and SHM_AVAILABLE
        self.shm_threshold = shm_threshold
        #: engine-lineage id naming every segment (``s2c2shm_<uid>...``);
        #: journaled by the engine so ``recover()`` can sweep a dead
        #: master's orphans and a verdict can sweep its victim's
        self.shm_uid = shm_uid if shm_uid is not None \
            else os.urandom(3).hex()
        self.shm_pool: Optional[SegmentPool] = None
        self._x_descs: Dict[int, Optional[ShmDescriptor]] = {}  # guarded_by: _x_lock
        self._x_lock = threading.Lock()
        self.n_workers = 0
        self.events: Optional["queue.Queue"] = None
        self.tracer: Optional[Tracer] = None
        self.endpoints: List[RemoteWorkerEndpoint] = []
        self.procs: List[mp.process.BaseProcess] = []
        self._lsock: Optional[socket.socket] = None
        self.bound_port: Optional[int] = None
        self._closing = False
        self._closed = False
        self._verdicted: Set[int] = set()    # guarded_by: _verdict_lock
        self._verdict_lock = threading.Lock()
        self._detector: Optional[FailureDetector] = None
        self._monitor: Optional[threading.Thread] = None
        self._accept_thread: Optional[threading.Thread] = None
        #: grace budget for a reconnecting child: the sum of its backoff
        #: schedule plus one extra second of slack
        self.reconnect_window = sum(
            reconnect_backoff * (2 ** i) for i in range(reconnect_tries)
        ) + 1.0

    # -- metrics -----------------------------------------------------------
    def _declare_metrics(self, registry: MetricsRegistry) -> None:
        self.registry = registry
        msgs = registry.counter(
            "s2c2_transport_messages_total", "transport frames",
            ("transport", "direction"))
        by = registry.counter(
            "s2c2_transport_bytes_total", "transport frame bytes",
            ("transport", "direction"))
        self._m_msgs_tx = msgs.labels(transport=self.kind, direction="tx")
        self._m_msgs_rx = msgs.labels(transport=self.kind, direction="rx")
        self._m_bytes_tx = by.labels(transport=self.kind, direction="tx")
        self._m_bytes_rx = by.labels(transport=self.kind, direction="rx")
        self._m_reconnects = registry.counter(
            "s2c2_transport_reconnects_total",
            "worker reconnections accepted", ("transport",))
        self._m_verdicts = registry.counter(
            "s2c2_transport_verdicts_total",
            "heartbeat-silence fail-stop verdicts", ("transport",))
        self._m_chaos = registry.counter(
            "s2c2_transport_chaos_total", "injected transport faults",
            ("transport", "action"))
        self._m_stale = registry.counter(
            "s2c2_transport_stale_total",
            "stale-epoch frames rejected", ("transport",))
        self._m_rejoins = registry.counter(
            "s2c2_rejoins_total",
            "workers un-fenced by the rejoin handshake", ("transport",))

    # -- lifecycle ---------------------------------------------------------
    def start(self, cfg, events, injector, compute, tracer, registry):
        self.n_workers = cfg.n_workers
        self.events = events
        self.tracer = tracer
        self._declare_metrics(registry)
        self.shm_pool = SegmentPool(self.shm_uid, "m",
                                    threshold=self.shm_threshold,
                                    enabled=self.shm, registry=registry,
                                    tracer=tracer, kind=self.kind)
        if self.chaos_cfg is not None:
            self.chaos = _Chaos(self.chaos_cfg, self)

        lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        lsock.bind((self.host, self.port))
        lsock.listen(2 * cfg.n_workers)
        self._lsock = lsock
        addr = lsock.getsockname()
        self.bound_port = addr[1]
        self._detector = FailureDetector(self.n_workers, k=1, slack=1.0,
                                         dead_after=self.dead_after)

        self.endpoints = [RemoteWorkerEndpoint(w, self)
                          for w in range(cfg.n_workers)]
        if self.adopt:
            # adopted children carry shards from the previous epoch:
            # their first attach must run the Rejoin handshake to
            # revalidate (and reinstall on digest mismatch)
            for ep in self.endpoints:
                ep.revalidate = True
        if self.endpoint_seed is not None:
            for ep in self.endpoints:
                self.endpoint_seed(ep)
        if self.adopt and self.adopt_procs is not None:
            self.procs = list(self.adopt_procs)
            for w, p in enumerate(self.adopt_procs[:cfg.n_workers]):
                self.endpoints[w].proc = p
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="transport-accept", daemon=True)
        self._accept_thread.start()

        if not self.adopt:
            # children get the UNWRAPPED injector (the engine's
            # TracedInjector holds the master's tracer and a lock) and
            # re-wrap with their own process-local tracer; the compute
            # backend ships as a spec string for the known unpicklable
            # backends
            base_injector = getattr(injector, "inner", injector)
            spec = _compute_spec(compute)
            ctx = mp.get_context(self.mp_method)
            for w in range(cfg.n_workers):
                p = ctx.Process(
                    target=_worker_main,
                    args=(w, addr[0], addr[1], base_injector, spec,
                          self.hb_interval, self.reconnect_backoff,
                          self.reconnect_tries,
                          self.shm_uid if self.shm else None,
                          self.shm_threshold),
                    name=f"s2c2-worker-{w}", daemon=True)
                p.start()
                self.endpoints[w].proc = p
                self.procs.append(p)

        deadline = time.perf_counter() + self.connect_timeout
        for ep in self.endpoints:
            if not ep.connected_evt.wait(
                    max(deadline - time.perf_counter(), 0.0)):
                if not self.adopt:
                    self.shutdown()
                    raise RuntimeError(
                        f"worker {ep.worker_id} did not connect within "
                        f"{self.connect_timeout}s")
                # adopt mode: survivors of the old epoch reconnect on
                # their own schedule; one that never shows up gets a
                # fail-stop verdict instead of failing recovery outright
                with self._verdict_lock:
                    fresh = ep.worker_id not in self._verdicted
                    self._verdicted.add(ep.worker_id)
                if fresh:
                    self._issue_verdict(ep.worker_id, time.perf_counter())
        self._monitor = threading.Thread(
            target=self._monitor_loop, name="transport-monitor", daemon=True)
        self._monitor.start()
        logger.info("socket transport up (epoch %d%s): %d worker processes "
                    "on %s:%d", self.epoch,
                    ", adopted" if self.adopt else "",
                    cfg.n_workers, addr[0], addr[1])
        return self.endpoints

    def _accept_loop(self) -> None:
        while not self._closing:
            try:
                conn, _ = self._lsock.accept()
            except OSError:
                return                  # listening socket closed
            threading.Thread(target=self._handshake, args=(conn,),
                             name="transport-handshake",
                             daemon=True).start()

    def _handshake(self, conn: socket.socket) -> None:
        try:
            conn.settimeout(10.0)
            msg, _ = _recv_frame(conn)
            conn.settimeout(None)
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except (OSError, EOFError, ConnectionError, pickle.PickleError):
            try:
                conn.close()
            except OSError:
                pass
            return
        recv_t = time.perf_counter()
        if not isinstance(msg, _Hello) or \
                not 0 <= msg.worker_id < self.n_workers:
            logger.warning("rejecting connection: bad hello %r", msg)
            conn.close()
            return
        self.endpoints[msg.worker_id].attach(conn, msg, recv_t)

    # -- §4.4 over the wire ------------------------------------------------
    def _monitor_loop(self) -> None:
        """Feed heartbeat liveness into a dedicated FailureDetector.

        Response vector per tick: 1.0 for a live signal, inf for silence
        — where silence means a connected worker past ``hb_miss``
        heartbeat intervals without any message, a dead child process, or
        a disconnected worker past its reconnect grace window.  The
        detector's ``dead_after`` consecutive-strike rule then yields the
        §4.4 fail-stop verdict, exactly as in-engine detection does at
        round granularity.
        """
        det = self._detector
        silence = self.hb_miss * self.hb_interval
        ev_silence = silence * self.event_silence_factor
        while not self._closing:
            time.sleep(self.hb_interval)
            if self._closing:
                return
            now = time.perf_counter()
            for ep in self.endpoints:
                ep._resend_unacked(now)
            resp = np.ones(self.n_workers)
            with self._verdict_lock:
                verdicted = set(self._verdicted)
            for ep in self.endpoints:
                w = ep.worker_id
                if w in verdicted:
                    resp[w] = np.inf
                    continue
                if ep.connected:
                    if now - ep.last_seen > silence:
                        resp[w] = np.inf
                    else:
                        # asymmetric partition: heartbeats keep arriving
                        # and claim queued/running work, yet the events
                        # channel has been silent far past the heartbeat
                        # window — the c2m event direction is cut
                        with ep._lock:
                            busy_since = ep._busy_since
                            ev_rx = ep.last_event_rx
                        if busy_since is not None and \
                                now - busy_since > ev_silence and \
                                now - ev_rx > ev_silence:
                            resp[w] = np.inf
                elif ep.proc is not None and not ep.proc.is_alive():
                    resp[w] = np.inf
                elif ep._ever_connected and \
                        now - ep.disconnect_t > self.reconnect_window:
                    resp[w] = np.inf
                # else: still connecting / inside the grace window
            verdict = det.evaluate(resp)
            with self._verdict_lock:
                fresh = sorted(verdict["dead"] - self._verdicted)
                self._verdicted.update(fresh)
            for w in fresh:
                self._issue_verdict(w, now)

    def _issue_verdict(self, w: int, now: float) -> None:
        """§4.4 fail-stop verdict, classified by what we know of the worker.

        A dead child process is a PERMANENT verdict (the pre-rejoin
        semantics: fence, kill, never readmit).  A worker whose process is
        still alive — heartbeat silence, a dropped connection past its
        grace window, or a one-way partition — is merely SUSPECTED when
        ``allow_rejoin`` is on: it is fenced out of planning exactly like
        a dead worker, but a later reconnect runs the Rejoin handshake
        and un-fences it.  Either way the collector sees a synthetic
        WorkerFailed so open rounds fail over immediately.
        """
        ep = self.endpoints[w]
        proc_dead = ep.proc is not None and not ep.proc.is_alive()
        suspected = self.allow_rejoin and not proc_dead
        if proc_dead:
            source = "proc-exit"
        elif ep.connected:
            source = "partition"       # conn up, events/heartbeats stalled
        else:
            source = "silence"
        with ep._lock:
            ep.dead = True
            ep.suspected = suspected
        self._m_verdicts.labels(transport=self.kind).inc()
        if self.tracer is not None and self.tracer.enabled:
            self.tracer.emit(obs.KIND_FAILSTOP_VERDICT, worker=w,
                             transport=self.kind, source=source,
                             suspected=suspected)
        logger.warning("worker %d: §4.4 heartbeat verdict — %s (%s)", w,
                       "SUSPECTED, rejoin-eligible" if suspected
                       else "fail-stop, fencing the process", source)
        if not suspected:
            # fence: a permanently verdicted worker must never come back
            # half-alive
            if ep.proc is not None and ep.proc.is_alive():
                try:
                    ep.proc.kill()
                except (OSError, ValueError):
                    pass
            ep._force_close()
            if self.shm_pool is not None:
                # reclaim the data plane: unlink our pending installs for
                # the victim and sweep the dead child's own segments (its
                # SIGKILLed pool never got to clean up).  Unlink never
                # invalidates mappings, so results already attached to
                # open rounds keep decoding.
                self.shm_pool.release_prefix(("install", w))
                SegmentPool.sweep(shm_prefix(self.shm_uid, f"w{w}_"))
        # synthetic crash event: the collector broadcasts WorkerFailed to
        # every live round, which fail over via _failover_dispatch — the
        # round completes on the survivors instead of waiting out §4.3
        self.events.put(WorkerFailed(
            w, -1, now, f"transport: {source} — fail-stop verdict"))

    def _unfence(self, w: int) -> None:
        """Clear a SUSPECTED worker's verdict after a completed rejoin."""
        with self._verdict_lock:
            self._verdicted.discard(w)
        det = self._detector
        if det is not None:
            det.reset_worker(w)

    def _kill_child(self, w: int, reason: str = "") -> None:
        """SIGKILL a worker process (chaos trigger / verdict fencing)."""
        ep = self.endpoints[w]
        logger.warning("killing worker %d process (%s)", w, reason or "-")
        if ep.proc is not None and ep.proc.is_alive():
            try:
                ep.proc.kill()
            except (OSError, ValueError):
                pass

    # -- shared-memory data plane -----------------------------------------
    def _share_x(self, round_id: int,
                 x: np.ndarray) -> Optional[ShmDescriptor]:
        """Share one round's RHS block once; every submit reuses it."""
        pool = self.shm_pool
        if pool is None:
            return None
        with self._x_lock:
            if round_id in self._x_descs:
                return self._x_descs[round_id]
        desc = pool.share(np.ascontiguousarray(x), tag=("x", round_id))
        with self._x_lock:
            # keep-first on a submit race: the loser's segment stays
            # owned under the same tag and is reclaimed at round retire
            return self._x_descs.setdefault(round_id, desc)

    # -- engine hooks ------------------------------------------------------
    def round_retired(self, round_id: int) -> None:
        for ep in self.endpoints:
            ep.round_retired(round_id)
        pool = self.shm_pool
        if pool is not None:
            # decode is done: recycle the round's x segment (owned) and
            # unmap its result attachments; the retired-tag fence makes a
            # straggler share/attach for this round refuse, not leak
            pool.retire_tag(round_id)
            pool.retire_tag(("x", round_id))
            with self._x_lock:
                self._x_descs.pop(round_id, None)

    def _close_lsock(self) -> None:
        """Really stop listening: shutdown() before close().

        The accept thread blocks inside ``accept()``, and on Linux a
        plain ``close()`` from another thread does NOT interrupt it —
        the kernel socket stays accepting, so a child reconnecting into
        the crash window would complete its TCP handshake against a
        zombie listener.  ``shutdown()`` wakes the blocked ``accept()``
        with an error first.
        """
        if self._lsock is None:
            return
        try:
            self._lsock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass                    # not connected / already gone
        try:
            self._lsock.close()
        except OSError:
            pass

    def crash(self) -> None:
        """Simulate master death: sever the master plane, keep children.

        Unlike :meth:`shutdown` no ``_Stop`` is sent and the worker
        processes are NOT joined or killed — they observe the dropped
        connections and enter their reconnect backoff, exactly as they
        would if the master process were SIGKILLed.  A recovery transport
        (``adopt=True``, same port, epoch + 1) then adopts the survivors.
        """
        if self._closed:
            return
        self._closed = True
        self._closing = True
        if self.chaos is not None:
            self.chaos.stop()
        self._close_lsock()
        for ep in self.endpoints:
            with ep._lock:
                conn, ep._conn = ep._conn, None
                ep.connected = False
            if conn is not None:
                try:
                    conn.close()
                except OSError:
                    pass
        if self._monitor is not None:
            self._monitor.join(timeout=2.0)
        if self.shm_pool is not None:
            # a genuinely dead master cannot unlink: close our mappings
            # but leave the names in place — recover() sweeps the "m"
            # prefix, and the surviving children keep their segments
            self.shm_pool.close(unlink=False)
        # deliberately orphan the children: self.procs keeps the handles
        # so a recovery transport (or test teardown) can adopt/kill them

    def shutdown(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._closing = True
        if self.chaos is not None:
            self.chaos.stop()
        for ep in self.endpoints:
            ep.stop()               # best-effort _Stop for a clean exit
        self._close_lsock()
        for p in self.procs:
            p.join(timeout=2.0)
        for p in self.procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=1.0)
        # drain the rx threads before closing the conns: the children
        # flushed their trace tails on _Stop, and those frames sit in the
        # kernel buffer until each reader hits EOF — joining here makes a
        # post-shutdown dump_trace complete
        for ep in self.endpoints:
            rx = ep._rx_thread
            if rx is not None and rx is not threading.current_thread():
                rx.join(timeout=2.0)
        for ep in self.endpoints:
            with ep._lock:
                conn, ep._conn = ep._conn, None
                ep.connected = False
            if conn is not None:
                try:
                    conn.close()
                except OSError:
                    pass
        if self._monitor is not None:
            self._monitor.join(timeout=2.0)
        if self.shm_pool is not None:
            # every child has exited (joined or killed above): release our
            # segments, then sweep the whole lineage so SIGKILLed
            # children's orphans go too — zero residue under the uid
            self.shm_pool.close(unlink=True)
            SegmentPool.sweep(shm_prefix(self.shm_uid))


class FaultyTransport(SocketTransport):
    """Socket transport with the chaos layer armed (see :class:`ChaosConfig`).

    Composes with the slowdown injectors: the injector throttles *compute*
    inside the child processes while the chaos layer corrupts the
    *transport* between them — the two fault planes of the paper's
    evaluation (stragglers and fail-stops) plus the messaging faults a
    real deployment adds on top.
    """

    kind = "proc+chaos"

    def __init__(self, chaos: Optional[ChaosConfig] = None, **kw):
        super().__init__(chaos=chaos if chaos is not None else ChaosConfig(),
                         **kw)


def _compute_spec(compute):
    """Picklable description of the compute backend for the children.

    The port's :class:`KernelBackend` travels as ``"kernel:<device>"`` (its
    device tensors, locks and CUDA state do not pickle): each child builds
    its own backend on the SAME device — it opens its own CUDA context and
    loads the already-built kernel library — and never quietly on another.
    """
    if compute is numpy_backend:
        return "numpy"
    if isinstance(compute, KernelBackend):
        return f"kernel:{compute.device}"
    return compute                  # must be picklable (module-level fn)


def _resolve_compute(spec):
    if spec == "numpy":
        return numpy_backend
    if isinstance(spec, str) and spec.startswith("kernel:"):
        return kernel_backend(spec.split(":", 1)[1])
    return spec


# ---------------------------------------------------------------------------
# child process
# ---------------------------------------------------------------------------

class _ChildNode:
    """One worker process: a real Worker + socket client + pumps.

    Threads: the main thread runs connect/handshake/read (control
    messages, including the synchronous retract RPC, are served inline);
    an event pump forwards the worker's events (re-queuing across
    reconnects so nothing is lost); a heartbeat pump carries liveness +
    stats + the trace batch — and goes silent once the local worker
    fail-stops, extending §4.4 silence semantics to the wire.
    """

    def __init__(self, worker_id: int, host: str, port: int, injector,
                 compute_spec, hb_interval: float,
                 reconnect_backoff: float, reconnect_tries: int,
                 shm_uid: Optional[str] = None,
                 shm_threshold: int = DEFAULT_SHM_THRESHOLD):
        self.worker_id = worker_id
        self.addr = (host, port)
        # child half of the data plane: owns result segments (tagged by
        # round, recycled on the master's _ShmRelease), maps install/RHS
        # segments the master shares.  shm_uid None = inline-only mode.
        self.shm_pool = SegmentPool(shm_uid or "off", f"w{worker_id}",
                                    threshold=shm_threshold,
                                    enabled=shm_uid is not None)
        self.hb_interval = hb_interval
        self.reconnect_backoff = reconnect_backoff
        self.reconnect_tries = reconnect_tries
        self.events: "queue.Queue" = queue.Queue()
        self.tracer = Tracer(enabled=False)
        self.worker = Worker(worker_id, self.events,
                             TracedInjector(injector, self.tracer),
                             _resolve_compute(compute_spec),
                             tracer=self.tracer)
        self.tasks: "Dict[int, ChunkTask]" = {}  # guarded_by: _tasks_lock
        self._tasks_lock = threading.Lock()
        self._sock: Optional[socket.socket] = None
        self._tx_lock = threading.Lock()
        self._connected = threading.Event()
        self._stopping = False
        # at-least-once event delivery: every outgoing event gets a
        # process-lifetime seq and stays buffered until the master's
        # cumulative ack covers it; the heartbeat pump retransmits overdue
        # entries (lost to chaos or to a disconnect window)
        self._ev_seq = 0                     # guarded_by: _ev_lock
        self._ev_unacked: List[List] = []    # guarded_by: _ev_lock
        self._ev_lock = threading.Lock()
        # fencing token adopted from the newest _HelloAck; event seqs are
        # namespaced PER EPOCH, so adopting a new epoch renumbers the
        # unacked buffer (a recovered master's ack floor starts at 0)
        self.epoch = 0                       # guarded_by: _ev_lock

    # -- tx ----------------------------------------------------------------
    def _send(self, msg) -> bool:
        sock = self._sock
        if sock is None:
            return False
        try:
            with self._tx_lock:
                # s2c2lint: ignore[S2C203] _tx_lock only serializes frame
                # writes from the pumps and the control loop; no other
                # work ever runs under it
                _send_parts(sock, encode_frame_parts(msg))
            return True
        except OSError:
            return False

    # -- connection --------------------------------------------------------
    def _connect_once(self) -> Optional[socket.socket]:
        try:
            s = socket.create_connection(self.addr, timeout=10.0)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            return s
        except OSError:
            return None

    def _connect(self, first: bool) -> bool:
        """Connect + handshake, with exponential backoff on retries."""
        delay = self.reconnect_backoff
        tries = self.reconnect_tries
        for attempt in range(tries):
            s = self._connect_once()
            if s is not None:
                try:
                    s.sendall(encode_frame(_Hello(
                        self.worker_id, os.getpid(), time.perf_counter())))
                    s.settimeout(10.0)
                    ack, _ = _recv_frame(s)
                    s.settimeout(None)
                except (OSError, EOFError, ConnectionError,
                        pickle.PickleError):
                    try:
                        s.close()
                    except OSError:
                        pass
                    s = None
                else:
                    if isinstance(ack, _Stop):
                        return False        # master refused (verdicted)
                    if isinstance(ack, _HelloAck):
                        self.tracer.enabled = ack.trace_enabled
                        self.hb_interval = ack.hb_interval
                        self._adopt_epoch(ack.epoch)
                        self._sock = s
                        self._connected.set()
                        return True
                    s.close()
                    s = None
            if attempt + 1 < tries:
                time.sleep(delay)
                delay *= 2
        return False

    def _adopt_epoch(self, epoch: int) -> None:
        """Adopt the master's fencing token (per-_HelloAck / _RejoinReq).

        Event seqs are per-epoch: a recovered master's cumulative-ack
        floor restarts at 0, so the unacked backlog is renumbered 1..len
        and retransmitted under the new epoch — still exactly-once on the
        master side thanks to the (round, chunk) dedup set.
        """
        with self._ev_lock:
            if epoch == self.epoch:
                return
            self.epoch = epoch
            for i, rec in enumerate(self._ev_unacked):
                rec[0] = i + 1
                rec[2] = 0.0        # due immediately at the next sweep
            self._ev_seq = len(self._ev_unacked)
        # the submit-dedup map is ALSO per-epoch: a recovered master's
        # task counter restarts at 1, so surviving entries from the old
        # epoch would swallow fresh submits that recycle an id (acked,
        # never executed).  Old-epoch tasks already queued run to
        # completion regardless — only the id namespace resets.
        with self._tasks_lock:
            self.tasks.clear()

    # -- pumps -------------------------------------------------------------
    def _event_pump(self) -> None:
        while True:
            ev = self.events.get()
            if self._stopping:
                return
            desc = None
            if isinstance(ev, ChunkDone) and ev.result is not None:
                # move the (rows, B) result into a pooled segment and
                # strip it from the event — the descriptor rides the
                # _EventMsg, and retransmits reuse the same segment.
                # share() returning None (small / disabled / round
                # already released) keeps the result inline.
                desc = self.shm_pool.share(
                    np.ascontiguousarray(ev.result), tag=ev.round_id)
                if desc is not None:
                    ev = dataclasses.replace(ev, result=None)
            with self._ev_lock:
                self._ev_seq += 1
                seq = self._ev_seq
                epoch = self.epoch
                self._ev_unacked.append([seq, ev, time.perf_counter(),
                                         desc])
            # best-effort first send; loss (chaos, disconnect window) is
            # repaired by the retransmit sweep until the master's ack lands
            self._send(_EventMsg(ev, seq, epoch=epoch, shm=desc))

    def _retransmit_events(self, now: float) -> None:
        timeout = max(4 * self.hb_interval, 0.2)
        due: List[Tuple[int, Any, Optional[ShmDescriptor]]] = []
        with self._ev_lock:
            epoch = self.epoch
            for rec in self._ev_unacked:
                if now - rec[2] >= timeout:
                    rec[2] = now
                    due.append((rec[0], rec[1], rec[3]))
        for seq, ev, desc in due:
            self._send(_EventMsg(ev, seq, epoch=epoch, shm=desc))

    def _heartbeat_pump(self) -> None:
        seq = 0
        while not self._stopping:
            time.sleep(self.hb_interval)
            w = self.worker
            if w.dead:
                # fail-stop is SILENCE: stop heartbeating (and abandoning
                # retransmits) so the master's §4.4 monitor sees exactly
                # what the paper's model says — nothing
                continue
            if not self._connected.is_set():
                continue
            now = time.perf_counter()
            self._retransmit_events(now)
            if self.tracer.enabled:
                records = self.tracer.drain()
                if records:
                    self._send(_TraceBatch(self.worker_id, records))
            seq += 1
            with self._ev_lock:
                epoch = self.epoch
            self._send(_Heartbeat(
                worker_id=self.worker_id, seq=seq, t_worker=now,
                busy_s=w.busy_s, idle_s=w.idle_seconds(now),
                retracted_total=w.retracted_total,
                backlog=w.backlog(),
                backlog_by_round=w.backlog_by_round(),
                idle=w.idle(), epoch=epoch))

    # -- control -----------------------------------------------------------
    def _handle(self, msg) -> None:
        w = self.worker
        if isinstance(msg, _SubmitTask):
            with self._ev_lock:
                epoch = self.epoch
            if msg.epoch and msg.epoch < epoch:
                # stale-epoch submit from a fenced (pre-crash) master:
                # drop WITHOUT acking so the zombie can't make progress
                logger.warning("worker %d: dropping stale-epoch submit "
                               "(epoch %d < %d)", self.worker_id,
                               msg.epoch, epoch)
                return
            # ack first (protected from chaos), then dedup: a retransmit
            # of a submit we already queued/ran must not recompute
            self._send(_SubmitAck(msg.task_id))
            with self._tasks_lock:
                if msg.task_id in self.tasks:
                    return
            if msg.x_desc is not None:
                # zero-copy RHS: map the master's shared segment (cached
                # per round).  A miss means the round already retired
                # master-side and its segment was reclaimed — drop the
                # task; nobody wants its results.
                x = self.shm_pool.attach(msg.x_desc, tag=msg.round_id)
                if x is None:
                    logger.warning(
                        "worker %d: RHS segment %s gone (round %d "
                        "retired?) — dropping task %d", self.worker_id,
                        msg.x_desc.name, msg.round_id, msg.task_id)
                    return
            else:
                x = np.asarray(msg.x)
                # round snapshots are immutable on the master; restore the
                # flag so shard-aware backends may identity-key device
                # copies
                x.setflags(write=False)
            task = ChunkTask(round_id=msg.round_id,
                             iteration=msg.iteration,
                             shard_id=msg.shard_id,
                             chunks=list(msg.chunks), x=x,
                             row_cost=msg.row_cost,
                             cancel=threading.Event())
            with self._tasks_lock:
                self.tasks[msg.task_id] = task
                while len(self.tasks) > 4096:   # bound the id map
                    self.tasks.pop(next(iter(self.tasks)))
            w.submit(task)
        elif isinstance(msg, _CancelTask):
            with self._tasks_lock:
                task = self.tasks.pop(msg.task_id, None)
            if task is not None:
                task.cancel.set()
        elif isinstance(msg, _RetractReq):
            taken = w.retract(msg.round_id, list(msg.chunk_ids),
                              limit=msg.limit)
            self._send(_RetractReply(msg.req_id, taken))
        elif isinstance(msg, _EventAck):
            with self._ev_lock:
                self._ev_unacked = [r for r in self._ev_unacked
                                    if r[0] > msg.cum_seq]
        elif isinstance(msg, _RejoinReq):
            # rejoin handshake: adopt the (possibly new) epoch, then prove
            # our installed shards by content digest — the master
            # reinstalls only the mismatches over the wire
            with self._ev_lock:
                epoch = self.epoch
            if msg.epoch >= epoch:
                self._adopt_epoch(msg.epoch)
                self._send(_Rejoin(self.worker_id, msg.epoch,
                                   w.shard_digests()))
            else:
                logger.warning("worker %d: ignoring stale-epoch rejoin "
                               "request (epoch %d < %d)", self.worker_id,
                               msg.epoch, epoch)
        elif isinstance(msg, _Promote):
            w.promote_round(msg.round_id)
        elif isinstance(msg, _InstallShard):
            w.install_shard(msg.shard_id, msg.rows)
        elif isinstance(msg, _InstallShardShm):
            # map the master's install segment and keep the mapping for
            # the shard's lifetime (the worker stores the view directly —
            # ascontiguousarray is a no-op on a contiguous float64 view).
            # The ack lets the master unlink the name: from here on the
            # only resident copy is this mapping.
            view = self.shm_pool.attach(msg.desc,
                                        tag=("shard", msg.shard_id))
            if view is not None:
                w.install_shard(msg.shard_id, view)
                self._send(_ShmAck([msg.desc.name]))
            else:
                # no ack: the master keeps the segment; a rejoin's digest
                # mismatch reinstalls (shm or inline) if it matters
                logger.warning("worker %d: install segment %s not "
                               "mappable; shard %s NOT installed",
                               self.worker_id, msg.desc.name, msg.shard_id)
        elif isinstance(msg, _ShmRelease):
            with self._ev_lock:
                epoch = self.epoch
            if msg.epoch and msg.epoch < epoch:
                logger.warning("worker %d: dropping stale-epoch shm "
                               "release (epoch %d < %d)", self.worker_id,
                               msg.epoch, epoch)
                return
            # round retired: recycle our result segments for it and unmap
            # its RHS attachment; the retired-tag fence makes a straggler
            # result for this round fall back to inline (harmless — the
            # master drops retired-round events anyway)
            self.shm_pool.retire_tag(msg.round_id)
        elif isinstance(msg, _DropShard):
            w.drop_shard(msg.shard_id)
            self.shm_pool.detach_tag(("shard", msg.shard_id))
        elif isinstance(msg, _Stop):
            # flush the trace tail first: the master's reader drains this
            # frame before EOF, so a post-shutdown dump_trace still shows
            # the final worker spans
            if self.tracer.enabled:
                records = self.tracer.drain()
                if records:
                    self._send(_TraceBatch(self.worker_id, records))
            self._stopping = True
        else:
            logger.debug("worker %d: unknown control %r",
                         self.worker_id, type(msg).__name__)

    # -- main --------------------------------------------------------------
    def run(self) -> int:
        self.worker.start()
        if not self._connect(first=True):
            return 1
        threading.Thread(target=self._event_pump, name="event-pump",
                         daemon=True).start()
        threading.Thread(target=self._heartbeat_pump, name="hb-pump",
                         daemon=True).start()
        while True:
            sock = self._sock
            try:
                while not self._stopping:
                    msg, _ = _recv_frame(sock)
                    self._handle(msg)
            except (OSError, EOFError, ConnectionError, pickle.PickleError):
                pass
            self._connected.clear()
            try:
                sock.close()
            except OSError:
                pass
            if self._stopping:
                self.worker.abort()
                self.shm_pool.close()
                return 0
            # reconnect with exponential backoff; exhaustion = give up
            # (the master's grace window expires and verdicts us)
            if not self._connect(first=False):
                self.shm_pool.close()
                return 1


def _worker_main(worker_id: int, host: str, port: int, injector,
                 compute_spec, hb_interval: float, reconnect_backoff: float,
                 reconnect_tries: int, shm_uid: Optional[str] = None,
                 shm_threshold: int = DEFAULT_SHM_THRESHOLD) -> None:
    """Child-process entry point (spawn target)."""
    node = _ChildNode(worker_id, host, port, injector, compute_spec,
                      hb_interval, reconnect_backoff, reconnect_tries,
                      shm_uid, shm_threshold)
    code = node.run()
    # immediate exit: daemon threads (pumps, worker) must not block
    # interpreter teardown, and a fail-stopped worker has nothing to flush
    os._exit(code)
