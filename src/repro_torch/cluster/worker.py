"""Worker thread: holds coded shards, really computes assigned chunks.

A worker owns a shard store (``shard_id -> np.ndarray`` of coded rows, one
entry per tenant job), a **retractable deque** of per-chunk work items, and
pushes :class:`ChunkDone` / :class:`WorkerDone` events to the master's
single event queue.  Chunks are computed *one at a time, in queue order* —
that is what makes partial work and out-of-order any-k collection real:
the master sees chunk-granular completions interleaved across workers and
can stop, cancel, reassign, **retract**, or **reprioritize** between any
two of them.

The inbox is chunk-granular on purpose (the work-stealing substrate): a
dispatched :class:`ChunkTask` is split into one queue item per chunk, and
the master may

* :meth:`Worker.retract` not-yet-started chunks (each retracted chunk is
  provably never computed — retraction is atomic against the run loop, so
  a chunk is either still queued here and silently removed, or already
  taken by the executor and guaranteed to produce a :class:`ChunkDone`);
* :meth:`Worker.promote_round` a latency-critical round's queued chunks to
  the front of the deque (stable within the round);
* observe :meth:`Worker.backlog` / :meth:`Worker.idle` to drive the
  idle-triggered steal pass.

Speed injection: before each chunk the worker asks its injector for the
current speed ``s`` and stretches the chunk to ``rows · B · row_cost / s``
seconds of wall time, where ``B`` is the RHS width (compute runs natively;
the remainder is slept, so the throttling is real wall-clock, not
bookkeeping).  A multi-RHS chunk does ``B×`` the work of a matvec chunk,
so it must pay ``B×`` the virtual time — otherwise injector-driven
benchmarks would silently under-throttle batched rounds and the
exec-vs-sim calibration would drift.  ``s == 0`` ⇒ fail-stop:
the worker drops all work silently and ignores everything from then on.
A backend *exception* is the opposite of fail-stop silence: the worker
emits a terminal :class:`WorkerFailed` event carrying the real error before
going dead, so the master can log a reason and fail over immediately
instead of waiting out the §4.4 silence detector.

The compute backend is pluggable: the default, :class:`KernelBackend` (via
:func:`kernel_backend`), routes each chunk through the port's
``coded_matvec`` kernel on the card (its plain PyTorch version for
``device="cpu"``), on float32 shards kept on the device;
:func:`numpy_backend` is plain float64 BLAS on the host (``a[rows] @ x`` —
a BLAS-2 matvec for a 1-D operand, one BLAS-3 GEMM for an ``(d, B)``
multi-RHS block), taken only when the caller passes it.  A
backend may additionally implement the shard-aware protocol
(``compute_chunk(worker_id, shard_id, shard, r0, r1, x)`` plus optional
``install_shard(worker_id, shard_id, shard)`` and ``drop_shard(worker_id,
shard_id)``): the worker then hands it the whole
shard and the chunk range, which lets the backend keep a device-resident
copy of each shard instead of re-uploading rows on every chunk.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import threading
import time
import weakref
from collections import OrderedDict, deque
from typing import (Callable, Deque, Dict, List, Optional, Sequence, Set,
                    Tuple)

import numpy as np
import torch

from repro_torch._device import device_guard, resolve_device
from repro_torch.cluster import obs
from repro_torch.cluster.obs import NULL_TRACER, Tracer
from repro_torch.kernels import ops
from repro_torch.kernels.coded_matvec import MAX_NVEC

__all__ = ["ChunkTask", "ChunkDone", "WorkerDone", "WorkerFailed",
           "WorkerRejoined", "Worker", "numpy_backend", "kernel_backend",
           "KernelBackend", "rhs_width", "shard_digest"]

logger = logging.getLogger("repro_torch.cluster.worker")

ComputeFn = Callable[[np.ndarray, np.ndarray], np.ndarray]


def rhs_width(x: np.ndarray) -> int:
    """Number of RHS columns: 1 for a vector, B for an ``(d, B)`` block."""
    return 1 if x.ndim == 1 else int(x.shape[1])


@dataclasses.dataclass
class ChunkTask:
    """One dispatch: compute ``chunks`` of shard ``shard_id`` against ``x``.

    chunks: list of (chunk_id, row_start, row_stop) in computation order.
    x: the round's RHS operand — a ``(d,)`` vector (matvec round) or an
        ``(d, B)`` multi-RHS block (batched round); each chunk then yields
        a ``(rows,)`` or ``(rows, B)`` partial.
    row_cost: seconds of *virtual* wall time per row PER RHS COLUMN at
        speed 1.0 (the engine's calibration knob — real compute below it is
        topped up by sleeping, which is how injected slowdowns throttle
        real work; a B-wide chunk is stretched to B× the matvec time).
    cancel: master-held event; checked before every chunk.
    """

    round_id: int
    iteration: int
    shard_id: str
    chunks: List[Tuple[int, int, int]]
    x: np.ndarray
    row_cost: float
    cancel: threading.Event


@dataclasses.dataclass
class ChunkDone:
    worker: int
    round_id: int
    chunk_id: int
    result: np.ndarray
    t: float                       # perf_counter at completion
    t_start: float = 0.0           # when the worker BEGAN this task — under
    #                                pipelining that is dequeue time, not
    #                                dispatch time (tasks queue behind other
    #                                rounds'); lets the master separate
    #                                service time from queue wait


@dataclasses.dataclass
class WorkerDone:
    """Worker finished its task — or acked a master-initiated cancel.

    ``cancelled=True`` means the task ended early without completing its
    assignment: a master cancel, a tenant eviction mid-task, or a
    retraction that emptied the task's queue (an ack, not a completion —
    retraction must never earn §4.3 deadline credit).  A fail-stopped
    worker emits nothing at all — silence is the failure signal.
    """

    worker: int
    round_id: int
    t: float
    chunks_done: int
    cancelled: bool = False
    t_start: float = 0.0           # see ChunkDone.t_start


@dataclasses.dataclass
class WorkerFailed:
    """Terminal event: the worker's backend raised and the worker is dead.

    Unlike fail-stop (pure silence, detected only by the §4.4 strike
    counter), a crash is *observable* — this event carries the real error
    so the master can log a reason and immediately fail the worker over
    instead of waiting for the silence detector.
    """

    worker: int
    round_id: int
    t: float
    error: str
    t_start: float = 0.0


@dataclasses.dataclass
class WorkerRejoined:
    """A SUSPECTED (partitioned/silent) worker completed the Rejoin
    handshake: its shards are digest-verified and it is un-fenced back
    into planning.  ``round_id`` is always -1 — rejoin is a worker-scope
    event the collector broadcasts, not a round outcome.
    """

    worker: int
    round_id: int
    t: float
    t_start: float = 0.0


def shard_digest(rows: np.ndarray) -> str:
    """Content digest of an installed shard (rejoin revalidation).

    Covers the raw bytes plus shape and dtype, so a truncated or
    re-typed shard never digests equal to the master's copy.
    """
    arr = np.ascontiguousarray(rows)
    h = hashlib.sha256()
    h.update(str((arr.shape, str(arr.dtype))).encode())
    # the array's own buffer, not a tobytes() copy: hashlib releases the
    # GIL while it hashes a buffer, and a copy of a 983 MB shard held it
    # for over 0.2 s, so a child digesting for the rejoin handshake went
    # silent past the heartbeat window and drew a §4.4 verdict
    h.update(arr.reshape(-1).view(np.uint8))
    return h.hexdigest()


def numpy_backend(a_rows: np.ndarray, x: np.ndarray) -> np.ndarray:
    return a_rows @ x


class KernelBackend:
    """The port's ``coded_matvec`` kernel as the workers' compute, with the
    shards resident on the device.

    It implements the worker's shard-aware protocol:

    * each (worker_id, shard_id) shard is converted to float32 (the kernel's
      compute dtype) and uploaded ONCE, when the worker installs it
      (``install_shard``; a chunk uploads a shard only if none was
      installed), and stays on the device until the tenant is unloaded
      (``drop_shard``);
    * the per-chunk operand x is cached in a small LRU (see ``_device_x``)
      so pipelined tenants alternating RHS operands all stay cached at
      once; small operands are content-keyed, large immutable blocks are
      identity-keyed (content-keying an ``(d, B)`` block would cost
      O(d·B) per chunk);
    * a chunk is one ``coded_matvec`` launch on the rows where they lie in
      the resident shard: the view ``shard[r0:r1]`` with block id 0;
    * an ``(d, B)`` operand wider than the kernel's ``MAX_NVEC`` columns is
      cut into column groups of at most ``MAX_NVEC``, one launch each.

    Neither rows nor widths are padded: the JAX package's backend pads both
    to powers of two only to bound jit retraces, and a CUDA launch does not
    retrace.  Results come back as float64 numpy arrays, ``(rows,)`` or
    ``(rows, B)``.

    ``device`` is the card by default; ``device="cpu"`` runs the kernel's
    plain PyTorch version on the host.  On a card the kernel launches or
    raises: there is no fallback to the plain version.

    One instance is shared by all workers of ONE engine (shard ids are
    engine-scoped — do not share a backend between engines); cache
    mutation is lock-guarded, compute itself runs lock-free.  A straggler
    mid-chunk while its tenant unloads may cache the shard again after
    ``drop_shard``; its ``Worker`` drops it once more when the chunk
    returns, so no shard outlives its tenant.  Both caches are LRU-capped
    as well.
    """

    _SHARD_CACHE_CAP = 128
    _X_CACHE_CAP = 16
    _X_HASH_CAP = 64 * 1024        # max bytes content-keyed per lookup

    def __init__(self, device: "str | torch.device" = "cuda"):
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            # worker threads start on device 0: pin the card each launch uses
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self._lock = threading.Lock()
        # guarded_by: _lock
        self._shards: "OrderedDict[Tuple[int, str], torch.Tensor]" = OrderedDict()
        # x LRU: one slot per distinct operand, so concurrent rounds
        # alternating RHS operands (pipelined tenants) each keep their
        # device copy instead of evicting one another on every chunk.
        # Entries are (weakref-anchor-or-None, column groups) pairs — see
        # _device_x for the keying scheme and how the weakref keeps
        # identity keys sound without pinning dead rounds' host arrays.
        # Key and value land atomically under the lock.
        self._x_cache: "OrderedDict[Tuple, Tuple]" = OrderedDict()  # guarded_by: _lock
        self._x_hits = 0                # guarded_by: _lock
        self._x_misses = 0              # guarded_by: _lock
        # every launch computes block 0 of the chunk's view; read-only
        self._block0 = torch.zeros(1, dtype=torch.int32, device=dev)

    # -- shard-aware protocol ----------------------------------------------
    def _device_shard(self, worker_id: int, shard_id: str,
                      shard: np.ndarray) -> torch.Tensor:
        key = (worker_id, shard_id)
        with self._lock:
            dev = self._shards.get(key)
            if dev is not None:
                self._shards.move_to_end(key)
        if dev is None:
            dev = self._store(key, shard)
        return dev

    def _store(self, key: Tuple[int, str], shard: np.ndarray) -> torch.Tensor:
        dev = self._upload(shard)
        with self._lock:
            self._shards[key] = dev
            self._shards.move_to_end(key)
            while len(self._shards) > self._SHARD_CACHE_CAP:
                self._shards.popitem(last=False)
        return dev

    def install_shard(self, worker_id: int, shard_id: str,
                      shard: np.ndarray) -> None:
        """Upload at install, replacing any earlier device copy of the id.

        A worker's first chunk then computes from a resident shard: an
        upload inside it (0.3-0.5 s for a 491 MB shard on an H100's host,
        longer with several children converting at once) outlasted the
        socket transport's event-silence window, so every healthy child
        of a process pool was SUSPECTED in its first round.
        """
        self._store((worker_id, shard_id), shard)

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        # a C-ordered float32 copy: the kernel takes contiguous operands
        # (a Fortran-ordered ``W.T`` would stay strided), and a CPU tensor
        # never aliases the caller's array
        host = np.array(arr, dtype=np.float32, order="C", copy=True)
        return torch.from_numpy(host).to(self.device)

    def _upload_x(self, x: np.ndarray) -> Tuple[torch.Tensor, ...]:
        """x on the device as the column groups the kernel takes."""
        xd = self._upload(x)
        if xd.ndim == 1 or xd.shape[1] <= MAX_NVEC:
            return (xd,)
        return tuple(xd[:, c:c + MAX_NVEC].contiguous()
                     for c in range(0, xd.shape[1], MAX_NVEC))

    def _device_x(self, x: np.ndarray) -> Tuple[torch.Tensor, ...]:
        """Device copy of the RHS operand, LRU-cached.

        The keying trades per-chunk cost against soundness:

        * small operands (≤ ``_X_HASH_CAP`` bytes) are CONTENT-keyed —
          cheap, and in-place mutation between rounds (gradient descent's
          ``w -= ...`` on the same array object) can never serve a stale
          device copy;
        * a larger block would pay O(d·B) per chunk to content-key, so a
          read-only array (the engine marks every round snapshot
          immutable) is keyed by IDENTITY instead.  Sound because the
          entry carries a weakref to the exact array object: while the
          array is alive its id cannot be reused (and immutability rules
          out content drift under the same id), and once it dies the
          dead weakref unmasks any id-reusing impostor — the entry is
          dropped and re-uploaded instead of served stale.  A weakref,
          not a strong anchor, so the cache never pins dead rounds'
          large host snapshots in memory;
        * a large *writeable* array has no sound O(1) key (hashing a
          capped prefix would miss mutations past the cap), so it
          bypasses the cache entirely: always a fresh upload, never a
          stale hit.
        """
        if x.nbytes <= self._X_HASH_CAP:
            key: Tuple = ("by", x.shape, x.dtype.str, x.tobytes())
            anchor = None
        elif not x.flags.writeable:
            key = ("ro", id(x), x.shape, x.dtype.str)
            anchor = weakref.ref(x)
        else:
            with self._lock:
                self._x_misses += 1
            return self._upload_x(x)
        with self._lock:
            hit = self._x_cache.get(key)
            if hit is not None:
                ref = hit[0]
                if ref is None or ref() is not None:
                    self._x_cache.move_to_end(key)
                    self._x_hits += 1
                    return hit[1]
                # anchored array died: this id may now belong to a
                # different array — drop the stale entry, treat as a miss
                del self._x_cache[key]
            self._x_misses += 1
        dev = self._upload_x(x)
        with self._lock:
            self._x_cache[key] = (anchor, dev)
            while len(self._x_cache) > self._X_CACHE_CAP:
                self._x_cache.popitem(last=False)
        return dev

    def _matvec(self, a: torch.Tensor,
                groups: Tuple[torch.Tensor, ...]) -> np.ndarray:
        """``a @ x``, one launch per column group."""
        with device_guard(self.device):
            outs = [ops.coded_matvec(a, xg, self._block0, a.shape[0])
                    for xg in groups]
            out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1)
            return out[0].cpu().numpy().astype(np.float64)

    def compute_chunk(self, worker_id: int, shard_id: str, shard: np.ndarray,
                      r0: int, r1: int, x: np.ndarray) -> np.ndarray:
        dev = self._device_shard(worker_id, shard_id, shard)
        return self._matvec(dev[r0:r1], self._device_x(x))

    def drop_shard(self, worker_id: int, shard_id: str) -> None:
        with self._lock:
            self._shards.pop((worker_id, shard_id), None)

    def cache_info(self) -> dict:
        with self._lock:
            return {"shards": len(self._shards),
                    "x_entries": len(self._x_cache),
                    "x_hits": self._x_hits,
                    "x_misses": self._x_misses}

    # -- plain ComputeFn protocol ------------------------------------------
    def __call__(self, a_rows: np.ndarray, x: np.ndarray) -> np.ndarray:
        return self._matvec(self._upload(a_rows), self._upload_x(x))


def kernel_backend(device: "str | torch.device" = "cuda") -> KernelBackend:
    """Chunk compute through the port's coded_matvec kernel (shards cached
    on ``device``)."""
    return KernelBackend(device=device)


class _TaskProgress:
    """Shared bookkeeping of one ChunkTask across its queued chunk items.

    ``remaining`` counts queued + currently-executing chunks; it reaches
    zero exactly once (completion, cancellation purge, or retraction of the
    last queued chunk), which is what guarantees exactly one terminal
    WorkerDone per task.  All mutation happens under the worker's
    condition lock.
    """

    __slots__ = ("task", "remaining", "done", "running", "started", "t_start")

    def __init__(self, task: ChunkTask, n_chunks: int):
        self.task = task
        # queued + executing chunks; see the class docstring's terminal-
        # WorkerDone invariant (the worker's condition lock, not a
        # _TaskProgress-private one — progress is shared with retract())
        # guarded_by: _cv
        self.remaining = n_chunks
        self.done = 0
        self.running = False
        self.started = False
        self.t_start = 0.0


# queue item: (progress, chunk_id, row_start, row_stop)
_Item = Tuple[_TaskProgress, int, int, int]


class Worker(threading.Thread):
    """One cluster node: shard store + retractable sequential chunk executor."""

    def __init__(self, worker_id: int, event_queue,
                 injector, compute: Optional[ComputeFn] = None,
                 tracer: Optional[Tracer] = None):
        super().__init__(name=f"worker-{worker_id}", daemon=True)
        self.worker_id = worker_id
        self.events = event_queue
        self.injector = injector
        # the card's kernel unless the caller passes a backend
        self.compute = compute = (compute if compute is not None
                                  else kernel_backend())
        self.tracer = tracer if tracer is not None else NULL_TRACER
        # shard-aware backends get the whole shard + chunk range and may
        # keep a device-resident copy (see KernelBackend)
        self._compute_chunk = getattr(compute, "compute_chunk", None)
        self._compute_install = getattr(compute, "install_shard", None)
        self._compute_drop = getattr(compute, "drop_shard", None)
        self._cv = threading.Condition()
        self._items: Deque[_Item] = deque()          # guarded_by: _cv
        self._active: Optional[_TaskProgress] = None  # guarded_by: _cv
        # in-progress idle wait
        self._idle_since: Optional[float] = None     # guarded_by: _cv
        self._stopped = False                        # guarded_by: _cv
        self.shards: Dict[str, np.ndarray] = {}  # guarded_by: _shard_lock
        self._shard_lock = threading.Lock()
        self.dead = False
        self.busy_s = 0.0           # wall seconds spent computing chunks
        self.idle_s = 0.0           # wall seconds spent waiting for work
        self.retracted_total = 0    # lifetime chunks retracted by the master

    # -- shard management (called from the master thread) -------------------
    def install_shard(self, shard_id: str, rows: np.ndarray) -> None:
        rows = np.ascontiguousarray(rows, dtype=np.float64)
        with self._shard_lock:
            self.shards[shard_id] = rows
        if self._compute_install is not None:
            self._compute_install(self.worker_id, shard_id, rows)

    def drop_shard(self, shard_id: str) -> None:
        with self._shard_lock:
            self.shards.pop(shard_id, None)
        if self._compute_drop is not None:
            self._compute_drop(self.worker_id, shard_id)

    def shard_digests(self) -> Dict[str, str]:
        """Content digests of every installed shard (rejoin handshake)."""
        with self._shard_lock:
            items = list(self.shards.items())
        return {sid: shard_digest(rows) for sid, rows in items}

    # -- dispatch ----------------------------------------------------------
    def submit(self, task: ChunkTask) -> None:
        """Enqueue one chunk item per task chunk (FIFO behind queued work)."""
        tp = _TaskProgress(task, len(task.chunks))
        with self._cv:
            for chunk_id, r0, r1 in task.chunks:
                self._items.append((tp, chunk_id, r0, r1))
            self._cv.notify()

    def stop(self) -> None:
        """Drain remaining queued work, then exit the thread."""
        with self._cv:
            self._stopped = True
            self._cv.notify_all()

    def abort(self) -> None:
        """Stop WITHOUT draining: discard queued work and exit ASAP.

        Engine shutdown path — a closing engine must not sit through a
        backlog of throttled chunks nobody will collect.  The currently
        executing chunk (if any) still completes; its events go to a queue
        nobody reads, which is fine.
        """
        with self._cv:
            self._items.clear()
            self._stopped = True
            self._cv.notify_all()

    def cancel_task(self, task: ChunkTask) -> None:
        """Cancel a dispatched task (sets its master-held cancel event).

        Indirection point for the transport plane: a remote endpoint
        overrides this to also send the cancel over the wire.
        """
        task.cancel.set()

    # -- master-side queue surgery (the work-stealing substrate) -----------
    def backlog(self, round_id: Optional[int] = None) -> int:
        """Queued (not yet started) chunk count, optionally for one round."""
        with self._cv:
            if round_id is None:
                return len(self._items)
            return sum(1 for it in self._items
                       if it[0].task.round_id == round_id)

    def idle(self) -> bool:
        """True iff nothing is queued and nothing is executing."""
        with self._cv:
            return not self._items and self._active is None

    def backlog_by_round(self) -> Dict[int, int]:
        """Queued chunk counts keyed by round id (one queue scan).

        Heartbeat payload for the multi-process transport: the master-side
        endpoint answers ``backlog(rid)`` probes from this snapshot instead
        of a per-probe round trip.
        """
        with self._cv:
            out: Dict[int, int] = {}
            for it in self._items:
                rid = it[0].task.round_id
                out[rid] = out.get(rid, 0) + 1
            return out

    def retract(self, round_id: int, chunk_ids: Sequence[int],
                limit: Optional[int] = None) -> List[int]:
        """Remove up to ``limit`` not-yet-started chunks of ``round_id``.

        Returns the chunk ids actually retracted.  Atomic against the run
        loop: a returned chunk was still queued and will NEVER produce an
        event; a chunk not returned either never existed here or was
        already taken by the executor (it WILL produce its ChunkDone) —
        there is no third state, which is what makes stolen coverage
        impossible to double-count.  Retraction prefers the *back* of the
        queue (the chunks that would have run last), leaving the donor's
        imminent work untouched.  A task whose queue empties entirely
        through retraction emits one cancelled-style WorkerDone ack so the
        master sees the worker go idle without awarding deadline credit.
        """
        want: Set[int] = set(chunk_ids)
        cap = len(want) if limit is None else max(int(limit), 0)
        taken: List[int] = []
        drained: List[_TaskProgress] = []
        with self._cv:
            kept: List[_Item] = []
            for item in reversed(self._items):      # steal from the tail
                tp, cid, _r0, _r1 = item
                if (len(taken) < cap and cid in want
                        and tp.task.round_id == round_id
                        and not tp.task.cancel.is_set()):
                    want.discard(cid)               # each id at most once
                    taken.append(cid)
                    tp.remaining -= 1
                    if tp.remaining == 0 and not tp.running:
                        drained.append(tp)
                else:
                    kept.append(item)
            if taken:
                kept.reverse()
                self._items = deque(kept)
                self.retracted_total += len(taken)
        now = time.perf_counter()
        if taken:
            if self.tracer.enabled:
                for cid in taken:
                    self.tracer.emit(obs.KIND_RETRACT, worker=self.worker_id,
                                     round_id=round_id, chunk_id=cid, t=now)
            logger.debug("worker %d: retracted chunks %s of round %d",
                         self.worker_id, taken, round_id)
        for tp in drained:
            self.events.put(WorkerDone(self.worker_id, tp.task.round_id,
                                       now, tp.done, cancelled=True,
                                       t_start=tp.t_start or now))
        return taken

    def promote_round(self, round_id: int) -> int:
        """Move queued chunks of ``round_id`` to the queue front (stable).

        Used by the master to let a §4.3 recovery dispatch jump the
        cross-round FIFO instead of queueing behind other tenants' work.
        Returns the number of promoted items.
        """
        with self._cv:
            front = [it for it in self._items
                     if it[0].task.round_id == round_id]
            if not front:
                return 0
            back = [it for it in self._items
                    if it[0].task.round_id != round_id]
            self._items = deque(front + back)
            return len(front)

    # -- main loop ---------------------------------------------------------
    def idle_seconds(self, now: Optional[float] = None) -> float:
        """Settled idle time plus the currently in-progress wait (if any).

        The in-progress term matters: a worker that finished its last task
        blocks in the run loop until shutdown, and that tail idleness must
        be visible to pool instrumentation read mid-run.
        """
        if now is None:
            now = time.perf_counter()
        with self._cv:
            extra = (now - self._idle_since
                     if self._idle_since is not None and not self.dead
                     else 0.0)
            return self.idle_s + max(extra, 0.0)

    def run(self) -> None:
        while True:
            t_wait = time.perf_counter()
            with self._cv:
                self._idle_since = t_wait
                while not self._items and not self._stopped:
                    self._cv.wait()
                self._idle_since = None
                if not self.dead:
                    self.idle_s += time.perf_counter() - t_wait
                if not self._items:
                    return              # stopped and drained
                tp, chunk_id, r0, r1 = self._items.popleft()
                tp.running = True
                self._active = tp
                if not tp.started:
                    tp.started = True
                    tp.t_start = time.perf_counter()
            try:
                if self.dead:
                    # fail-stopped: consume silently, forever
                    with self._cv:
                        tp.remaining -= 1
                else:
                    self._run_item(tp, chunk_id, r0, r1)
            finally:
                with self._cv:
                    tp.running = False
                    self._active = None

    def _purge_task(self, tp: _TaskProgress) -> None:
        """Drop every remaining queued chunk of ``tp`` (cancel/evict/death)."""
        with self._cv:
            survivors = [it for it in self._items if it[0] is not tp]
            # the popped (executing) item plus the purged ones all uncount
            tp.remaining = 0
            self._items = deque(survivors)

    def _drop_everything(self) -> None:
        with self._cv:
            self._items.clear()

    def _run_item(self, tp: _TaskProgress, chunk_id: int,
                  r0: int, r1: int) -> None:
        task = tp.task
        with self._shard_lock:
            a = self.shards.get(task.shard_id)
        if task.cancel.is_set() or a is None:
            # cancelled (or tenant unloaded mid-task): remaining chunks
            # abandoned, ack so the master knows this worker is idle
            self._purge_task(tp)
            now = time.perf_counter()
            if self.tracer.enabled:
                self.tracer.emit(obs.KIND_CANCEL_ACK, worker=self.worker_id,
                                 round_id=task.round_id, t=now)
            self.events.put(WorkerDone(self.worker_id, task.round_id,
                                       now, tp.done,
                                       cancelled=True,
                                       t_start=tp.t_start))
            return
        s = self.injector.speed(self.worker_id, task.iteration)
        if s <= 0.0:
            self.dead = True        # fail-stop: no event, ever again
            if self.tracer.enabled:
                self.tracer.emit(obs.KIND_FAIL_STOP, worker=self.worker_id,
                                 round_id=task.round_id,
                                 iteration=task.iteration)
            logger.debug("worker %d: injected fail-stop at iteration %d "
                         "(round %d)", self.worker_id, task.iteration,
                         task.round_id)
            self._drop_everything()
            return
        t0 = time.perf_counter()
        try:
            if self._compute_chunk is not None:
                y = self._compute_chunk(self.worker_id, task.shard_id, a,
                                        r0, r1, task.x)
            else:
                y = self.compute(a[r0:r1], task.x)
        except Exception as exc:
            # a backend error is NOT fail-stop silence: report the real
            # reason terminally, then go dead (every later item is dropped)
            self.dead = True
            now = time.perf_counter()
            if self.tracer.enabled:
                self.tracer.emit(obs.KIND_WORKER_FAILED,
                                 worker=self.worker_id,
                                 round_id=task.round_id, chunk_id=chunk_id,
                                 t=now, error=f"{type(exc).__name__}: {exc}")
            self.events.put(WorkerFailed(
                self.worker_id, task.round_id, now,
                f"{type(exc).__name__}: {exc}", t_start=tp.t_start))
            self._drop_everything()
            return
        if self._compute_drop is not None:
            # unloaded while this chunk computed: the backend may have cached
            # the shard again after drop_shard evicted it, so evict it here
            with self._shard_lock:
                dropped = task.shard_id not in self.shards
            if dropped:
                self._compute_drop(self.worker_id, task.shard_id)
        # a B-wide chunk is B× the work: stretch its virtual time to match,
        # or injected slowdowns would under-throttle batched rounds
        target = (r1 - r0) * rhs_width(task.x) * task.row_cost / s
        elapsed = time.perf_counter() - t0
        if target > elapsed:
            time.sleep(target - elapsed)
        t1 = time.perf_counter()
        self.busy_s += t1 - t0
        if self.tracer.enabled:
            # the chunk's execution span, worker-stamped: start = compute
            # begin, dur includes the injector's throttling sleep, and the
            # injected speed rides along so a slow span is attributable
            self.tracer.emit(obs.KIND_CHUNK, worker=self.worker_id,
                             round_id=task.round_id, chunk_id=chunk_id,
                             t=t0, dur=t1 - t0, speed=s,
                             rows=r1 - r0, width=rhs_width(task.x))
        self.events.put(ChunkDone(self.worker_id, task.round_id,
                                  chunk_id, y, t1, t_start=tp.t_start))
        with self._cv:
            tp.done += 1
            tp.remaining -= 1
            finished = tp.remaining == 0
        if finished:
            self.events.put(WorkerDone(self.worker_id, task.round_id,
                                       time.perf_counter(), tp.done,
                                       t_start=tp.t_start))
