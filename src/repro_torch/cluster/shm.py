"""Shared-memory data plane: ref-counted segment pool + descriptors.

The socket transport's bulk ndarray payloads — shard installs, multi-RHS
``x`` blocks, ``ChunkDone.result`` arrays — do not need to cross the
loopback socket at all on a single host: the paper's premise is that
data stays put and only *work obligations* move (§4).  This module gives
each process a :class:`SegmentPool` over
``multiprocessing.shared_memory``: the sender copies an array once into
a pooled segment and ships a tiny :class:`ShmDescriptor` control frame
``(segment_name, dtype, shape, offset, generation)``; the receiver maps
the segment and hands zero-copy read-only ndarray views to the engine
(decode's ``gather_used`` reads the ``(rows, B)`` blocks straight out of
the mapping into the block-major buffer).

Lifecycle invariants the transport builds on:

* **Release is by round, never by ack.**  The master acks events on
  receipt but reads result payloads at decode time, so a child must not
  recycle a result segment when its event is acked — segments are tagged
  with their ``round_id`` and recycled only when the master's
  ``_ShmRelease(round_id)`` lands (round retired = decode done).  A tag
  that has been retired refuses further ``share``/``attach`` atomically,
  so a straggler result racing the release degrades to the inline path
  (and its event is dropped by round routing anyway) instead of leaking.
* **Installs are unlink-on-ack.**  The child keeps its mapping of an
  installed shard for the tenant's lifetime while the master unlinks the
  name the moment the child's ``_ShmAck`` arrives — POSIX keeps the
  memory alive until the last mapping closes, so exactly one resident
  copy remains.  Install segments are never recycled (a reuse would
  scribble over the child's live shard).
* **Names are sweepable.**  Every segment name is
  ``s2c2shm_<uid><side>_<seq>`` where ``uid`` is the engine lineage
  (journaled in the meta record) and ``side`` is ``m`` (master) or
  ``w<id>`` (child) — so a recovering master can sweep its dead
  predecessor's ``m`` orphans without touching live children's segments,
  a permanent §4.4 verdict sweeps exactly the victim's prefix, and
  engine shutdown sweeps the whole lineage.
* **Attaches are invisible to the resource tracker.**  CPython's
  ``SharedMemory`` registers the name with the ``resource_tracker`` on
  *attach* as well as create — and spawned children share the master's
  tracker process, so a receiver's registration (or a post-attach
  ``unregister``) clobbers the owner's entry and the owner's eventual
  ``unlink`` double-unregisters.  Attaches therefore suppress
  registration entirely (:func:`_untracked_attach`); only the creating
  side is tracked, which is also the only side with the unlink right.
* **Detach tolerates exported views.**  ``mmap.close`` raises
  ``BufferError`` while numpy views are live; such segments park on a
  zombie list and are retried on later pool calls (and once more, after
  a ``gc.collect``, at :meth:`SegmentPool.close`).  Unlinking never
  blocks on views, so reclamation of the *name* is always immediate.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import logging
import os
import threading
from collections import OrderedDict
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np

try:                                    # gate: platforms without POSIX shm
    from multiprocessing import resource_tracker, shared_memory
    SHM_AVAILABLE = True
except ImportError:                     # pragma: no cover - exotic platform
    resource_tracker = None             # type: ignore[assignment]
    shared_memory = None                # type: ignore[assignment]
    SHM_AVAILABLE = False

__all__ = ["ShmDescriptor", "SegmentPool", "SHM_AVAILABLE",
           "DEFAULT_SHM_THRESHOLD", "shm_prefix"]

logger = logging.getLogger("repro_torch.cluster.shm")

#: payloads below this ride inline pickle — a descriptor frame + mmap
#: round-trip costs more than just pickling a few KiB
DEFAULT_SHM_THRESHOLD = 64 * 1024

_NAME_FMT = "s2c2shm_{uid}{side}_{seq}"
_SHM_DIR = "/dev/shm"                   # POSIX tmpfs (Linux); sweeps no-op
#                                         elsewhere


def shm_prefix(uid: str, side: str = "") -> str:
    """Sweepable name prefix for one engine lineage (and optional side)."""
    return f"s2c2shm_{uid}{side}"


#: serializes SharedMemory construction against the register-suppression
#: window below, so a concurrent create's tracker registration is never
#: swallowed by an in-flight attach
_TRACKER_LOCK = threading.Lock()


@contextlib.contextmanager
def _untracked_attach():
    """Attach a segment without registering it with the resource tracker.

    Spawned children inherit the master's tracker *process*: its cache is
    one set of names for the whole pool.  If an attach registered (it
    does, in CPython) or compensated with ``unregister`` (removing the
    owner's entry), the owner's ``unlink`` would double-unregister and
    the tracker would spew ``KeyError`` tracebacks.  Ownership is the
    tracked thing; attaches stay invisible.
    """
    with _TRACKER_LOCK:
        orig = resource_tracker.register
        resource_tracker.register = lambda *a, **k: None
        try:
            yield
        finally:
            resource_tracker.register = orig


@dataclasses.dataclass(frozen=True)
class ShmDescriptor:
    """Wire-sized handle for one array living in a shared segment."""

    name: str
    dtype: str
    shape: Tuple[int, ...]
    offset: int = 0
    generation: int = 0
    nbytes: int = 0


@dataclasses.dataclass
class _Owned:
    """One segment this pool created (we hold the unlink right)."""

    shm: Any                            # shared_memory.SharedMemory
    capacity: int
    generation: int
    tag: Any
    recycle: bool
    nbytes: int


@dataclasses.dataclass
class _Attached:
    """One peer-owned segment this pool mapped (close-only, never unlink)."""

    shm: Any
    tag: Any
    nbytes: int


class SegmentPool:
    """Per-process shared-memory segment pool (one side of the data plane).

    Thread-safe; every method degrades to a ``None`` return (= use the
    inline-pickle fallback) instead of raising, because a data-plane
    hiccup is a perf event, not a correctness event — the socket path
    always works.
    """

    def __init__(self, uid: str, side: str,
                 threshold: int = DEFAULT_SHM_THRESHOLD,
                 enabled: bool = True, registry=None, tracer=None,
                 kind: str = "proc"):
        self.uid = uid
        self.side = side
        self.threshold = max(1, int(threshold))
        self.enabled = bool(enabled) and SHM_AVAILABLE
        self._tracer = tracer
        self._lock = threading.Lock()
        self._seq = 0                                   # guarded_by: _lock
        self._owned: Dict[str, _Owned] = {}             # guarded_by: _lock
        self._free: List[_Owned] = []                   # guarded_by: _lock
        self._attached: Dict[str, _Attached] = {}       # guarded_by: _lock
        self._zombies: List[Any] = []                   # guarded_by: _lock
        # tags whose round retired: share/attach refuse them atomically,
        # closing the straggler-vs-release race without a leak window
        self._retired: "OrderedDict[Any, None]" = OrderedDict()  # guarded_by: _lock
        self._closed = False                            # guarded_by: _lock
        self._metrics = None
        if registry is not None:
            seg = registry.counter(
                "s2c2_shm_segments_total",
                "shared-memory segments created", ("transport",))
            by = registry.counter(
                "s2c2_shm_bytes_total",
                "bytes copied into shared-memory segments", ("transport",))
            fb = registry.counter(
                "s2c2_shm_fallbacks_total",
                "payloads that fell back to inline pickle",
                ("transport", "reason"))
            live = registry.gauge(
                "s2c2_shm_segments_live",
                "shared-memory segments currently owned or mapped")
            mapped = registry.gauge(
                "s2c2_shm_bytes_mapped",
                "bytes in segments currently owned or mapped")
            self._metrics = {
                "segments": seg.labels(transport=kind),
                "bytes": by.labels(transport=kind),
                "fallback": lambda reason, _fb=fb, _k=kind:
                    _fb.labels(transport=_k, reason=reason).inc(),
                "live": live, "mapped": mapped}

    # -- accounting --------------------------------------------------------
    def _update_gauges_locked(self) -> None:
        # *_locked helpers run with _lock held (caller contract)
        m = self._metrics
        if m is None:
            return
        # s2c2lint: ignore[S2C201] _locked-suffix contract: caller holds _lock
        owned = list(self._owned.values()) + self._free
        # s2c2lint: ignore[S2C201] _locked-suffix contract: caller holds _lock
        att = list(self._attached.values())
        m["live"].set(float(len(owned) + len(att)))
        m["mapped"].set(float(sum(s.capacity for s in owned)
                              + sum(a.nbytes for a in att)))

    def _fallback(self, reason: str) -> None:
        m = self._metrics
        if m is not None:
            m["fallback"](reason)

    def stats(self) -> Dict[str, int]:
        """Live accounting snapshot (leak assertions in tests)."""
        with self._lock:
            return {
                "owned": len(self._owned),
                "free": len(self._free),
                "attached": len(self._attached),
                "zombies": len(self._zombies),
                "owned_bytes": sum(s.capacity for s in
                                   list(self._owned.values()) + self._free),
            }

    # -- share (sender side) ----------------------------------------------
    def share(self, arr: np.ndarray, tag: Any,
              recycle: bool = True) -> Optional[ShmDescriptor]:
        """Copy ``arr`` into a pooled segment; returns its descriptor.

        ``None`` means "use the inline path" — pool disabled, payload
        under the threshold, tag already retired, or the OS refused.
        """
        if not self.enabled:
            self._fallback("disabled")
            return None
        arr = np.ascontiguousarray(arr)
        if arr.nbytes < self.threshold:
            self._fallback("small")
            return None
        with self._lock:
            if self._closed or tag in self._retired:
                self._fallback("retired")
                return None
            seg = self._take_free_locked(arr.nbytes) if recycle else None
            if seg is None:
                self._seq += 1
                name = _NAME_FMT.format(uid=self.uid, side=self.side,
                                        seq=self._seq)
                try:
                    with _TRACKER_LOCK:
                        shm = shared_memory.SharedMemory(
                            name=name, create=True, size=arr.nbytes)
                except (OSError, ValueError):
                    self._fallback("error")
                    return None
                seg = _Owned(shm=shm, capacity=shm.size, generation=0,
                             tag=tag, recycle=recycle, nbytes=arr.nbytes)
                m = self._metrics
                if m is not None:
                    m["segments"].inc()
            else:
                seg.generation += 1
                seg.tag = tag
                seg.recycle = recycle
                seg.nbytes = arr.nbytes
            self._owned[seg.shm.name] = seg
            m = self._metrics
            if m is not None:
                m["bytes"].inc(arr.nbytes)
            self._update_gauges_locked()
        dst = np.frombuffer(seg.shm.buf, dtype=arr.dtype,
                            count=arr.size).reshape(arr.shape)
        np.copyto(dst, arr)
        del dst                         # transient view: owner buffers must
        #                                 stay export-free for clean closes
        if self._tracer is not None and self._tracer.enabled:
            from repro_torch.cluster import obs
            self._tracer.emit(obs.KIND_SHM, action="share",
                              name=seg.shm.name, nbytes=arr.nbytes,
                              generation=seg.generation)
        return ShmDescriptor(name=seg.shm.name, dtype=str(arr.dtype),
                             shape=tuple(arr.shape), offset=0,
                             generation=seg.generation, nbytes=arr.nbytes)

    def _take_free_locked(self, nbytes: int) -> Optional[_Owned]:
        best = None
        # s2c2lint: ignore[S2C201] _locked-suffix contract: caller holds _lock
        for seg in self._free:
            if seg.capacity >= nbytes and \
                    (best is None or seg.capacity < best.capacity):
                best = seg
        if best is not None:
            # s2c2lint: ignore[S2C201] _locked-suffix contract: caller holds _lock
            self._free.remove(best)
        return best

    # -- attach (receiver side) -------------------------------------------
    def attach(self, desc: ShmDescriptor,
               tag: Any) -> Optional[np.ndarray]:
        """Map ``desc``'s segment; returns a read-only zero-copy view.

        ``None`` means the segment is gone (owner retired/swept it) or the
        tag's round already retired — the caller drops the payload, which
        is safe exactly because release only ever follows retirement.
        """
        if not SHM_AVAILABLE:
            return None
        with self._lock:
            if self._closed or tag in self._retired:
                return None
            att = self._attached.get(desc.name)
            own = self._owned.get(desc.name)
        if own is not None:
            shm = own.shm               # loopback self-attach (tests)
        elif att is not None:
            shm = att.shm
        else:
            try:
                with _untracked_attach():
                    shm = shared_memory.SharedMemory(name=desc.name)
            except (FileNotFoundError, OSError, ValueError):
                self._fallback("attach_miss")
                return None
            with self._lock:
                if self._closed or tag in self._retired:
                    # lost the race with retire/close: unmap immediately
                    try:
                        shm.close()
                    except (BufferError, OSError):
                        self._zombies.append(shm)
                    return None
                self._attached[desc.name] = _Attached(
                    shm=shm, tag=tag, nbytes=desc.nbytes)
                self._update_gauges_locked()
            if self._tracer is not None and self._tracer.enabled:
                from repro_torch.cluster import obs
                self._tracer.emit(obs.KIND_SHM, action="attach",
                                  name=desc.name, nbytes=desc.nbytes,
                                  generation=desc.generation)
        count = 1
        for d in desc.shape:
            count *= int(d)
        try:
            view = np.frombuffer(shm.buf, dtype=np.dtype(desc.dtype),
                                 count=count,
                                 offset=desc.offset).reshape(desc.shape)
        except (TypeError, ValueError):
            self._fallback("attach_miss")
            return None
        view.setflags(write=False)
        return view

    # -- release / detach --------------------------------------------------
    def _dispose_owned_locked(self, seg: _Owned) -> None:
        try:
            seg.shm.close()
        except (BufferError, OSError):
            # s2c2lint: ignore[S2C201] _locked-suffix contract: caller holds _lock
            self._zombies.append(seg.shm)
        try:
            seg.shm.unlink()
        except (FileNotFoundError, OSError):
            pass                        # swept / peer-cleaned already

    def _detach_locked(self, att: _Attached) -> None:
        try:
            att.shm.close()
        except (BufferError, OSError):
            # live exported views (decode still reading): park and retry —
            # the mapping stays valid for exactly as long as the views do
            # s2c2lint: ignore[S2C201] _locked-suffix contract: caller holds _lock
            self._zombies.append(att.shm)

    def _reap_zombies_locked(self) -> None:
        still: List[Any] = []
        # s2c2lint: ignore[S2C201] _locked-suffix contract: caller holds _lock
        for shm in self._zombies:
            try:
                shm.close()
            except (BufferError, OSError):
                still.append(shm)
        # s2c2lint: ignore[S2C201] _locked-suffix contract: caller holds _lock
        self._zombies = still

    def retire_tag(self, tag: Any) -> None:
        """Round retired: recycle owned segments, unmap attachments, and
        refuse the tag from here on (share/attach return ``None``)."""
        with self._lock:
            if self._closed:
                return
            self._retired[tag] = None
            while len(self._retired) > 8192:
                self._retired.popitem(last=False)
            for name in [n for n, s in self._owned.items() if s.tag == tag]:
                seg = self._owned.pop(name)
                if seg.recycle:
                    self._free.append(seg)
                else:
                    self._dispose_owned_locked(seg)
            for name in [n for n, a in self._attached.items()
                         if a.tag == tag]:
                self._detach_locked(self._attached.pop(name))
            self._reap_zombies_locked()
            self._update_gauges_locked()

    def release_names(self, names: Iterable[str]) -> None:
        """Release specific owned segments (install unlink-on-ack path)."""
        with self._lock:
            if self._closed:
                return
            for name in names:
                seg = self._owned.pop(name, None)
                if seg is None:
                    continue
                if seg.recycle:
                    self._free.append(seg)
                else:
                    self._dispose_owned_locked(seg)
            self._update_gauges_locked()

    def release_prefix(self, tag_prefix: Tuple) -> None:
        """Release owned segments whose tuple tag starts with the prefix
        (e.g. every pending install for one permanently fenced worker)."""
        k = len(tag_prefix)
        with self._lock:
            if self._closed:
                return
            for name in [n for n, s in self._owned.items()
                         if isinstance(s.tag, tuple)
                         and s.tag[:k] == tag_prefix]:
                self._dispose_owned_locked(self._owned.pop(name))
            self._update_gauges_locked()

    def detach_tag(self, tag: Any) -> None:
        """Unmap attachments for one tag without retiring it (drop_shard)."""
        with self._lock:
            if self._closed:
                return
            for name in [n for n, a in self._attached.items()
                         if a.tag == tag]:
                self._detach_locked(self._attached.pop(name))
            self._reap_zombies_locked()
            self._update_gauges_locked()

    # -- teardown ----------------------------------------------------------
    def close(self, unlink: bool = True) -> Dict[str, int]:
        """Tear the pool down (idempotent).  ``unlink=False`` is the
        master-crash path: close our mappings but leave names in place —
        a real dead master cannot unlink, and ``recover()`` sweeps them."""
        with self._lock:
            if self._closed:
                return {"leaked": len(self._zombies)}
            self._closed = True
            owned = list(self._owned.values()) + self._free
            self._owned.clear()
            self._free.clear()
            attached = list(self._attached.values())
            self._attached.clear()
            for seg in owned:
                try:
                    seg.shm.close()
                except (BufferError, OSError):
                    self._zombies.append(seg.shm)
                if unlink:
                    try:
                        seg.shm.unlink()
                    except (FileNotFoundError, OSError):
                        pass
            for att in attached:
                self._detach_locked(att)
            self._reap_zombies_locked()
            if self._zombies:
                gc.collect()            # dropped-but-uncollected views
                self._reap_zombies_locked()
            leaked = len(self._zombies)
            self._update_gauges_locked()
        if leaked:
            logger.debug("shm pool %s%s: %d mapping(s) still exported at "
                         "close (names reclaimed; memory frees with the "
                         "last view)", self.uid, self.side, leaked)
        return {"leaked": leaked}

    # -- sweeps ------------------------------------------------------------
    @staticmethod
    def scan(prefix: str) -> List[str]:
        """Names under ``/dev/shm`` matching ``prefix`` (leak checks)."""
        if not os.path.isdir(_SHM_DIR):
            return []
        try:
            return sorted(n for n in os.listdir(_SHM_DIR)
                          if n.startswith(prefix))
        except OSError:                 # pragma: no cover - racing teardown
            return []

    @staticmethod
    def sweep(prefix: str) -> int:
        """Unlink every ``/dev/shm`` entry matching ``prefix``.

        Used for orphan reclamation: master recovery (the dead master's
        ``m`` segments), permanent §4.4 verdicts (the victim's ``w<id>``
        segments), and engine shutdown (the whole lineage).  Unlinking
        never invalidates live mappings — readers mid-decode keep their
        views; only the *name* is reclaimed.
        """
        swept = 0
        for name in SegmentPool.scan(prefix):
            try:
                os.unlink(os.path.join(_SHM_DIR, name))
                swept += 1
            except OSError:
                pass
        if swept:
            logger.info("shm sweep: reclaimed %d orphan segment(s) "
                        "under %s*", swept, prefix)
        return swept
