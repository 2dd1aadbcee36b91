"""Write-ahead round journal: master restart/recovery without recompute.

The engine appends one JSONL record per durable state transition —
tenant installs, round plans, collected-chunk acks, round retirement,
and (via :class:`~repro_torch.cluster.service.JobService`) job admissions —
to ``<journal_dir>/journal.jsonl``.  After a master crash,
:meth:`repro_torch.cluster.master.CodedExecutionEngine.recover` replays the
file into a :class:`JournalState` snapshot and resumes every still-open
round from its ack floor: journaled chunks are seeded straight into the
round's coverage state (and into the transport's cross-epoch dedup set),
so they are never recomputed and never double-counted.

Record format (one JSON object per line)::

    {"kind": "<kind>", ...payload}

with every numpy payload encoded as ``{"b64": <base64 bytes>,
"shape": [...], "dtype": "<dtype>"}``.  The kinds are registered in
:data:`JOURNAL_KINDS` — the s2c2lint S2C205 extension cross-checks that
every ``append_record`` call site uses a registered kind and that every
registered kind is handled by the replay below, the same way the
``WIRE_PROTOCOL`` registry keeps the frame codec and its handlers in
sync.

Durability is fsync-batched: every append flushes the line to the OS,
and an ``os.fsync`` is issued at most every ``fsync_every`` records
(plus explicitly on :meth:`RoundJournal.sync` / :meth:`close`).  A crash
therefore loses at most the final batch of acks — recovery recomputes
exactly those chunks and nothing else.
"""

from __future__ import annotations

import base64
import dataclasses
import json
import logging
import os
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

__all__ = ["JOURNAL_KINDS", "RoundJournal", "JournalState",
           "encode_array", "decode_array"]

logger = logging.getLogger("repro_torch.cluster.journal")

#: registry of journal record kinds -> payload contract.  Append sites
#: (engine + service) must use a registered kind; the replay in
#: :meth:`RoundJournal.replay` must handle every registered kind —
#: s2c2lint rule S2C205 enforces both directions statically.
JOURNAL_KINDS: Dict[str, str] = {
    "meta": "engine identity: n_workers/k/port/epoch + config scalars",
    "install": "tenant shard install: code params + per-worker digests",
    "plan": "round plan: rid, shard, x, strategy spec, content digests",
    "ack": "collected chunk: rid, chunk, worker, result payload",
    "retire": "round fully decoded: rid",
    "admit": "service job admission: uid + full job payload",
    "job_done": "service job resolved (or resubmitted under a new uid)",
    "checkpoint": "compaction marker: floors surviving pruned history",
}

JOURNAL_NAME = "journal.jsonl"


def encode_array(arr: np.ndarray) -> Dict[str, Any]:
    arr = np.ascontiguousarray(arr)
    return {"b64": base64.b64encode(arr.tobytes()).decode("ascii"),
            "shape": list(arr.shape), "dtype": str(arr.dtype)}


def decode_array(payload: Dict[str, Any]) -> np.ndarray:
    buf = base64.b64decode(payload["b64"])
    return np.frombuffer(buf, dtype=np.dtype(payload["dtype"])).reshape(
        payload["shape"]).copy()


class RoundJournal:
    """Append-only JSONL write-ahead log (one per ``journal_dir``)."""

    def __init__(self, journal_dir: str, fsync_every: int = 8):
        self.journal_dir = journal_dir
        self.path = os.path.join(journal_dir, JOURNAL_NAME)
        self.fsync_every = max(1, fsync_every)
        os.makedirs(journal_dir, exist_ok=True)
        self._fh = open(self.path, "a", encoding="utf-8")
        self._io_lock = threading.Lock()
        self._unsynced = 0              # guarded_by: _io_lock
        self._closed = False            # guarded_by: _io_lock
        self.records_written = 0        # guarded_by: _io_lock
        self.bytes_written = 0          # guarded_by: _io_lock

    # -- write side --------------------------------------------------------
    def append_record(self, kind: str, payload: Dict[str, Any]) -> None:
        """Durably append one record (thread-safe, fsync-batched)."""
        if kind not in JOURNAL_KINDS:
            raise ValueError(f"unregistered journal kind {kind!r} "
                             f"(register it in JOURNAL_KINDS)")
        line = json.dumps({"kind": kind, **payload},
                          separators=(",", ":")) + "\n"
        with self._io_lock:
            if self._closed:
                return                  # post-shutdown stragglers: drop
            self._fh.write(line)
            self._fh.flush()
            self.records_written += 1
            self.bytes_written += len(line)
            self._unsynced += 1
            if self._unsynced >= self.fsync_every:
                os.fsync(self._fh.fileno())
                self._unsynced = 0

    def sync(self) -> None:
        """Force the fsync batch out (crash points, shutdown)."""
        with self._io_lock:
            if self._closed:
                return
            self._fh.flush()
            if self._unsynced:
                os.fsync(self._fh.fileno())
                self._unsynced = 0

    def close(self) -> None:
        with self._io_lock:
            if self._closed:
                return
            self._closed = True
            self._fh.flush()
            try:
                os.fsync(self._fh.fileno())
            except OSError:
                pass
            self._fh.close()

    # -- compaction --------------------------------------------------------
    def compact(self) -> Dict[str, int]:
        """Prune retired rounds' records behind a checkpoint marker.

        Ack payloads dominate the file (each carries a base64 ``(rows,
        B)`` block), and a retired round's acks, plan, and retire marker
        contribute nothing to recovery — :attr:`JournalState.open_rounds`
        filters them right back out.  Likewise a resolved service job's
        admit/job_done pair.  Compaction rewrites the journal without
        them, atomically (tmp + fsync + ``os.replace``), prefixed by a
        ``checkpoint`` record that preserves the one thing pruning would
        otherwise lose: the **round-id floor**.  Without it, a recovered
        master would re-number rounds from below the pruned history and a
        surviving child's stale ``(round, chunk)`` replay could collide
        with a fresh round — the floor makes ``replay`` of the compacted
        log and of the full log resume identically.

        Install records are never pruned: children still hold those
        shards, and rejoin revalidates against the journaled digests.
        """
        with self._io_lock:
            if self._closed:
                return {"pruned_records": 0, "bytes_reclaimed": 0}
            self._fh.flush()
            os.fsync(self._fh.fileno())
            self._unsynced = 0
            with open(self.path, "r", encoding="utf-8") as fh:
                lines = fh.readlines()
            records: List[Tuple[str, Dict[str, Any], str]] = []
            for line in lines:
                stripped = line.strip()
                if not stripped:
                    continue
                try:
                    rec = json.loads(stripped)
                except json.JSONDecodeError:
                    break               # torn tail: unrecoverable anyway
                records.append((rec.get("kind"), rec, stripped))
            retired = {int(r["rid"]) for k, r, _ in records
                       if k == "retire"}
            done = {r["uid"] for k, r, _ in records if k == "job_done"}
            floor = 0
            for k, rec, _ in records:
                if k == "plan":
                    floor = max(floor, int(rec["rid"]))
                elif k == "checkpoint":
                    floor = max(floor, int(rec.get("round_floor", 0)))
            survivors: List[str] = []
            for k, rec, raw in records:
                if k in ("plan", "retire", "ack") and \
                        int(rec["rid"]) in retired:
                    continue
                if k in ("admit", "job_done") and rec["uid"] in done:
                    continue
                if k == "checkpoint":
                    continue            # superseded by the new marker
                survivors.append(raw)
            ckpt = json.dumps(
                {"kind": "checkpoint", "round_floor": floor,
                 "retired_rounds": len(retired), "resolved_jobs": len(done)},
                separators=(",", ":"))
            tmp = self.path + ".compact"
            with open(tmp, "w", encoding="utf-8") as fh:
                fh.write(ckpt + "\n")
                for raw in survivors:
                    fh.write(raw + "\n")
                fh.flush()
                os.fsync(fh.fileno())
            old_bytes = os.path.getsize(self.path)
            self._fh.close()
            os.replace(tmp, self.path)
            self._fh = open(self.path, "a", encoding="utf-8")
            new_bytes = os.path.getsize(self.path)
            pruned = len(records) - len(survivors)
            logger.info("journal compacted: %d record(s) pruned, %d bytes "
                        "reclaimed (floor %d)", pruned,
                        max(old_bytes - new_bytes, 0), floor)
            return {"pruned_records": pruned,
                    "bytes_reclaimed": max(old_bytes - new_bytes, 0)}

    # -- read side ---------------------------------------------------------
    @classmethod
    def replay(cls, journal_dir: str) -> "JournalState":
        """Parse the journal into a recovery snapshot.

        Each registered kind is folded in here — a record kind without a
        branch below would silently drop durable state, which is exactly
        the drift S2C205's journal cross-check exists to catch.
        """
        path = os.path.join(journal_dir, JOURNAL_NAME)
        st = JournalState()
        if not os.path.exists(path):
            return st
        with open(path, "r", encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    # torn final line (crash mid-append): everything before
                    # it is intact, so stop here and recover from that floor
                    logger.warning("journal: torn record ignored: %.80s",
                                   line)
                    break
                kind = rec.get("kind")
                if kind == "meta":
                    st.meta = rec
                elif kind == "install":
                    st.installs[rec["shard_id"]] = rec
                elif kind == "plan":
                    st.plans[int(rec["rid"])] = rec
                elif kind == "ack":
                    st.acks.setdefault(int(rec["rid"]), {}).setdefault(
                        int(rec["chunk"]), []).append(
                            (int(rec["worker"]),
                             decode_array(rec["result"])))
                elif kind == "retire":
                    st.retired.add(int(rec["rid"]))
                elif kind == "admit":
                    st.admits[rec["uid"]] = rec
                elif kind == "job_done":
                    st.jobs_done.add(rec["uid"])
                elif kind == "checkpoint":
                    # compaction marker: pruned history's round-id floor
                    st.checkpoint = rec
                    st.checkpoint_floor = max(
                        st.checkpoint_floor,
                        int(rec.get("round_floor", 0)))
                else:
                    logger.warning("journal: unknown record kind %r "
                                   "skipped", kind)
        return st


@dataclasses.dataclass
class JournalState:
    """Replayed snapshot: what the crashed master durably knew."""

    meta: Optional[Dict[str, Any]] = None
    #: shard_id -> install record (code params + per-worker digests)
    installs: Dict[str, Dict[str, Any]] = dataclasses.field(
        default_factory=dict)
    #: rid -> plan record
    plans: Dict[int, Dict[str, Any]] = dataclasses.field(
        default_factory=dict)
    #: rid -> chunk -> [(worker, result array), ...]
    acks: Dict[int, Dict[int, List[Tuple[int, np.ndarray]]]] = \
        dataclasses.field(default_factory=dict)
    retired: set = dataclasses.field(default_factory=set)
    #: service job admissions (uid -> record) and resolutions
    admits: Dict[str, Dict[str, Any]] = dataclasses.field(
        default_factory=dict)
    jobs_done: set = dataclasses.field(default_factory=set)
    #: last compaction marker (None = never compacted) and the round-id
    #: floor it preserves for the pruned history
    checkpoint: Optional[Dict[str, Any]] = None
    checkpoint_floor: int = 0

    @property
    def open_rounds(self) -> Dict[int, Dict[str, Any]]:
        """Plans journaled but never retired: what recovery must resume."""
        return {rid: rec for rid, rec in self.plans.items()
                if rid not in self.retired}

    @property
    def open_jobs(self) -> Dict[str, Dict[str, Any]]:
        """Admitted service jobs that never resolved."""
        return {uid: rec for uid, rec in self.admits.items()
                if uid not in self.jobs_done}

    @property
    def round_floor(self) -> int:
        # the checkpoint floor covers plans compaction pruned: a resumed
        # master must never re-issue a round id a stale child could still
        # replay chunk results for
        return max(max(self.plans, default=0), self.checkpoint_floor)

    @property
    def tenant_floor(self) -> int:
        floor = 0
        for sid in self.installs:
            if sid.startswith("t"):
                try:
                    floor = max(floor, int(sid[1:]))
                except ValueError:
                    pass
        return floor
