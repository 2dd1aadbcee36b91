#!/usr/bin/env python3
"""Seeded chaos demo on the PyTorch/CUDA port: three fault scenarios, on the card.

The port's counterpart of ``scripts/chaos_demo.py``, with the same CLI and
the same three scenarios, each of which runs a real process pool under
seeded chaos and checks its acceptance property end to end (a violated
property raises, so the script exits non-zero):

* ``kill`` — drop/delay/dup chaos plus one mid-round SIGKILL of worker 5
  (injected 5x slow, stealing off, ``timeout_slack=3.0``): every job
  completes, a fail-stop verdict comes before the first failover, and the
  killed worker is fenced;
* ``partition`` — a 2 s events-only partition of worker 1 at k == n: a
  §4.4 transport verdict, at least one rejoin, and at least one chunk
  computed during the partition credited at heal, never recomputed;
* ``recover`` — ``crash()`` of the master mid-round, then
  ``CodedExecutionEngine.recover`` from the write-ahead journal: exactly
  one recovered round, no journaled (worker, chunk) ack re-enqueued, and
  the interrupted worker's chunks resumed.

Every engine is built as the port builds it for ``--device``: the worker
processes compute through ``kernel_backend(device)`` (the ``coded_matvec``
kernel on float32 shards resident on the card; the spec travels to each
child as ``kernel:cuda:<index>``), the master decodes through
``mds_decode`` (``decode_with_kernel=True``) and plans with the LSTM
predictor on the card (the sequence kernel).  There is no fallback: with
``--device cuda`` and no card it raises, and a child whose kernel fails to
build or launch fails the scenario (its ``WorkerFailed`` is no verdict).

The tenant is real-sized: in ``kill`` each worker holds 60,000 rows (D/k
of ``benchmarks/fig_overheads.py``'s D = 600,000) of d = 2,048 columns,
drawn float32-representable, so D = k x rows; ``partition`` and
``recover``, whose properties do not depend on the size, hold 20,000 rows
a worker (``--rows`` sets every scenario's).  ``row_cost`` is
scaled so that a chunk's stretch (rows a chunk x ``row_cost``) equals the
reference's (kill 0.05 s, partition 0.128 s, recover 0.04 s), which keeps
its heartbeat and timeout constants.  With ``--device cpu`` and no
``--rows`` the scenarios run at the reference's own shapes.  Beyond the
reference's properties each scenario holds every ``y`` within 1e-4
(relative) of a float64 product, the master's kernel launches (one
``mds_decode`` a decoded round, one sequence launch a prediction with
history, the per-step cell never), no ``s2c2shm_*`` segment of the
scenario's pool left in ``/dev/shm`` and, on the card, its memory: the killed worker's shard
released, and the card's memory in use back within 1 GB of its level
before the scenario.  In the parent one chunk of a survivor's shard and
one round's decode are held to their plain versions on the same tensors.

    python3 scripts/torch_chaos_demo.py --scenario kill --seed 0 \\
        --trace-out chaos_trace.json            # on the card
    python3 scripts/torch_chaos_demo.py --scenario partition --device cpu
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import gc
import logging
import os
import shutil
import statistics
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

_SRC = str(Path(__file__).resolve().parents[1] / "src")
if _SRC not in sys.path:
    sys.path.insert(0, _SRC)

from repro_torch._device import resolve_device  # noqa: E402
from repro_torch.cluster import (ChaosConfig, ClusterConfig,  # noqa: E402
                                 CodedExecutionEngine, EngineClosed,
                                 FaultyTransport, JobService, MatvecJob,
                                 NoSlowdown, SocketTransport, TraceInjector,
                                 Tracer, kernel_backend)
from repro_torch.cluster.obs import (KIND_CHAOS, KIND_CHUNK,  # noqa: E402
                                     KIND_ENQUEUE, KIND_FAILOVER,
                                     KIND_FAILSTOP_VERDICT, KIND_REJOIN,
                                     KIND_ROUND_DECODE)
from repro_torch.cluster.shm import shm_prefix  # noqa: E402
from repro_torch.cluster.transport import _compute_spec  # noqa: E402
from repro_torch.convert import load_params  # noqa: E402
from repro_torch.core.predictor import SpeedPredictor  # noqa: E402
from repro_torch.core.strategies import GeneralS2C2  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import coded_matvec as cmv  # noqa: E402
from repro_torch.kernels import mds_decode as dec  # noqa: E402
from repro_torch.kernels.coded_matvec import MAX_NVEC  # noqa: E402

COLS = 2_048           # d of the main path
Y_RTOL = 1e-4          # every y against a float64 product, relative
F32_TOL = 2e-4         # a float32 kernel against its plain version (rtol = atol)
MEM_SLACK = 1e9        # the card's memory in use after a scenario, over before
SHM_DIR = "/dev/shm"


@dataclasses.dataclass(frozen=True)
class Shape:
    """A scenario's code and chunking, the rows of each worker's coded
    partition at d = COLS, the reference's tenant and the stretch of one
    chunk at speed 1.0 (the reference's rows a chunk x row_cost)."""

    n: int
    k: int
    chunks: int
    rows: int
    ref_rows: int
    ref_cols: int
    stretch: float
    seed: int


# kill at the main path's partition, 600,000 / 10 rows; partition and
# recover at a third of it, which keeps the whole of chip_smoke.py inside
# its time limit
SHAPES = {"kill": Shape(6, 4, 12, 60_000, 480, 80, 0.05, 1000),
          "partition": Shape(3, 3, 2, 20_000, 96, 32, 0.128, 2000),
          "recover": Shape(3, 3, 2, 20_000, 48, 24, 0.04, 3000)}


class Counted(SpeedPredictor):
    """The LSTM predictor, counting the predictions it makes from history
    (each one sequence-kernel launch on the card)."""

    def __init__(self, n: int, dev: torch.device):
        super().__init__(n, load_params(device=dev), device=dev)
        self.with_history = 0

    def predict(self) -> np.ndarray:
        self.with_history += bool(self.history)
        return super().predict()


MASTER_LOG = logging.getLogger("repro_torch.cluster.master")


class ComputeErrors(logging.Handler):
    """The master's reports of a worker whose compute raised: its
    ``WorkerFailed`` events other than the transport's verdicts (an engine
    keeps only each worker's latest reason, and a verdict follows)."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.errors: list = []

    def emit(self, record: logging.LogRecord) -> None:
        if (record.msg == "worker %d failed (round %d): %s"
                and not str(record.args[2]).startswith("transport:")):
            self.errors.append(record.getMessage())


def require(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def shm_segments(prefix: str = "s2c2shm_") -> list:
    """Segments under /dev/shm whose name starts with ``prefix`` (read from
    the directory, as the reference's CI reads it)."""
    try:
        return sorted(f for f in os.listdir(SHM_DIR) if f.startswith(prefix))
    except FileNotFoundError:
        return []


class CardMemory:
    """The card's memory in use by every process (``cudaMemGetInfo``),
    sampled every 5 ms on a thread between :meth:`start` and :meth:`stop`;
    inert on the CPU (every reading None)."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        self.on = dev.type == "cuda"
        self.samples: list = []            # (perf_counter, bytes in use)
        self._done = threading.Event()
        self._thread = None

    def used(self):
        if not self.on:
            return None
        free, total = torch.cuda.mem_get_info(self.dev)
        return total - free

    def start(self) -> None:
        if not self.on:
            return

        def sample():
            while not self._done.wait(0.005):
                self.samples.append((time.perf_counter(), self.used()))

        self._thread = threading.Thread(target=sample, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._done.set()
        if self._thread is not None:
            self._thread.join()

    def at(self, t: float):
        """The last reading at or before ``t``."""
        before = [u for s, u in self.samples if s <= t]
        return before[-1] if before else None

    def least_after(self, t: float):
        after = [u for s, u in self.samples if s > t]
        return min(after) if after else None

    def steady(self, timeout: float = 5.0):
        """The memory in use once two readings 0.2 s apart agree within
        1 MB (an upload in flight has landed)."""
        if not self.on:
            return None
        deadline = time.monotonic() + timeout
        last = self.used()
        while time.monotonic() < deadline:
            time.sleep(0.2)
            now = self.used()
            if abs(now - last) < 1e6:
                return now
            last = now
        return last

    def settle(self, limit: float, timeout: float = 15.0):
        """Wait until the card's memory in use is at most ``limit`` bytes
        (a dead process's memory is freed by the driver as it exits);
        return the last reading."""
        if not self.on:
            return None
        torch.cuda.empty_cache()
        deadline = time.monotonic() + timeout
        used = self.used()
        while used > limit and time.monotonic() < deadline:
            time.sleep(0.05)
            used = self.used()
        return used


def gb(b) -> str:
    return "not measured (CPU)" if b is None else f"{b / 1e9:.3f} GB"


class Run:
    """What every scenario shares: the device, the tenant, the backend spec,
    the counted predictors, the launch counters, memory and ``/dev/shm``."""

    def __init__(self, name: str, seed: int, device, rows):
        self.name = name
        self.dev = resolve_device(device)          # raises with no card
        self.shape = s = SHAPES[name]
        self.t0 = time.perf_counter()
        if self.dev.type == "cuda":
            # the children load the library this process builds: none of
            # them compiles while its first chunk's stretch runs
            _build.library()
        if rows is None and self.dev.type == "cpu":
            d_rows, self.cols = s.ref_rows, s.ref_cols
        else:
            d_rows, self.cols = s.k * (s.rows if rows is None else rows), COLS
        self.rng = np.random.default_rng(seed + s.seed)
        self.a = self.rng.standard_normal((d_rows, self.cols),
                                          dtype=np.float32).astype(np.float64)
        self.rpc = -(-d_rows // (s.k * s.chunks))
        self.row_cost = s.stretch / self.rpc
        self.shard_bytes = self.rpc * s.chunks * self.cols * 4   # float32 on the card
        self.predictors: list = []
        self.worst = 0.0
        self.mem = CardMemory(self.dev)
        self.phases: dict = {}
        if self.mem.on:
            torch.cuda.empty_cache()
        self.used_before = self.mem.used()
        ops.reset_launch_counts()
        for h in [h for h in MASTER_LOG.handlers if isinstance(h, ComputeErrors)]:
            MASTER_LOG.removeHandler(h)         # a failed scenario's
        self.failures = ComputeErrors()
        MASTER_LOG.addHandler(self.failures)
        self.say(f"tenant {d_rows} x {self.cols} float32-representable, ({s.n}, {s.k}) "
                 f"code, C = {s.chunks}, {self.rpc} rows a chunk, row_cost "
                 f"{self.row_cost:.4e} s (a chunk's stretch {s.stretch} s at speed 1.0); "
                 f"device {self.dev}; the card's memory in use {gb(self.used_before)}")

    def say(self, line: str) -> None:
        print(f"chaos {self.name}: {line}", flush=True)

    def mark(self, phase: str, t: float) -> None:
        self.phases[phase] = time.perf_counter() - t

    def backend(self):
        """A fresh ``kernel_backend`` for one engine, checked to travel to
        the children as ``kernel:<device>`` (``kernel:cuda:<index>`` on the
        card)."""
        backend = kernel_backend(self.dev)
        spec = _compute_spec(backend)
        want = (f"kernel:cuda:{backend.device.index}" if self.dev.type == "cuda"
                else "kernel:cpu")
        require(spec == want, f"the children's compute travels as {spec!r}, not {want!r}")
        self.spec = spec
        return backend

    def predictor(self) -> Counted:
        p = Counted(self.shape.n, self.dev)
        self.predictors.append(p)
        return p

    def engine(self, cfg: ClusterConfig, injector, transport, tracer=None):
        return CodedExecutionEngine(cfg, injector, compute=self.backend(),
                                    predictor=self.predictor(), tracer=tracer,
                                    transport=transport, device=self.dev)

    def config(self, **kw) -> ClusterConfig:
        s = self.shape
        return ClusterConfig(n_workers=s.n, k=s.k, row_cost=self.row_cost,
                             decode_with_kernel=True, **kw)

    def check_y(self, ys: list, xs: list) -> None:
        """Every y within Y_RTOL (relative) of its float64 product (one pass
        over A for all of them)."""
        wants = self.a @ np.stack(xs, axis=1)
        for i, y in enumerate(ys):
            want = wants[:, i]
            require(y.shape == want.shape and bool(np.isfinite(y).all()),
                    f"y has shape {y.shape} or non-finite values")
            err = float(np.abs(y - want).max() / np.abs(want).max())
            require(err <= Y_RTOL, f"y's relative error {err:.3e} > {Y_RTOL}")
            self.worst = max(self.worst, err)

    def launches(self, decoded: int) -> dict:
        """The master's launches since the scenario began, read with every
        worker stopped: one ``mds_decode`` a decoded round, one sequence
        launch a prediction from history, the per-step cell never (on the
        CPU the plain versions launch nothing)."""
        counts, designs = ops.launch_counts(), ops.design_counts()
        history = sum(p.with_history for p in self.predictors)
        if self.dev.type == "cuda":
            require(counts["mds_decode"] == decoded,
                    f"mds_decode launched {counts['mds_decode']} times for {decoded} "
                    "decoded rounds")
            require(designs["lstm_cell"] == {"sequence": history, "cell": 0},
                    f"the predictor's launches {designs['lstm_cell']}, not one sequence "
                    f"launch for each of {history} predictions from history")
            require(counts["mds_encode"] == 0 and counts["coded_matvec"] == 0,
                    f"the master launched {counts}: it encodes on the host and the "
                    "workers compute")
        return {"mds_decode": counts["mds_decode"], "lstm_cell": counts["lstm_cell"],
                "decoded_rounds": decoded, "predictions_with_history": history}

    def no_compute_errors(self) -> None:
        """A child whose kernel failed to build or launch reports it
        (``WorkerFailed``) and is failed over; here that fails the scenario.
        The transport's verdicts are the only failures allowed."""
        MASTER_LOG.removeHandler(self.failures)
        require(not self.failures.errors, f"workers failed: {self.failures.errors}")

    def children(self, recs) -> dict:
        """The chunk spans each child forwarded into the merged trace, and
        their RHS widths.  They are the children's own records, not their
        launch counters, which stay in their processes: a SIGKILLed child's
        unsent tail is missing, and in ``recover`` so are the chunks
        computed before the crash (the reference traces the recovered
        master alone)."""
        per, widths = collections.Counter(), collections.Counter()
        for r in recs:
            if r.kind == KIND_CHUNK and r.worker >= 0:
                per[r.worker] += 1
                widths[int(dict(r.args).get("width", 1))] += 1
        require(max(widths, default=1) <= MAX_NVEC, f"a chunk wider than {MAX_NVEC} columns")
        out = {"chunk_spans_by_worker": dict(sorted(per.items())),
               "chunk_spans_by_width": dict(sorted(widths.items()))}
        self.say(f"chunk spans each child forwarded (merged trace) "
                 f"{out['chunk_spans_by_worker']}, by RHS width "
                 f"{out['chunk_spans_by_width']}")
        return out

    def hold(self, data, survivor: int, x: np.ndarray) -> dict:
        """One chunk of a survivor's shard and one round's decode, each held
        to its plain version on the same tensors (on the card: kernel against
        plain); and ``compute_chunk``'s time at the chunk's shape beside the
        stretch."""
        dev, s, rpc = self.dev, self.shape, self.rpc
        shard = torch.as_tensor(data.partitions[survivor], dtype=torch.float32, device=dev)
        view = shard[rpc:2 * rpc]
        zero = torch.zeros(1, dtype=torch.int32, device=dev)
        x_d = torch.as_tensor(x, dtype=torch.float32, device=dev)
        chunk_err = _allclose("coded_matvec (a survivor's chunk)",
                              ops.coded_matvec(view, x_d, zero, rpc),
                              cmv.coded_matvec_plain(view, x_d, zero, rpc))
        # one round's decode: every chunk from k live workers' float64 partials
        live = [w for w in range(s.n) if w != survivor][:s.k - 1] + [survivor]
        ids = np.tile(np.sort(live), (s.chunks, 1))
        parts = np.stack([[data.partitions[w][c * rpc:(c + 1) * rpc] @ x for w in row]
                          for c, row in enumerate(ids)])
        w_d = torch.as_tensor(data.code.decode_submats(ids), dtype=torch.float32, device=dev)
        p_d = torch.as_tensor(parts.reshape(s.chunks * s.k, rpc), dtype=torch.float32,
                              device=dev)
        table = torch.arange(s.chunks * s.k, dtype=torch.int32, device=dev).view(s.chunks, s.k)
        buf = torch.empty((s.k, s.chunks, rpc), device=dev)
        decode_err = _allclose(
            "mds_decode (one round)",
            ops.mds_decode_into(w_d, p_d, table, buf.transpose(0, 1)),
            dec.mds_decode_into_plain(w_d, p_d, table, torch.empty_like(buf).transpose(0, 1)))
        backend = kernel_backend(dev)
        t = time.perf_counter()
        backend.compute_chunk(survivor, data.shard_id, data.partitions[survivor], rpc,
                              2 * rpc, x)
        first_ms = (time.perf_counter() - t) * 1e3
        times = []
        for _ in range(20):
            t = time.perf_counter()
            backend.compute_chunk(survivor, data.shard_id, data.partitions[survivor], rpc,
                                  2 * rpc, x)
            times.append((time.perf_counter() - t) * 1e3)
        call_ms = statistics.median(times)
        stretch_ms = rpc * self.row_cost * 1e3
        self.say(f"held in the parent on {dev}: a chunk ({rpc}, {self.cols}) of worker "
                 f"{survivor}'s shard, coded_matvec against its plain version, max abs err "
                 f"{chunk_err:.3e}; one round's mds_decode ({s.chunks}, {s.k}, {s.k}) x {rpc}, "
                 f"max abs err {decode_err:.3e} (tol {F32_TOL}); compute_chunk call ms "
                 f"{call_ms:.4f} (the first, with the shard's upload, {first_ms:.1f}) against "
                 f"a chunk's stretch of {stretch_ms:.1f} ms at speed 1.0")
        del backend, shard, view, w_d, p_d, buf
        return {"chunk_err": chunk_err, "decode_err": decode_err,
                "compute_chunk_call_ms": call_ms, "first_call_ms": first_ms,
                "stretch_ms": stretch_ms}

    def finish(self, uids, out: dict) -> dict:
        """After shutdown: no segment of the scenario's pool (its lineage,
        ``s2c2shm_<uid>``) left in /dev/shm, and the card's memory in use
        back within MEM_SLACK."""
        left = [f for uid in uids for f in shm_segments(shm_prefix(uid))]
        require(not left, f"segments left in {SHM_DIR}: {left}")
        after = self.mem.settle(None if self.used_before is None
                                else self.used_before + MEM_SLACK)
        if self.mem.on:
            require(after <= self.used_before + MEM_SLACK,
                    f"the card's memory in use {gb(after)} after the scenario, over "
                    f"{gb(self.used_before)} before it by more than {gb(MEM_SLACK)}")
        out.update(used_before=self.used_before, used_after=after,
                   shm_left=len(left), worst_rel_err=self.worst,
                   spec=self.spec, wall_s=time.perf_counter() - self.t0, phases=self.phases)
        self.say(f"after shutdown: {out['shm_left']} segments of the pool's lineage in "
                 f"{SHM_DIR}; the "
                 f"card's memory in use {gb(after)} (before the scenario "
                 f"{gb(self.used_before)})")
        return out

    def verdicts(self, recs, t_ref: float) -> dict:
        """The verdicts, failovers and chaos injections of the trace, their
        times from ``t_ref`` (the engine's start)."""
        verdicts = sorted((r.t - t_ref, r.worker, dict(r.args).get("source"),
                           dict(r.args).get("suspected"))
                          for r in recs if r.kind == KIND_FAILSTOP_VERDICT)
        failovers = sorted(r.t - t_ref for r in recs if r.kind == KIND_FAILOVER)
        chaos = collections.Counter(dict(r.args).get("action") for r in recs
                                    if r.kind == KIND_CHAOS)
        injected = {dict(r.args).get("action"): r.t - t_ref for r in reversed(recs)
                    if r.kind == KIND_CHAOS and dict(r.args).get("action") != "partition_drop"}
        self.say("verdicts (s from the engine's start, worker, source, suspected) "
                 + (", ".join(f"({t:.3f}, {w}, {src}, {sus})" for t, w, src, sus in verdicts)
                    or "none")
                 + f"; first failover at "
                 + (f"{failovers[0]:.3f} s" if failovers else "none")
                 + f" ({len(failovers)} failovers); chaos injections {dict(chaos)}, the "
                 "first of each at (s) " + ", ".join(f"{a} {t:.3f}" for a, t in injected.items()))
        return {"verdicts": verdicts, "failovers": len(failovers),
                "first_failover_s": failovers[0] if failovers else None,
                "chaos": dict(chaos), "first_injection_s": injected}


def _allclose(label: str, got: torch.Tensor, want: torch.Tensor) -> float:
    g, w = got.float(), want.float()
    require(g.shape == w.shape and bool(torch.isfinite(g).all()),
            f"{label}: shape {tuple(g.shape)} vs {tuple(w.shape)} or non-finite values")
    err = float((g - w).abs().max())
    require(bool(torch.allclose(g, w, rtol=F32_TOL, atol=F32_TOL)),
            f"{label}: kernel and plain version disagree, max abs err {err:.3e} > {F32_TOL}")
    return err


def _dump(run: Run, tr: Tracer, trace_out: str) -> int:
    n_ev = tr.dump(trace_out)
    run.say(f"wrote {trace_out} ({n_ev} Perfetto events)")
    return n_ev


def scenario_kill(seed: int, trace_out: str, jobs: int, device="cuda",
                  rows=None) -> dict:
    run = Run("kill", seed, device, rows)
    s = run.shape
    n, k, chunks = s.n, s.k, s.chunks
    a, rng = run.a, run.rng
    xs = [rng.standard_normal(run.cols) for _ in range(jobs)]

    tr = Tracer(enabled=True)
    speeds = np.ones((1, n))
    speeds[0, n - 1] = 0.2          # doomed worker: slow, so its kill
    #                                 trigger fires after survivors idle
    chaos = ChaosConfig(seed=seed, p_drop=0.02, p_delay=0.05,
                        p_dup=0.02, kill_worker=n - 1, kill_after_chunks=2)
    t = time.perf_counter()
    eng = run.engine(
        run.config(starvation_timeout=30.0, enable_stealing=False),
        TraceInjector(speeds), tracer=tr,
        transport=FaultyTransport(chaos, hb_interval=0.05, hb_miss=6,
                                  dead_after=2, connect_timeout=60.0))
    run.mark("spawn", t)
    t_eng = t
    uid = eng.transport.shm_uid
    svc = JobService(eng, max_inflight=2)
    out = {}
    try:
        t = time.perf_counter()
        shared = svc.share_matrix(a, chunks=chunks)
        run.mark("encode_install", t)
        strat = GeneralS2C2(n, k, a.shape[0], chunks=chunks, timeout_slack=3.0)
        run.mem.start()
        t = time.perf_counter()
        handles = [svc.submit(MatvecJob(a, [x], strat, data=shared)) for x in xs]
        for i, h in enumerate(handles):
            require(h.wait(timeout=120.0), f"job {i} hung under chaos")
        run.mark("jobs", t)
        errors = [h.metrics.error for h in handles]
        require(errors == [None] * len(handles), f"job errors: {errors}")
        run.check_y([h.output[0] for h in handles], xs)
        run.say(f"all {len(handles)} jobs completed within {Y_RTOL} of float64 (worst "
                f"{run.worst:.3e}; seed={seed}, worker {n - 1} SIGKILLed mid-round)")
        # the victim's verdict: a fail-stop of its dead process (a SUSPECTED
        # verdict before the kill would have kept this one from being issued)
        def fenced():
            return [r.t for r in tr.snapshot() if r.kind == KIND_FAILSTOP_VERDICT
                    and r.worker == n - 1 and dict(r.args).get("source") == "proc-exit"]

        deadline = time.monotonic() + 10.0
        while not fenced() and time.monotonic() < deadline:
            time.sleep(0.05)
        kills = [r.t for r in tr.snapshot() if r.kind == KIND_CHAOS
                 and dict(r.args).get("action") == "kill"]
        require(bool(kills) and bool(fenced()), "no kill, or no fail-stop verdict on the "
                "victim's dead process")
        verdict_t = fenced()[0]
        # the victim's memory: read at the kill, then after the verdict
        at_kill = run.mem.at(kills[0])
        if run.mem.on:
            run.mem.settle(at_kill - run.shard_bytes)
        run.mem.stop()
        after = run.mem.least_after(verdict_t)
        if run.mem.on:
            require(after is not None and at_kill - after >= run.shard_bytes,
                    f"the card regained {gb(None if after is None else at_kill - after)} "
                    f"after the verdict, under the victim's {gb(run.shard_bytes)} shard")
        out.update(mem_at_kill=at_kill, mem_after_verdict=after,
                   mem_regained=None if after is None else at_kill - after)
        run.say(f"the card's memory in use: before the scenario {gb(run.used_before)}, at "
                f"the kill {gb(at_kill)}, after the verdict {gb(after)} (regained "
                f"{gb(out['mem_regained'])}; the victim's shard {gb(run.shard_bytes)})")
    finally:
        run.mem.stop()
        t = time.perf_counter()
        svc.close()
        eng.shutdown()      # drains the worker-side trace tail
        run.mark("shutdown", t)

    recs = tr.snapshot()
    out.update(run.verdicts(recs, t_eng))
    verdicts = sorted(r.t for r in recs if r.kind == KIND_FAILSTOP_VERDICT)
    failovers = sorted(r.t for r in recs if r.kind == KIND_FAILOVER)
    require(bool(verdicts), "no fail-stop verdict in trace — kill not detected")
    require(bool(failovers), "no failover dispatch in trace")
    require(min(verdicts) <= min(failovers),
            "failover must follow the verdict, not precede it")
    require(n - 1 in eng.dead, "killed worker not fenced engine-wide")
    run.no_compute_errors()
    decoded = sum(1 for r in recs if r.kind == KIND_ROUND_DECODE)
    out.update(jobs=len(handles), rounds=decoded, launches=run.launches(decoded),
               children=run.children(recs))
    run.say(f"{len(handles)} jobs in {decoded} decoded rounds; master launches "
            f"{out['launches']}")
    out["trace_events"] = _dump(run, tr, trace_out)
    run.finish([uid], out)
    out["held"] = run.hold(shared, 0, xs[0])
    run.say(f"wall time {out['wall_s']:.1f} s; phases (s) "
            + ", ".join(f"{p} {v:.2f}" for p, v in run.phases.items()))
    return out


def scenario_partition(seed: int, trace_out: str, jobs: int, device="cuda",
                       rows=None) -> dict:
    run = Run("partition", seed, device, rows)
    s = run.shape
    n, k, chunks = s.n, s.k, s.chunks
    victim = 1
    a, rng = run.a, run.rng
    xs = [rng.standard_normal(run.cols) for _ in range(jobs)]
    strat = GeneralS2C2(n, k, a.shape[0], chunks=chunks)
    chaos = ChaosConfig(seed=seed, partition_worker=victim,
                        partition_mode="events", partition_after_chunks=1,
                        partition_duration_s=2.0)
    tr = Tracer(enabled=True)
    t = t_eng = time.perf_counter()
    eng = run.engine(
        run.config(starvation_timeout=30.0, max_reassign_waves=0, enable_stealing=False),
        NoSlowdown(), tracer=tr,
        transport=FaultyTransport(chaos, hb_interval=0.05, hb_miss=4,
                                  dead_after=2, connect_timeout=60.0,
                                  event_silence_factor=2.0))
    run.mark("spawn", t)
    uid = eng.transport.shm_uid
    out = {}
    try:
        t = time.perf_counter()
        data = eng.load_matrix(a, chunks=chunks)
        run.mark("encode_install", t)
        t = time.perf_counter()
        handles = [eng.matvec_async(data, x, strat) for x in xs]
        outs = [h.result(timeout=120.0) for h in handles]
        run.mark("rounds", t)
        run.check_y([o.y for o in outs], xs)
        credits = sum(o.metrics.partition_credits for o in outs)
        reg = eng.registry
        # the rounds end once the healed worker's replay is credited; its
        # rejoin handshake (the child digests its shard: ~1 s at 983 MB)
        # may still be in flight
        t = time.perf_counter()
        while (reg.value("s2c2_rejoins_total") < 1
               and time.perf_counter() - t < 15.0):
            time.sleep(0.02)
        out["rejoin_wait_s"] = time.perf_counter() - t
        require(reg.value("s2c2_transport_verdicts_total") >= 1,
                "events-silent partition never drew a §4.4 verdict")
        require(reg.value("s2c2_rejoins_total") >= 1,
                "healed worker never completed the rejoin handshake")
        require(credits >= 1, "partition-era work must be credited at heal, not recomputed")
        out.update(credits=int(credits), rejoins=reg.value("s2c2_rejoins_total"),
                   transport_verdicts=reg.value("s2c2_transport_verdicts_total"))
        run.say(f"all {len(outs)} rounds completed within {Y_RTOL} of float64 (worst "
                f"{run.worst:.3e}) across a 2.0s events partition of worker {victim} "
                f"(seed={seed}); {credits} partition-era chunks credited, never recomputed; "
                f"{out['rejoins']:.0f} rejoin(s), the first {out['rejoin_wait_s']:.3f} s "
                "after the last round returned")
    finally:
        t = time.perf_counter()
        eng.shutdown()
        run.mark("shutdown", t)

    recs = tr.snapshot()
    require(any(r.kind == KIND_REJOIN for r in recs), "rejoin handshake missing from trace")
    require(any(r.kind == KIND_FAILSTOP_VERDICT and r.worker == victim for r in recs),
            f"the partitioned worker {victim} drew no verdict")
    run.no_compute_errors()
    out.update(run.verdicts(recs, t_eng))
    decoded = sum(1 for r in recs if r.kind == KIND_ROUND_DECODE)
    out.update(jobs=len(outs), rounds=decoded, launches=run.launches(decoded),
               children=run.children(recs))
    run.say(f"{len(outs)} rounds, {decoded} decoded; master launches {out['launches']}")
    out["trace_events"] = _dump(run, tr, trace_out)
    run.finish([uid], out)
    out["held"] = run.hold(data, 0, xs[0])
    run.say(f"wall time {out['wall_s']:.1f} s; phases (s) "
            + ", ".join(f"{p} {v:.2f}" for p, v in run.phases.items()))
    return out


def scenario_recover(seed: int, trace_out: str, jobs: int, device="cuda",
                     rows=None) -> dict:
    run = Run("recover", seed, device, rows)
    s = run.shape
    n, k, chunks = s.n, s.k, s.chunks
    a, rng = run.a, run.rng
    x = rng.standard_normal(run.cols)
    speeds = np.array([[0.08, 1.0, 1.0]])    # worker 0 holds the round open
    strat = GeneralS2C2(n, k, a.shape[0], chunks=chunks)
    tmp = tempfile.mkdtemp(prefix="torch_chaos_demo_recover_")
    cfg = run.config(starvation_timeout=20.0, journal_dir=tmp)

    def transport(connect_timeout=60.0):
        return SocketTransport(hb_interval=0.05, hb_miss=4, dead_after=2,
                               connect_timeout=connect_timeout,
                               reconnect_backoff=0.05, reconnect_tries=10)

    t = time.perf_counter()
    eng = run.engine(cfg, TraceInjector(speeds), transport=transport())
    run.mark("spawn", t)
    uid = eng.transport.shm_uid
    eng2 = None
    out = {}
    try:
        t = time.perf_counter()
        data = eng.load_matrix(a, chunks=chunks)
        run.mark("encode_install_journal", t)
        t = time.perf_counter()
        h1 = eng.matvec_async(data, x, strat)
        deadline = time.perf_counter() + 30.0
        while (eng.registry.value("s2c2_journal_records_total") < 3 + 4
               and time.perf_counter() < deadline):
            time.sleep(0.02)
        procs = eng.transport.procs
        eng.crash()
        run.mark("to_crash", t)
        try:
            h1.result(timeout=10.0)
            raise AssertionError("crashed round resolved without EngineClosed")
        except EngineClosed:
            pass
        # the crashed round's partials, views of result segments that the
        # crash unmapped, stay alive in a reference cycle: collect it while
        # the crashed engine holds those segments, or the collection that
        # frees both finds them still exported (a BufferError traceback)
        del h1
        gc.collect()
        # the orphaned children's shards, each uploaded when it was installed
        at_crash = run.mem.steady()
        tr = Tracer(enabled=True)
        t = t_eng = time.perf_counter()
        eng2 = CodedExecutionEngine.recover(
            cfg, TraceInjector(speeds), compute=run.backend(), predictor=run.predictor(),
            tracer=tr, transport=transport(connect_timeout=30.0), procs=procs,
            device=run.dev)
        run.mark("recover", t)
        require(len(eng2.recovered) == 1,
                f"expected 1 journaled open round, got {len(eng2.recovered)}")
        (rid, handle), = [(h.round_id, h) for h in eng2.recovered.values()]
        t = time.perf_counter()
        res = handle.result(timeout=60.0)
        run.mark("resumed_round", t)
        run.check_y([res.y], [x])
        journaled = {(w, c)
                     for c, entries in eng2.journal_state.acks[rid].items()
                     for w, _ in entries}
        re_enqueued = {(r.worker, r.chunk_id) for r in tr.snapshot()
                       if r.kind == KIND_ENQUEUE and r.round_id == rid}
        require(bool(journaled), "no acks survived in the journal")
        require(not (re_enqueued & journaled),
                f"journaled acks recomputed: {sorted(re_enqueued & journaled)}")
        require(bool(re_enqueued), "the interrupted worker's chunks never resumed")
        # the adopted children keep their shards resident on the card: a
        # second upload would show as a shard's bytes more in use
        after = run.mem.used()
        uploads = (None if after is None
                   else max(round((after - at_crash) / run.shard_bytes), 0))
        out.update(journaled=len(journaled), re_enqueued=sorted(re_enqueued),
                   recovered_chunks=res.metrics.recovered_chunks, mem_at_crash=at_crash,
                   mem_after_resumed=after, shard_uploads_again=uploads)
        run.say(f"master killed mid-round and recovered (seed={seed}): {len(journaled)} "
                f"journaled acks seeded, {res.metrics.recovered_chunks} chunks recovered, 0 "
                f"recomputed, the resumed round within {Y_RTOL} of float64 ({run.worst:.3e}); "
                f"re-enqueued {sorted(re_enqueued)}")
        run.say("the adopted children uploaded their shards again: "
                + ("not measured (CPU)" if uploads is None else
                   f"{uploads} time(s) (the card's memory in use {gb(at_crash)} at the crash, "
                   f"{gb(after)} after the resumed round; a shard is {gb(run.shard_bytes)})"))
        require(uploads in (None, 0), f"the adopted children uploaded {uploads} shard(s) "
                "again: the recovered master should find them resident")
    finally:
        t = time.perf_counter()
        eng.shutdown()
        if eng2 is not None:
            eng2.shutdown()
        run.mark("shutdown", t)
        shutil.rmtree(tmp, ignore_errors=True)

    recs = tr.snapshot()
    run.no_compute_errors()
    out.update(run.verdicts(recs, t_eng))
    decoded = sum(1 for r in recs if r.kind == KIND_ROUND_DECODE)
    out.update(jobs=1, rounds=decoded, launches=run.launches(decoded),
               children=run.children(recs))
    run.say(f"1 round, {decoded} decoded after recovery; master launches {out['launches']}")
    out["trace_events"] = _dump(run, tr, trace_out)
    run.finish([uid], out)
    out["held"] = run.hold(data, 1, x)
    run.say(f"wall time {out['wall_s']:.1f} s; phases (s) "
            + ", ".join(f"{p} {v:.2f}" for p, v in run.phases.items()))
    return out


SCENARIOS = {"kill": scenario_kill,
             "partition": scenario_partition,
             "recover": scenario_recover}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenario", choices=sorted(SCENARIOS), default="kill",
                    help="fault scenario to replay (default: kill)")
    ap.add_argument("--seed", type=int, default=0,
                    help="chaos schedule seed (the reference's CI matrix: 0, 1, 2)")
    ap.add_argument("--trace-out", default="chaos_trace.json",
                    help="Perfetto/Chrome trace output path")
    ap.add_argument("--jobs", type=int, default=4,
                    help="jobs/rounds to push through the pool")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises where there is no card) or cpu")
    ap.add_argument("--rows", type=int, default=None,
                    help=f"rows of each worker's coded partition, d = {COLS} (default: "
                         "kill 60,000, partition and recover 20,000; on the CPU the "
                         "reference's own shapes)")
    args = ap.parse_args(argv)
    SCENARIOS[args.scenario](args.seed, args.trace_out, args.jobs, device=args.device,
                             rows=args.rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
