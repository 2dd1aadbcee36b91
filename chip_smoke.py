#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card, end to end.

Run from the root of a checkout (it needs ``src/repro_torch`` beside it and
one CUDA device; the kernels are built into ``build/kernels/`` first):

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:

1. print the card's name and power limit, build the four kernels;
2. hold each kernel against its plain PyTorch version on the card, at the
   main path's shapes and at ragged ones, and time kernel, plain version and
   one PyTorch library call two ways, with CUDA events:
   - ``device_ms``: many launches back to back, queued behind a sleep kernel
     so that the host runs ahead (checked, and timed again with fewer calls
     where it did not), divided by their count: the device's time;
   - ``call_ms``: the median of 20 single calls, each timed from the host's
     enqueue: the time a caller that waits for each call sees;
   the predictor's kernel is timed as the main path calls it, one 32-step
   window over the 12 workers through the sequence kernel; beside it the
   per-step cell and the launch floor (a one-element in-place add);
3. in turns on the card (new, old, old, new), at the main shape:
   ``coded_matvec``'s stream design against the warp-per-row design, each
   reached directly, and against ``torch.matmul`` on the same rows gathered
   beforehand; the fused decode against the composition it replaced (index
   gather → ``mds_decode`` → transpose copy) and against the same three
   steps with ``torch.bmm``; the predictor's 32-step window through the
   sequence kernel against the per-step loop it replaced (32 ``lstm_cell``
   launches, each with the head) and against ``torch.nn.LSTM`` and the head;
4. the main path at full size: encode a 600,000 × 2,048 float32 matrix with
   a (12, 10)-MDS code, then 30 iterations of predict (LSTM) → plan
   (Algorithm 1) → coded matvec (assigned chunks only) → decode, each checked
   against a float64 product on the card, then one more encode with the
   allocator's memory warm; the kernels' launch counters are zeroed just
   before this phase and read just after it.  It fails unless every
   ``coded_matvec`` launch took the stream design, ``mds_decode``
   launched exactly once per iteration, and the predictor launched the
   sequence kernel once per prediction with history (29) and the per-step
   cell never.  Before it, the last prediction's window is run both through
   the sequence kernel and through the per-step loop, which must agree;
5. the cluster engine (``repro_torch.cluster``) on the card: 12 worker
   threads on the in-process transport compute their chunks through the
   CUDA ``KernelBackend`` (shards resident on the card) and the master
   decodes through ``mds_decode`` (``decode_with_kernel``), planning with
   the LSTM on the card, under the trace's speeds.  A 600,000 × 2,048
   tenant, C = 20, is encoded on the host in float64 as the reference does;
   then 20 ``GeneralS2C2`` matvec rounds, one ``matmul`` round at B = 8
   and one at B = 20, each within 1e-3 of a float64 product.  The counters
   are zeroed before each group of rounds and read after it, once every
   worker is idle.  It fails unless every B = 1 chunk launch took the
   stream design, ``coded_matvec`` launched once per chunk computed and
   column group of at most 16, ``mds_decode`` once per round, and the
   predictor's sequence kernel once per round with history (its cell
   never).  At a chunk's shape it holds each ``coded_matvec`` launch the
   backend makes (B = 1, 8 and 20) and the round's ``mds_decode`` against
   their plain versions on the same card tensors.  It prints the host
   encode's time and resident memory, the makespans, ``compute_chunk``'s
   ``call_ms``, the decode's times, ``calibrate_row_cost`` and the
   backend's caches.  Then a small pool of spawned worker processes
   (``SocketTransport``, 4 workers, each building the CUDA backend on the
   card from the library built here) runs 3 exact rounds.

The last lines are the in-turn times as JSON, the per-kernel record as JSON
(``ms``, ``plain_ms`` and ``library_ms`` are device times; ``*call_ms`` the
per-call times; ``launches`` the main path's, ``cluster_launches`` the
cluster phase's) and the device line.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# the main path: the paper's logistic-regression workload as the repo sizes it
# (benchmarks/fig_overheads.py: (n, k) = (12, 10), D = 600,000; C = 20 chunks
# as in examples/pagerank.py), with d = 2,048 float32 columns
N, K, CHUNKS, ROWS, COLS, ITERS = 12, 10, 20, 600_000, 2_048, 30
# the cluster phase: the same code, D, C and d
CL_ROUNDS, CL_ROW_COST, CL_WIDTHS = 20, 1e-5, (8, 20)
WINDOW = 32                     # the predictor's window (SpeedPredictor's default)
REL_ERR_LIMIT = 1e-3
F32_TOL = 2e-4                  # a float32 kernel against its plain version (rtol = atol)
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA's data sheet
F32_FLOPS_PER_S = 67e12         # float32 outside the tensor cores
REPS = 20
DEVICE_WINDOW_MS = 50.0         # device_ms: about this much work per window

KERNELS = {
    "coded_matvec": "src/repro/kernels/coded_matvec.py:54",
    "mds_encode": "src/repro/kernels/mds_encode.py:35",
    "mds_decode": "src/repro/kernels/mds_decode.py:31",
    "lstm_cell": "src/repro/kernels/lstm_cell.py:46",
}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def bound_ms(n_bytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def host_peak(fn):
    """``fn()``, with the process's resident memory in GB before the call
    and at its peak during it (sampled every 5 ms)."""
    page = os.sysconf("SC_PAGE_SIZE")

    def rss_gb() -> float:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * page / 1e9

    start, peak, done = rss_gb(), [0.0], threading.Event()

    def sample():
        while not done.wait(0.005):
            peak[0] = max(peak[0], rss_gb())

    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    try:
        out = fn()
    finally:
        done.set()
        sampler.join()
    return out, (start, max(peak[0], rss_gb()))


def wait_idle(eng, timeout: float = 120.0) -> None:
    """Until every worker of an in-process engine has nothing queued or
    running (a round returns while cancelled stragglers finish a chunk)."""
    deadline = time.monotonic() + timeout
    while not all(w.idle() for w in eng.workers):
        if time.monotonic() > deadline:
            raise RuntimeError("cluster: workers still busy after the rounds")
        time.sleep(0.005)


def cluster_phase(dev, call_ms, timed, compare, rows: int) -> dict:
    """Phase 5: the cluster engine on the card, over a ``rows`` × d tenant.
    Returns the launches of its in-process rounds per kernel."""
    import numpy as np
    import torch

    from repro_torch.cluster import (ClusterConfig, CodedExecutionEngine, NoSlowdown,
                                     SocketTransport, TraceInjector, kernel_backend)
    from repro_torch.cluster.transport import _compute_spec
    from repro_torch.convert import load_params
    from repro_torch.core.predictor import SpeedPredictor
    from repro_torch.core.simulation import calibrate_row_cost
    from repro_torch.core.strategies import GeneralS2C2
    from repro_torch.core.traces import controlled_traces
    from repro_torch.kernels import coded_matvec as cmv
    from repro_torch.kernels import mds_decode as dec
    from repro_torch.kernels import ops
    from repro_torch.kernels.coded_matvec import MAX_NVEC

    rng = np.random.default_rng(3)
    a = rng.standard_normal((rows, COLS), dtype=np.float32)
    a64 = a.astype(np.float64)
    backend = kernel_backend()
    predictor = SpeedPredictor(N, load_params())
    traces = controlled_traces(N, CL_ROUNDS, n_stragglers=2, seed=7)
    eng = CodedExecutionEngine(
        ClusterConfig(n_workers=N, k=K, row_cost=CL_ROW_COST, decode_with_kernel=True),
        injector=TraceInjector(traces), compute=backend, predictor=predictor)
    totals: dict = {}
    try:
        t0 = time.perf_counter()
        data, rss = host_peak(lambda: eng.load_matrix(a, chunks=CHUNKS))
        encode_s = time.perf_counter() - t0
        rpc = data.rows_per_chunk
        strategy = GeneralS2C2(N, K, rows, chunks=CHUNKS)
        print(f"cluster: tenant {rows} x {COLS}, ({N}, {K}) code, C = {CHUNKS} "
              f"(rpc {rpc}); host float64 encode and install {encode_s:.2f} s, host resident memory "
              f"{rss[0]:.2f} GB before it and {rss[1]:.2f} GB at its peak; coded state "
              f"on the card {N * data.partitions[0].size * 4 / 1e9:.2f} GB", flush=True)

        def run_group(label, widths):
            """Rounds at the given RHS widths (None: matvec), checked, with
            their launches added to ``totals``."""
            wait_idle(eng)
            ops.reset_launch_counts()
            before = backend.cache_info()
            makespans, planned, walls, decodes = [], [], [], []
            worst, with_history = 0.0, 0
            for width in widths:
                x = rng.standard_normal(COLS if width is None else (COLS, width))
                with_history += bool(predictor.history)
                t0 = time.perf_counter()
                out = (eng.matvec(data, x, strategy) if width is None
                       else eng.matmul(data, x, strategy))
                walls.append(time.perf_counter() - t0)
                makespans.append(out.metrics.makespan)
                planned.append(out.metrics.planned_makespan)
                decodes.append(out.metrics.decode_time)
                want = a64 @ x
                if out.y.shape != want.shape or not np.isfinite(out.y).all():
                    raise RuntimeError(f"cluster {label}: y has shape {out.y.shape} or "
                                       "non-finite values")
                err = float(np.abs(out.y - want).max() / np.abs(want).max())
                if err > REL_ERR_LIMIT:
                    raise RuntimeError(f"cluster {label}: relative error {err:.3e} > "
                                       f"{REL_ERR_LIMIT}")
                worst = max(worst, err)
            wait_idle(eng)
            counts, designs = ops.launch_counts(), ops.design_counts()
            info = backend.cache_info()
            chunks = info["x_hits"] + info["x_misses"] - before["x_hits"] - before["x_misses"]
            groups = 1 if widths[0] is None else -(-widths[0] // MAX_NVEC)
            ms = sorted(m * 1e3 for m in makespans)
            print(f"cluster {label}: {len(widths)} round(s); makespan ms median "
                  f"{statistics.median(ms):.3f} (min {ms[0]:.3f}, max {ms[-1]:.3f}); planned "
                  f"ms median {statistics.median(planned) * 1e3:.3f}; host wall ms median "
                  f"{statistics.median(walls) * 1e3:.3f}; decode ms median "
                  f"{statistics.median(decodes) * 1e3:.3f}; worst relative error {worst:.3e}; "
                  f"chunks computed {chunks}; launches {counts}; by design {designs}",
                  flush=True)
            if counts["coded_matvec"] != chunks * groups:
                raise RuntimeError(f"cluster {label}: {counts['coded_matvec']} coded_matvec "
                                   f"launches for {chunks} chunks of {groups} column group(s)")
            if widths[0] is None and designs["coded_matvec"]["general"]:
                raise RuntimeError(f"cluster {label}: B = 1 chunk launches left the stream "
                                   f"design: {designs['coded_matvec']}")
            if counts["mds_decode"] != len(widths):
                raise RuntimeError(f"cluster {label}: mds_decode launched "
                                   f"{counts['mds_decode']} times in {len(widths)} rounds")
            if designs["lstm_cell"] != {"sequence": with_history, "cell": 0}:
                raise RuntimeError(f"cluster {label}: the predictor's launches "
                                   f"{designs['lstm_cell']}, not one sequence launch for "
                                   f"each of {with_history} rounds with history")
            for name, v in counts.items():
                totals[name] = totals.get(name, 0) + v

        run_group("matvec rounds", [None] * CL_ROUNDS)
        for width in CL_WIDTHS:
            run_group(f"matmul round, B = {width}", [width])

        # a chunk's compute at its shape, beside the time the worker stretches
        # it to at speed 1.0; and its launches, each held against the plain
        # version on the same card tensors: the view of a systematic and of
        # a parity shard with block id 0, one launch per column group, as
        # the backend makes them
        zero = torch.zeros(1, dtype=torch.int32, device=dev)
        shards = [torch.as_tensor(data.partitions[w], dtype=torch.float32, device=dev)
                  for w in (0, N - 1)]
        for width in (None,) + CL_WIDTHS:
            x = rng.standard_normal(COLS if width is None else (COLS, width))
            t = call_ms(lambda: backend.compute_chunk(0, data.shard_id, data.partitions[0],
                                                      rpc, 2 * rpc, x))
            x_d = torch.as_tensor(x, dtype=torch.float32, device=dev)
            groups = ([x_d] if width is None else
                      [x_d[:, c:c + MAX_NVEC].contiguous() for c in range(0, width, MAX_NVEC)])
            err = 0.0
            for shard in shards:
                view = shard[rpc:2 * rpc]
                for xg in groups:
                    err = max(err, compare(
                        f"cluster coded_matvec ({rpc}, {COLS}) x {tuple(xg.shape)}",
                        ops.coded_matvec(view, xg, zero, rpc),
                        cmv.coded_matvec_plain(view, xg, zero, rpc), F32_TOL))
            launch = timed(lambda: [ops.coded_matvec(shards[0][rpc:2 * rpc], xg, zero, rpc)
                                    for xg in groups])
            print(f"cluster compute_chunk ({rpc}, {COLS}), B = {width or 1}: call ms {t:.4f} "
                  f"against {rpc * (width or 1) * CL_ROW_COST * 1e3:.1f} ms of a chunk at "
                  f"speed 1.0; its {len(groups)} coded_matvec launch(es): device ms "
                  f"{launch['device_ms']:.4f}, call ms {launch['call_ms']:.4f}; against "
                  f"the plain version max abs err {err:.3e} (tol {F32_TOL})", flush=True)
        del shards
        # the decode of one round at (C, k, k) x rpc·B: the kernel alone on
        # the card, held against the plain version on the same tensors, and
        # the whole host decode (upload, launch, download)
        cov_ids = np.stack([np.sort(rng.choice(N, K, replace=False)) for _ in range(CHUNKS)])
        dms = data.code.decode_submats(cov_ids)
        w_d = torch.as_tensor(dms, dtype=torch.float32, device=dev)
        table = torch.arange(CHUNKS * K, dtype=torch.int32, device=dev).view(CHUNKS, K)
        for width in (None,) + CL_WIDTHS:
            cols = rpc * (width or 1)
            y_parts = rng.standard_normal((CHUNKS, K, cols))
            p_d = torch.as_tensor(y_parts.reshape(CHUNKS * K, cols), dtype=torch.float32,
                                  device=dev)
            buf = torch.empty((K, CHUNKS, cols), device=dev)
            err = compare(f"cluster mds_decode ({CHUNKS}, {K}, {K}) x {cols}",
                          ops.mds_decode_into(w_d, p_d, table, buf.transpose(0, 1)),
                          dec.mds_decode_into_plain(w_d, p_d, table,
                                                    torch.empty_like(buf).transpose(0, 1)),
                          F32_TOL)
            kern = timed(lambda: ops.mds_decode_into(w_d, p_d, table, buf.transpose(0, 1)))
            host = call_ms(lambda: data.decode_compact(
                dms, y_parts if width is None else y_parts.reshape(CHUNKS, K, rpc, width),
                use_kernel=True))
            print(f"cluster decode ({CHUNKS}, {K}, {K}) x {cols}: mds_decode device ms "
                  f"{kern['device_ms']:.4f}, call ms {kern['call_ms']:.4f}; decode_compact "
                  f"(upload, launch, download) call ms {host:.4f}; against the plain version "
                  f"max abs err {err:.3e} (tol {F32_TOL})", flush=True)
        print(f"cluster calibrate_row_cost on the card: {calibrate_row_cost():.3e} s a row "
              f"(the engine's row_cost: {CL_ROW_COST:.0e})", flush=True)
        print(f"cluster backend caches: {backend.cache_info()}", flush=True)
    finally:
        eng.shutdown()
    del backend
    torch.cuda.empty_cache()

    # spawned worker processes, each on the card (the library is built)
    n, k, chunks, rows, d = 4, 2, 4, 4096, 256
    a_p = rng.standard_normal((rows, d)).astype(np.float32).astype(np.float64)
    backend = kernel_backend()
    spec = _compute_spec(backend)
    if spec != f"kernel:{dev.type}:{torch.cuda.current_device()}":
        raise RuntimeError(f"cluster processes: the backend travels as {spec!r}")
    t0 = time.perf_counter()
    eng = CodedExecutionEngine(
        ClusterConfig(n_workers=n, k=k, row_cost=1e-6, starvation_timeout=60.0),
        NoSlowdown(), compute=backend, transport=SocketTransport(connect_timeout=120.0))
    try:
        start_s = time.perf_counter() - t0
        data = eng.load_matrix(a_p, chunks=chunks)
        worst = 0.0
        for _ in range(3):
            x = rng.standard_normal(d)
            y = eng.matvec(data, x, GeneralS2C2(n, k, rows, chunks=chunks)).y
            want = a_p @ x
            err = float(np.abs(y - want).max() / np.abs(want).max())
            if not np.isfinite(y).all() or err > 1e-4:
                raise RuntimeError(f"cluster processes: relative error {err:.3e} > 1e-4")
            worst = max(worst, err)
    finally:
        eng.shutdown()
    print(f"cluster processes: {n} spawned workers ({spec}) started in {start_s:.1f} s; 3 "
          f"rounds, worst relative error {worst:.3e}", flush=True)
    return totals


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a card",
              file=sys.stderr)
        return 2

    import numpy as np

    from repro_torch.convert import load_params
    from repro_torch.core.coded_matmul import CodedMatvec
    from repro_torch.core.coding import MDSCode
    from repro_torch.core.predictor import SpeedPredictor, predict_next
    from repro_torch.core.s2c2 import general_allocation
    from repro_torch.core.traces import controlled_traces
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import coded_matvec as cmv

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # -- 1. card and build ----------------------------------------------------
    card = card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s ({len(_build.SOURCES)} sources, one nvcc "
          "each, in parallel; less if build/kernels/ already held the library)", flush=True)

    def call_ms(fn) -> float:
        """Median of single calls, each from the host's enqueue to its end."""
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(REPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    # cycles of torch.cuda._sleep per millisecond, to queue work behind it
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(1_000_000)
    start.record()
    torch.cuda._sleep(10_000_000)
    end.record()
    end.synchronize()
    sleep_cycles_per_ms = 10_000_000 / start.elapsed_time(end)

    def device_ms(fn, per_call_ms: float) -> float:
        """Launches back to back on the device: they are queued behind a
        sleep long enough for the host to enqueue all of them first.

        An event recorded just after the sleep says whether it was: where
        the sleep had ended before the host enqueued the last call (a slow
        host, or more launches than the device's queue holds, as in a loop
        of small launches), the window would time the host, so it is timed
        again with a quarter of the calls and twice the sleep.
        """
        n = int(min(200, max(5, DEVICE_WINDOW_MS / per_call_ms)))
        margin = 1.5
        while True:
            fn()
            torch.cuda.synchronize()
            torch.cuda._sleep(int(margin * n * per_call_ms * sleep_cycles_per_ms) + 1000)
            slept = torch.cuda.Event()
            slept.record()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                fn()
            end.record()
            host_ahead = not slept.query()
            end.synchronize()
            if host_ahead:
                return start.elapsed_time(end) / n
            if margin >= 48:
                raise RuntimeError(f"device_ms: the host did not get ahead of the device "
                                   f"with {n} call(s) behind a {margin}x sleep")
            n, margin = max(1, n // 4), margin * 2

    def timed(fn) -> dict:
        c = call_ms(fn)
        return {"device_ms": device_ms(fn, c), "call_ms": c}

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    def compare(name, got, want, tol) -> float:
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = 0.0
        for g, w in zip(got, want):
            g32, w32 = g.float(), w.float()
            if g.shape != w.shape or not torch.isfinite(g32).all():
                raise RuntimeError(f"{name}: shape {tuple(g.shape)} vs {tuple(w.shape)} "
                                   "or non-finite values")
            if not torch.allclose(g32, w32, rtol=tol, atol=tol):
                raise RuntimeError(f"{name}: kernel and plain version disagree, max abs "
                                   f"err {float((g32 - w32).abs().max()):.3e} > {tol}")
            err = max(err, float((g32 - w32).abs().max()))
        return err

    records = {}

    def record(name, kernel, plain, library, n_bytes, flops, tol, library_name):
        err = compare(f"{name} (main shape)", kernel(), plain(), tol)
        k_t, p_t, l_t = timed(kernel), timed(plain), timed(library)
        b_ms, b_by = bound_ms(n_bytes, flops)
        records[name] = dict(name=name, route="cuda",
                             source=f"src/repro_torch/kernels/csrc/{name}.cu",
                             replaces=KERNELS[name], launches=0, max_abs_err=err,
                             ms=k_t["device_ms"], plain_ms=p_t["device_ms"],
                             bound_ms=b_ms, bound_by=b_by, library_ms=l_t["device_ms"],
                             device_ms=k_t["device_ms"], call_ms=k_t["call_ms"],
                             plain_device_ms=p_t["device_ms"], plain_call_ms=p_t["call_ms"],
                             library_device_ms=l_t["device_ms"],
                             library_call_ms=l_t["call_ms"], library=library_name)
        print(f"{name}: device ms: kernel {k_t['device_ms']:.4f}, plain "
              f"{p_t['device_ms']:.4f}, library {l_t['device_ms']:.4f}; call ms: kernel "
              f"{k_t['call_ms']:.4f}, plain {p_t['call_ms']:.4f}, library "
              f"{l_t['call_ms']:.4f}; bound {b_ms:.4f} ms ({b_by}), max abs err "
              f"{err:.3e} (tol {tol})", flush=True)

    turns = {}

    def in_turns(label, fns: dict, order: list[str]) -> None:
        """Time several versions of one function in turns on this card."""
        times = {name: [] for name in fns}
        for name in order:
            times[name].append(timed(fns[name]))
        turns[label] = {name: {"device_ms": [t["device_ms"] for t in ts],
                               "call_ms": [t["call_ms"] for t in ts]}
                        for name, ts in times.items()}
        for name, ts in turns[label].items():
            print(f"in turns, {label}: {name}: device ms "
                  f"{', '.join(f'{v:.4f}' for v in ts['device_ms'])}; call ms "
                  f"{', '.join(f'{v:.4f}' for v in ts['call_ms'])}", flush=True)

    def cell_loop(xs_, w_ih, w_hh, b, w_out, b_out):
        """The window step by step: one lstm_cell launch per step, the head
        after each (the predictor's loop before the sequence kernel)."""
        h = xs_.new_zeros((xs_.shape[1], w_hh.shape[1]))
        c = xs_.new_zeros((xs_.shape[1], w_hh.shape[1]))
        ys = []
        for x_ in xs_:
            h, c = ops.lstm_cell(x_.contiguous(), h, c, w_ih, w_hh, b)
            ys.append(h @ w_out.T + b_out)
        return torch.stack(ys)

    tol = {torch.float32: F32_TOL, torch.bfloat16: 5e-2}
    rows_w = ROWS // K                   # rows of one coded partition
    rpc = rows_w // CHUNKS               # rows of one chunk

    # -- 2 and 3. every kernel against its plain version; in turns ------------
    # coded_matvec: the main path's launch reads k·C assigned chunks out of
    # the n·C chunks of the (n·rows, d) coded tensor
    a = randn(N * rows_w, COLS)
    x = randn(COLS)
    ids = torch.randperm(N * CHUNKS, generator=gen, device=dev)[: K * CHUNKS]
    ids = ids.to(torch.int32)
    nb = ids.numel()
    sel = a.view(N * CHUNKS, rpc, COLS)[ids.long()].reshape(-1, COLS)
    record("coded_matvec",
           lambda: ops.coded_matvec(a, x, ids, rpc),
           lambda: ref.coded_matvec_ref(a, x, ids, rpc),
           lambda: torch.matmul(sel, x),
           n_bytes=4 * (nb * rpc * COLS + COLS + nb + nb * rpc),
           flops=2 * nb * rpc * COLS, tol=tol[torch.float32],
           library_name="torch.matmul on pre-gathered rows")
    if not cmv.takes_stream(a, x):
        raise RuntimeError("the main shape does not take coded_matvec's stream design")
    records["coded_matvec"]["design"] = "stream"
    # the two designs, each reached directly, and cuBLAS's GEMV on the rows
    # gathered beforehand, in turns at the main shape
    compare("coded_matvec stream vs general (main shape)",
            cmv.coded_matvec_stream(a, x, ids, rpc), cmv.coded_matvec_general(a, x, ids, rpc),
            tol[torch.float32])
    versions = {
        "stream": lambda: cmv.coded_matvec_stream(a, x, ids, rpc),
        "general (warp per row)": lambda: cmv.coded_matvec_general(a, x, ids, rpc),
        "torch.matmul on pre-gathered rows": lambda: torch.matmul(sel, x),
    }
    in_turns("coded_matvec", versions, list(versions) + list(versions)[::-1])
    del a, sel
    for chunks, br, d, nvec, dt in [(12, 16, 300, 3, torch.float32),
                                    (5, 8, 130, 2, torch.bfloat16),
                                    (6, 32, 512, 8, torch.bfloat16),
                                    (4, 64, 2048, 16, torch.float32),
                                    (7, 100, 1024, 1, torch.bfloat16)]:
        a_r, x_r = randn(chunks * br, d, dtype=dt), randn(d, nvec, dtype=dt)
        ids_r = torch.randperm(chunks, generator=gen, device=dev)[: max(2, chunks // 2)]
        ids_r = ids_r.to(torch.int32)
        compare(f"coded_matvec {(chunks, br, d, nvec, dt)}",
                ops.coded_matvec(a_r, x_r, ids_r, br),
                ref.coded_matvec_ref(a_r, x_r, ids_r, br), tol[dt])
    # the stream design at ragged shapes: nb of 1, under the grid and many
    # times it; br not a multiple of the tile's rows; d up to 32 KB a row
    for blocks_r, nb_r, br, d, dt in [(4, 1, 37, 2048, torch.float32),
                                      (64, 40, 11, 4096, torch.bfloat16),
                                      (600, 1500, 6, 2048, torch.float32),
                                      (50, 300, 130, 1024, torch.bfloat16),
                                      (6, 9, 5, 8192, torch.float32)]:
        a_r, x_r = randn(blocks_r * br, d, dtype=dt), randn(d, dtype=dt)
        ids_r = torch.randint(0, blocks_r, (nb_r,), generator=gen, device=dev,
                              dtype=torch.int32)
        compare(f"coded_matvec stream {(blocks_r, nb_r, br, d, dt)}",
                cmv.coded_matvec_stream(a_r, x_r, ids_r, br),
                ref.coded_matvec_ref(a_r, x_r, ids_r, br), tol[dt])

    # mds_encode: the whole matrix, once
    g = torch.as_tensor(MDSCode(N, K).generator, dtype=torch.float32, device=dev)
    blocks = randn(K, rows_w, COLS)
    plane = rows_w * COLS
    record("mds_encode",
           lambda: ops.mds_encode(g, blocks),
           lambda: ref.mds_encode_ref(g, blocks),
           lambda: torch.einsum("nk,krd->nrd", g, blocks),
           n_bytes=4 * (N * K + K * plane + N * plane),
           flops=2 * N * K * plane, tol=tol[torch.float32], library_name="torch.einsum")
    del blocks
    torch.cuda.empty_cache()
    for n, k, r, d, dt in [(12, 10, 100, 260, torch.bfloat16), (5, 3, 63, 130, torch.float32),
                           (5, 3, 63, 130, torch.bfloat16), (4, 4, 16, 640, torch.float32),
                           (40, 32, 10, 8, torch.float32)]:
        g_r = randn(n, k, dtype=dt)
        b_r = randn(k, r, d, dtype=dt)
        compare(f"mds_encode {(n, k, r, d, dt)}", ops.mds_encode(g_r, b_r),
                ref.mds_encode_ref(g_r, b_r), tol[dt])

    # mds_decode: one round's decode as the main path launches it, from the
    # k·C partials that coded_matvec leaves, (k·C, rpc), through a (C, k)
    # position table (each partial used once), into y's final layout
    w = randn(CHUNKS, K, K)
    parts = randn(K * CHUNKS, rpc)
    table = torch.randperm(K * CHUNKS, generator=gen, device=dev).view(CHUNKS, K)
    table_long, table = table, table.to(torch.int32)
    gathered = parts[table_long]

    def y_view():
        return torch.empty(K * rows_w, device=dev).view(K, CHUNKS, rpc).transpose(0, 1)

    record("mds_decode",
           lambda: ops.mds_decode_into(w, parts, table, y_view()),
           lambda: ref.mds_decode_into_ref(w, parts, table, y_view()),
           lambda: torch.bmm(w, gathered),
           n_bytes=4 * (CHUNKS * K * K + CHUNKS * K + 2 * CHUNKS * K * rpc),
           flops=2 * CHUNKS * K * K * rpc, tol=tol[torch.float32],
           library_name="torch.bmm on pre-gathered partials")
    composition = {
        "fused": lambda: ops.mds_decode_into(w, parts, table, y_view()).transpose(0, 1),
        "gather, mds_decode, transpose":
            lambda: ops.mds_decode(w, parts[table_long].float()).transpose(0, 1).reshape(
                K * rows_w),
        "gather, torch.bmm, transpose":
            lambda: torch.bmm(w, parts[table_long]).transpose(0, 1).reshape(K * rows_w),
    }
    for name, fn in composition.items():
        compare(f"mds_decode: {name} vs plain", fn().reshape(K * rows_w),
                ref.mds_decode_into_ref(w, parts, table, y_view()).transpose(0, 1).reshape(
                    K * rows_w), tol[torch.float32])
    names = list(composition)
    in_turns("mds_decode", composition, names + names[::-1])
    for c, k, m, r in [(4, 3, 5, 128), (6, 7, 10, 200), (1, 2, 2, 512), (3, 32, 32, 1000)]:
        w_r, y_r = randn(c, k, m), randn(c, m, r)
        compare(f"mds_decode {(c, k, m, r)}", ops.mds_decode(w_r, y_r),
                ref.mds_decode_ref(w_r, y_r), tol[torch.float32])
    # the table-addressed, strided entry at ragged r, with repeated rows
    for c, k, m, r, n_parts in [(7, 32, 32, 1001, 300), (3, 5, 7, 37, 9), (20, 10, 10, 2999, 200)]:
        w_r, p_r = randn(c, k, m), randn(n_parts, r)
        t_r = torch.randint(0, n_parts, (c, m), generator=gen, device=dev, dtype=torch.int32)
        got = torch.empty(k * c * r, device=dev)
        want = torch.empty(k * c * r, device=dev)
        ops.mds_decode_into(w_r, p_r, t_r, got.view(k, c, r).transpose(0, 1))
        ref.mds_decode_into_ref(w_r, p_r, t_r, want.view(k, c, r).transpose(0, 1))
        compare(f"mds_decode table-addressed {(c, k, m, r, n_parts)}", got, want,
                tol[torch.float32])
    del parts, gathered

    # lstm_cell: what the main path calls, one window of T = 32 steps over the
    # n workers with the trained params, through the sequence kernel
    params = load_params(device=dev)
    hid, out_dim = params.w_hh.shape[1], params.w_out.shape[0]
    seq_w = tuple(p.detach() for p in (params.w_ih, params.w_hh, params.b, params.w_out,
                                       params.b_out))
    wts = seq_w[:3]
    window = torch.as_tensor(controlled_traces(N, WINDOW, n_stragglers=2, seed=7),
                             dtype=torch.float32, device=dev)[:, :, None].contiguous()
    lstm = torch.nn.LSTM(1, hid, device=dev)
    cell = torch.nn.LSTMCell(1, hid, device=dev)
    with torch.no_grad():
        for mod, (w_ih, w_hh, b_ih, b_hh) in [
                (lstm, (lstm.weight_ih_l0, lstm.weight_hh_l0, lstm.bias_ih_l0, lstm.bias_hh_l0)),
                (cell, (cell.weight_ih, cell.weight_hh, cell.bias_ih, cell.bias_hh))]:
            w_ih.copy_(wts[0])
            w_hh.copy_(wts[1])
            b_ih.copy_(wts[2])
            b_hh.zero_()

    def lstm_and_head(xs_):
        return lstm(xs_)[0] @ seq_w[3].T + seq_w[4]

    with torch.no_grad():
        record("lstm_cell",
               lambda: ops.lstm_sequence(window, *seq_w),
               lambda: ref.lstm_sequence_ref(window, *seq_w),
               lambda: lstm_and_head(window),
               n_bytes=4 * (WINDOW * N + WINDOW * N * out_dim + 4 * hid + 4 * hid * hid
                            + 4 * hid + out_dim * hid + out_dim),
               flops=2 * WINDOW * N * (4 * hid * (1 + hid) + out_dim * hid), tol=1e-5,
               library_name="torch.nn.LSTM(1, 4) over the window, then the head's matmul "
                            "and add")
        records["lstm_cell"]["design"] = "sequence"
        compare("lstm_sequence vs torch.nn.LSTM and the head", ops.lstm_sequence(window, *seq_w),
                lstm_and_head(window), 1e-5)
        compare("lstm_sequence vs the per-step loop", ops.lstm_sequence(window, *seq_w),
                cell_loop(window, *seq_w), 1e-5)
        # the launch floor, and the per-step cell at its main shape
        one = torch.zeros(1, device=dev)
        floor = timed(lambda: one.add_(1))
        xs, hs, cs = randn(N, 1), randn(N, hid), randn(N, hid)
        compare("lstm_cell (main shape)", ops.lstm_cell(xs, hs, cs, *wts),
                ref.lstm_cell_ref(xs, hs, cs, *wts), 1e-5)
        compare("lstm_cell vs torch.nn.LSTMCell", ops.lstm_cell(xs, hs, cs, *wts),
                cell(xs, (hs, cs)), 1e-5)
        cell_t = timed(lambda: ops.lstm_cell(xs, hs, cs, *wts))
    records["lstm_cell"].update(launch_floor_device_ms=floor["device_ms"],
                                launch_floor_call_ms=floor["call_ms"],
                                cell_device_ms=cell_t["device_ms"],
                                cell_call_ms=cell_t["call_ms"])
    print(f"launch floor (a one-element in-place add): device ms {floor['device_ms']:.4f}, "
          f"call ms {floor['call_ms']:.4f}", flush=True)
    print(f"lstm_cell, the per-step cell at ({N}, 1, {hid}): device ms "
          f"{cell_t['device_ms']:.4f}, call ms {cell_t['call_ms']:.4f}", flush=True)
    for b_, i_, h_ in [(100, 3, 8), (7, 2, 16)]:
        args = (randn(b_, i_), randn(b_, h_), randn(b_, h_), randn(4 * h_, i_),
                randn(4 * h_, h_), randn(4 * h_))
        compare(f"lstm_cell {(b_, i_, h_)}", ops.lstm_cell(*args), ref.lstm_cell_ref(*args),
                1e-5)
    # the window at ragged shapes (T, B, I, H, O), weights at init_lstm's
    # 1/sqrt(H) scale: one step, 256 steps, 2,048 rows, xs staged in several
    # chunks, every register bucket, groups with idle lanes, the
    # shared-memory path (H > 8) with O = 4H
    for shape in [(1, N, 1, 4, 1), (256, N, 1, 4, 1), (32, 2048, 1, 4, 1), (10, 100, 3, 8, 2),
                  (7, 7, 2, 16, 1), (1000, 40, 1, 4, 1), (600, 9, 3, 16, 2), (9, 13, 1, 3, 2),
                  (4, 5, 1, 9, 36), (33, 5, 5, 32, 3)]:
        t_, b_, i_, h_, o_ = shape
        sc = h_ ** -0.5
        args = (randn(t_, b_, i_), randn(4 * h_, i_) * sc, randn(4 * h_, h_) * sc,
                randn(4 * h_) * sc, randn(o_, h_) * sc, randn(o_) * sc)
        compare(f"lstm_sequence {shape}", ops.lstm_sequence(*args),
                ref.lstm_sequence_ref(*args), 1e-5)
    # the window in turns: the sequence kernel, the per-step loop, nn.LSTM and head
    with torch.no_grad():
        versions = {
            "sequence kernel": lambda: ops.lstm_sequence(window, *seq_w),
            f"per-step loop ({WINDOW} x lstm_cell, head, stack)":
                lambda: cell_loop(window, *seq_w),
            "torch.nn.LSTM and the head": lambda: lstm_and_head(window),
        }
        in_turns("lstm_cell", versions, list(versions) + list(versions)[::-1])
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # -- 4. the main path at full size --------------------------------------
    a_full = torch.randn(ROWS, COLS, generator=torch.Generator(device=dev).manual_seed(1),
                         device=dev)
    code = MDSCode(N, K)
    cm = CodedMatvec(code, CHUNKS)
    predictor = SpeedPredictor(N, load_params())
    traces = controlled_traces(N, ITERS, n_stragglers=2, seed=7)
    x_gen = torch.Generator(device=dev).manual_seed(2)
    # the last prediction's 29-step window: the sequence kernel against
    # the per-step loop, once, before the counters are zeroed
    hist = torch.as_tensor(traces[:ITERS - 1], dtype=torch.float32, device=dev)
    compare(f"predictor on the {ITERS - 1}-step trace window: sequence kernel vs per-step loop",
            predict_next(predictor.params, hist),
            cell_loop(hist[:, :, None].contiguous(), *seq_w)[-1, :, 0], 1e-5)
    torch.cuda.reset_peak_memory_stats()

    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    coded = cm.shard(a_full)
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    a64 = a_full.double()
    iter_s, worst = [], 0.0
    phase_s = {"predict": [], "plan": [], "apply": []}
    for it in range(ITERS):
        x_it = torch.randn(COLS, generator=x_gen, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        speeds = predictor.predict()            # returns on the host: synchronised
        t1 = time.perf_counter()
        alloc = general_allocation(speeds, K, CHUNKS)
        tables = cm.plan_tables(alloc)
        t2 = time.perf_counter()
        y_it = cm.apply(coded, x_it, *tables)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        iter_s.append(t3 - t0)
        for name, dt in zip(phase_s, (t1 - t0, t2 - t1, t3 - t2)):
            phase_s[name].append(dt)
        if y_it.shape != (ROWS,) or not torch.isfinite(y_it).all():
            raise RuntimeError(f"iteration {it}: y has shape {tuple(y_it.shape)} "
                               "or non-finite values")
        want = a64 @ x_it.double()
        err = float((y_it.double() - want).abs().max() / want.abs().max())
        if err > REL_ERR_LIMIT:
            raise RuntimeError(f"iteration {it}: relative error {err:.3e} > {REL_ERR_LIMIT}")
        worst = max(worst, err)
        predictor.observe(traces[it])
    # encode again into the freed tensor's cached memory: the first encode
    # also pays for allocating the 5.9 GB of coded partitions
    del coded
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    coded = cm.shard(a_full)
    torch.cuda.synchronize()
    encode_again_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    designs = ops.design_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    print(f"main path: encode {encode_s * 1e3:.3f} ms (again, memory cached: "
          f"{encode_again_s * 1e3:.3f} ms); {ITERS} iterations, median "
          f"{statistics.median(iter_s) * 1e3:.3f} ms (min {min(iter_s) * 1e3:.3f}, max "
          f"{max(iter_s) * 1e3:.3f}); worst relative error {worst:.3e}; peak memory "
          f"{peak_gb:.1f} GB", flush=True)
    print("median per phase: " + ", ".join(
        f"{name} {statistics.median(v) * 1e3:.3f} ms" for name, v in phase_s.items()),
        flush=True)
    print(f"last allocation: counts {alloc.count.tolist()} from predicted speeds "
          f"{np.round(speeds, 3).tolist()}", flush=True)
    apply_less_matvec = (statistics.median(phase_s["apply"]) * 1e3
                         - records["coded_matvec"]["device_ms"])
    print(f"apply less coded_matvec's device time: {apply_less_matvec:.4f} ms", flush=True)
    print(f"launches on the main path: {counts}; by design: {designs}", flush=True)
    need = {"mds_encode": 1, "coded_matvec": ITERS, "mds_decode": ITERS}
    short = {k: (counts[k], v) for k, v in need.items() if counts[k] < v}
    if short:
        raise RuntimeError(f"the main path did not run through every kernel: {short}")
    if designs["coded_matvec"] != {"stream": counts["coded_matvec"], "general": 0}:
        raise RuntimeError(f"coded_matvec launches on the main path left the stream "
                           f"design: {designs['coded_matvec']}")
    # one sequence launch per prediction with history (iteration 0 has none)
    if designs["lstm_cell"] != {"sequence": ITERS - 1, "cell": 0}:
        raise RuntimeError(f"the predictor did not launch the sequence kernel once per "
                           f"prediction with history: {designs['lstm_cell']}")
    if counts["coded_matvec"] != ITERS or counts["mds_decode"] != ITERS:
        raise RuntimeError(f"apply launched coded_matvec {counts['coded_matvec']} and "
                           f"mds_decode {counts['mds_decode']} times in {ITERS} iterations")
    for name, rec in records.items():
        rec["launches"] = counts[name]
    del a_full, coded, a64
    torch.cuda.empty_cache()

    # -- 5. the cluster engine on the card ----------------------------------
    t0 = time.perf_counter()
    cluster_counts = cluster_phase(dev, call_ms, timed, compare, ROWS)
    print(f"cluster phase: {time.perf_counter() - t0:.1f} s", flush=True)
    for name, rec in records.items():
        rec["cluster_launches"] = cluster_counts.get(name, 0)

    print(json.dumps({"in_turns": turns, "apply_less_coded_matvec_ms": apply_less_matvec}))
    print(json.dumps({"kernels": [records[name] for name in KERNELS]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
