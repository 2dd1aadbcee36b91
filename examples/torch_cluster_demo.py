"""Quickstart for the PyTorch/CUDA port's concurrent coded-execution engine
(``repro_torch.cluster``), as ``cluster_demo.py`` is for the JAX package's.

Spins up an in-process 10-worker cluster with a trace-driven straggler
injector, runs the same PageRank power iteration under GeneralS2C2 and the
(n, k)-MDS baseline on real worker threads (chunk-level any-k collection,
§4.3 timeout/reassign), shows one multi-RHS batched round doing the work
of 8 matvec rounds, then pushes a small heterogeneous job mix through the
multi-tenant JobService, with concurrent tenants coalescing onto a shared
matrix, and prints the service report.

The workers compute their chunks through the port's ``coded_matvec``
kernel on ``--device`` (``kernel_backend``: a B = 1 round on the stream
design, the B = 8 round on the multi design), in float32; the master
plans each round from the trained LSTM predictor's forecast (§6.2, the
committed parameters, one ``lstm_sequence`` launch per round with
history), where the JAX package's demo leaves its engine to plan from
the last observed speeds, and decodes on the host in float64.
So the checks hold float32 products, not the float64 ones that the JAX
package's demo holds at 1e-8: each chunk's rows are float32 dot products
(a relative error of about 6e-8 per entry), and the decode multiplies
them by the inverse of a (k × k) submatrix of the code's generator, whose
condition number reaches 3.3e3 for this (10, 8) code: about 2e-4 of the
largest entry at worst (PageRank's result within 1.5e-4 on the CPU).
``REL_TOL`` is 1e-3 of the exact result's largest entry, the limit that
``chip_smoke.py``'s cluster phase holds every round to.

Run:  PYTHONPATH=src python examples/torch_cluster_demo.py [--device cpu]
      PYTHONPATH=src python examples/torch_cluster_demo.py --trace-out demo.json
      # then load demo.json in https://ui.perfetto.dev
"""

import argparse
import time

import numpy as np

from repro_torch.cluster import (ClusterConfig, CodedExecutionEngine, JobService,
                                 MatvecJob, PageRankJob, RegressionJob, TraceInjector,
                                 Tracer)
from repro_torch.convert import load_params
from repro_torch.core.predictor import SpeedPredictor
from repro_torch.core.strategies import GeneralS2C2, MDSCoded
from repro_torch.core.traces import controlled_traces

N_WORKERS, K, CHUNKS = 10, 8, 20
D = 2400
REL_TOL = 1e-3      # float32 chunks decoded in float64, of the exact result's largest entry


def make_stochastic(n: int, seed: int = 1) -> np.ndarray:
    rng = np.random.default_rng(seed)
    adj = (rng.random((n, n)) < 12.0 / n).astype(np.float64)
    col = adj.sum(0, keepdims=True)
    m = adj / np.maximum(col, 1)
    m[:, col[0] == 0] = 1.0 / n
    return m


def rel_err(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--trace-out", default=None,
                    help="export the whole demo as Chrome trace-event JSON "
                         "(load in Perfetto / chrome://tracing)")
    args = ap.parse_args(argv)
    m = make_stochastic(D)
    traces = controlled_traces(N_WORKERS, 60, n_stragglers=2, seed=7)
    eng = CodedExecutionEngine(
        ClusterConfig(n_workers=N_WORKERS, k=K, row_cost=5e-5),
        injector=TraceInjector(traces),
        tracer=Tracer() if args.trace_out else None, device=args.device,
        predictor=SpeedPredictor(N_WORKERS, load_params(device=args.device),
                                 device=args.device))
    try:
        data = eng.load_matrix(m, chunks=CHUNKS)
        r_ref = np.ones(D) / D
        for _ in range(15):
            r_ref = 0.15 / D + 0.85 * (m @ r_ref)

        print(f"{N_WORKERS}-worker engine on {eng.device}, (n,k)=({N_WORKERS},{K}), "
              f"2 injected 5x stragglers")
        for name, strat in (
                ("general-s2c2", GeneralS2C2(N_WORKERS, K, D, chunks=CHUNKS)),
                ("mds-baseline", MDSCoded(N_WORKERS, K, D))):
            r = np.ones(D) / D
            ms, waves, wasted = [], 0, 0.0
            for _ in range(15):
                out = eng.matvec(data, r, strat)
                r = 0.15 / D + 0.85 * out.y[:D]
                ms.append(out.metrics.makespan)
                waves += out.metrics.reassign_waves
                wasted += out.metrics.total_wasted
            err = rel_err(r, r_ref)
            print(f"  [{name}] mean_iter={np.mean(ms[1:]) * 1e3:6.1f}ms "
                  f"reassign_waves={waves} wasted_rows={wasted:8.0f} "
                  f"pagerank_rel_err={err:.2e}")
            assert err < REL_TOL

        # one multi-RHS batched round: 8 serving queries against the same
        # matrix as ONE (rows, 8) GEMM round instead of 8 GEMV rounds —
        # same coverage machinery, one set of dispatch/decode overheads
        rng = np.random.default_rng(0)
        xs = [rng.standard_normal(D) for _ in range(8)]
        t0 = time.perf_counter()
        for x in xs:
            eng.matvec(data, x, GeneralS2C2(N_WORKERS, K, D, chunks=CHUNKS))
        t_seq = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = eng.matmul(data, np.stack(xs, axis=1),
                         GeneralS2C2(N_WORKERS, K, D, chunks=CHUNKS))
        t_gemm = time.perf_counter() - t0
        err = rel_err(out.y, m @ np.stack(xs, axis=1))
        assert err < REL_TOL, err
        print(f"\nbatched round: 8 matvec rounds {t_seq * 1e3:.0f}ms vs one "
              f"B=8 GEMM round {t_gemm * 1e3:.0f}ms "
              f"({t_seq / max(t_gemm, 1e-9):.1f}x), rel_err={err:.2e}")

        # multi-tenant service: a burst of heterogeneous jobs; matvec
        # tenants share one matrix, so the coalescer merges their
        # concurrent rounds into multi-RHS batches
        svc = JobService(eng, max_queue=64, coalesce_hold_s=2e-3)
        try:
            a_shared = rng.standard_normal((480, 24))
            shared = svc.share_matrix(a_shared, chunks=8)
            # the shared-matrix tenants are admitted back-to-back so their
            # rounds overlap in the scheduler slots and can merge
            for i in range(8):
                svc.submit(MatvecJob(
                    a_shared, [rng.standard_normal(24) for _ in range(2)],
                    GeneralS2C2(N_WORKERS, K, 480, chunks=8),
                    chunks=8, data=shared))
            for i in range(16):
                strat = GeneralS2C2(N_WORKERS, K, 480, chunks=8)
                if i % 2 == 0:
                    svc.submit(PageRankJob(make_stochastic(480, seed=i),
                                           strat, iters=3, chunks=8))
                else:
                    a = rng.standard_normal((480, 12))
                    y = np.sign(a @ rng.standard_normal(12))
                    svc.submit(RegressionJob(a, y, strat, epochs=3, chunks=8))
            svc.drain(timeout=300)
            print("\nJobService report (24 heterogeneous jobs, shared-matrix "
                  "tenants coalesced):")
            print(svc.report().format())
        finally:
            svc.close()
    finally:
        eng.shutdown()
    if args.trace_out:
        n_events = eng.dump_trace(args.trace_out)
        print(f"\nwrote {args.trace_out} ({n_events} trace events) — "
              "load it in https://ui.perfetto.dev")
    print("OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
