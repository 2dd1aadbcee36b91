"""In-process concurrent coded-execution engine (the paper's master/worker
runtime made real).

``repro_torch.core`` holds the *policies* (Algorithm 1 allocation, timeout rule,
speed prediction) and ``repro_torch.core.simulation`` evaluates them against a
closed-form time model.  This package executes them: N worker threads each
hold an MDS-coded partition and really compute their assigned chunks, a
master collects completion *events* (out of order, any-k per chunk index),
fires the §4.3 timeout/reassign path on mispredictions, and decodes.
Rounds are keyed by ``round_id`` and pipelined: ``matvec_async`` returns a
``RoundHandle`` immediately and independent rounds (same or different
tenants) share the worker pool chunk-by-chunk.  Rounds are multi-RHS
generic: ``matmul_async`` runs ``A @ X`` for an ``(d, B)`` block — each
chunk is one BLAS-3 GEMM pass over the shard and one decode contraction
covers all B columns — with ``matvec_async`` the B=1 special case.  A
``JobService`` front end multiplexes concurrent heterogeneous jobs over
one engine through ``max_inflight`` scheduler slots with per-job
latency/waste/throughput accounting, and its ``RoundCoalescer`` merges
compatible concurrent requests against ``share_matrix`` data into batched
rounds.

By default the workers compute through the port's ``coded_matvec``
kernel (``kernel_backend(device)``, shards resident on the device) and
``ClusterConfig(decode_with_kernel=True)`` decodes through ``mds_decode``;
the engine's device (the default backend's, the default predictor's and
the kernel decode's) is the card unless the caller passes ``device="cpu"``.
``compute=worker.numpy_backend`` computes chunks in float64 on the host instead.

Quickstart::

    from repro_torch.cluster import (ClusterConfig, CodedExecutionEngine,
                                     TraceInjector)
    from repro_torch.core.strategies import GeneralS2C2
    from repro_torch.core.traces import controlled_traces

    traces = controlled_traces(12, 50, n_stragglers=2)
    eng = CodedExecutionEngine(ClusterConfig(n_workers=12, k=10, decode_with_kernel=True),
                               injector=TraceInjector(traces))
    data = eng.load_matrix(a)                      # MDS-encode once
    y = eng.matvec(data, x, GeneralS2C2(12, 10, a.shape[0], chunks=20))
    eng.shutdown()
"""

from repro_torch.cluster.data import CodedData, ReplicatedData, replica_placement
from repro_torch.cluster.injectors import (BurstyInjector, FailStopInjector,
                                           NoSlowdown, SlowdownInjector,
                                           TracedInjector, TraceInjector)
from repro_torch.cluster.journal import JournalState, RoundJournal
from repro_torch.cluster.master import (ClusterConfig, CodedExecutionEngine,
                                        EngineClosed, RoundHandle, RoundOutput)
from repro_torch.cluster.metrics import JobMetrics, RoundMetrics, ServiceReport
from repro_torch.cluster.obs import (Counter, Gauge, Histogram, MetricsRegistry,
                                     TraceRecord, Tracer, chrome_trace_events,
                                     configure_logging, export_chrome_trace)
from repro_torch.cluster.service import (AdmissionTimeout, JobService, MatvecJob,
                                         PageRankJob, RegressionJob,
                                         RoundCoalescer, ServiceSaturated)
from repro_torch.cluster.transport import (ChaosConfig, FaultyTransport,
                                           InProcTransport, SocketTransport,
                                           Transport)
from repro_torch.cluster.worker import (ChunkDone, KernelBackend, Worker,
                                        WorkerDone, WorkerFailed, WorkerRejoined,
                                        kernel_backend, shard_digest)

__all__ = [
    "BurstyInjector", "FailStopInjector", "NoSlowdown", "SlowdownInjector",
    "TraceInjector", "TracedInjector",
    "ChunkDone", "KernelBackend", "Worker", "WorkerDone", "WorkerFailed",
    "WorkerRejoined", "kernel_backend", "shard_digest",
    "CodedData", "ReplicatedData", "replica_placement",
    "ClusterConfig", "CodedExecutionEngine", "RoundHandle", "RoundOutput",
    "RoundMetrics", "JobMetrics", "ServiceReport",
    "JobService", "MatvecJob", "PageRankJob", "RegressionJob",
    "RoundCoalescer", "ServiceSaturated", "AdmissionTimeout", "EngineClosed",
    "Transport", "InProcTransport", "SocketTransport", "FaultyTransport",
    "ChaosConfig", "RoundJournal", "JournalState",
    "Tracer", "TraceRecord", "MetricsRegistry",
    "Counter", "Gauge", "Histogram",
    "chrome_trace_events", "export_chrome_trace", "configure_logging",
]
