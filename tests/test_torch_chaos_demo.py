"""``scripts/torch_chaos_demo.py``, the port's chaos demo, on the CPU.

1. Each scenario (kill, partition, recover) at seed 0 with ``device="cpu"``
   at the reference script's own shapes: the workers are spawned processes
   computing through ``kernel_backend("cpu")`` (the ``coded_matvec``
   kernel's plain version, float32), the master decodes through
   ``mds_decode``'s plain version and plans with the LSTM; the scenario
   checks the reference's acceptance property and holds every ``y`` within
   1e-4 (relative) of a float64 product.
2. The chaos layer's decision streams are the JAX package's: for seeds 0-2,
   workers 0-5 and epochs 1-2, 200 draws of ``_Chaos._decide`` after
   ``reset_stream`` equal ``repro.cluster.transport._Chaos``'s for the same
   ``ChaosConfig`` (no clock involved).
3. ``device="cuda"`` with no card raises before any process is spawned.
4. A master that takes its time to resume a journaled round still gets
   the results an adopted child finished while it was down.
5. On the card (``cuda`` marker), the kill scenario at a small D.
"""

import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_cuda import cuda  # noqa: F401  (fixture)
from repro_torch.cluster.transport import ChaosConfig
from repro_torch.cluster.transport import _Chaos as PortChaos

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import chaos_demo as _demo  # noqa: E402


@pytest.mark.parametrize("scenario", ["kill", "partition", "recover"])
def test_scenario_meets_the_reference_property_on_the_cpu(scenario, tmp_path):
    demo = _demo()
    trace = tmp_path / "trace.json"
    out = demo.SCENARIOS[scenario](0, str(trace), 4, device="cpu")
    assert out["spec"] == "kernel:cpu"
    assert out["worst_rel_err"] <= demo.Y_RTOL
    assert out["trace_events"] > 0 and trace.exists()
    assert out["held"]["chunk_err"] == 0.0 and out["held"]["decode_err"] == 0.0
    assert out["shm_left"] == 0
    assert sum(out["children"]["chunk_spans_by_worker"].values()) > 0
    if scenario == "kill":
        assert any(w == 5 and src == "proc-exit" for _, w, src, _ in out["verdicts"])
        assert out["first_failover_s"] is not None
    elif scenario == "partition":
        assert out["credits"] >= 1 and out["rejoins"] >= 1
    else:
        assert out["journaled"] >= 1 and out["re_enqueued"]


class _Stub:
    """The attributes ``_Chaos`` reads from its transport at construction."""

    def __init__(self, n_workers: int, epoch: int):
        self.n_workers = n_workers
        self.epoch = epoch


CONFIGS = {
    "kill": dict(p_drop=0.02, p_delay=0.05, p_dup=0.02, kill_worker=5, kill_after_chunks=2),
    "all_faults": dict(p_drop=0.1, p_dup=0.1, p_delay=0.2, p_reorder=0.2,
                       delay_range=(0.001, 0.05), reorder_range=(0.002, 0.02)),
}


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chaos_decisions_match_the_jax_package(seed, config):
    from repro.cluster.transport import ChaosConfig as RefChaosConfig
    from repro.cluster.transport import _Chaos as RefChaos

    chaoses = [PortChaos(ChaosConfig(seed=seed, **CONFIGS[config]), _Stub(6, 1)),
               RefChaos(RefChaosConfig(seed=seed, **CONFIGS[config]), _Stub(6, 1))]
    try:
        actions = set()
        for epoch in (1, 2):
            for worker in range(6):
                streams = []
                for chaos in chaoses:
                    chaos.reset_stream(worker, epoch)
                    streams.append([chaos._decide(worker) for _ in range(200)])
                assert streams[0] == streams[1], (epoch, worker)
                actions.update(a for a, _ in streams[0])
        assert "pass" in actions and "drop" in actions
    finally:
        for chaos in chaoses:
            chaos.stop()


def test_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: device='cuda' is usable here")
    demo = _demo()
    for scenario in demo.SCENARIOS.values():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            scenario(0, str(tmp_path / "t.json"), 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        demo.main(["--scenario", "partition", "--trace-out", str(tmp_path / "t.json")])


def test_results_finished_while_the_master_was_down_reach_the_resumed_round(tmp_path):
    """The recover scenario's pool, with the master down for 1.5 s: worker 0
    (speed 0.08, 0.5 s a chunk) finishes its chunks meanwhile and replays
    them as soon as it reconnects, and the new master resumes the round
    0.5 s late.  The replays are marked seen by the transport, so a
    collector that dropped them (the round not yet registered) left the
    round to starve: the recomputed results were dropped as duplicates."""
    from repro_torch.cluster import (ClusterConfig, CodedExecutionEngine, EngineClosed,
                                     SocketTransport, TraceInjector)
    from repro_torch.cluster.worker import numpy_backend
    from repro_torch.core.strategies import GeneralS2C2

    class LateResume(CodedExecutionEngine):
        def _resume_round(self, *args, **kw):
            time.sleep(0.5)
            return super()._resume_round(*args, **kw)

    def transport():
        return SocketTransport(hb_interval=0.05, hb_miss=4, dead_after=2, connect_timeout=60.0,
                               reconnect_backoff=0.05, reconnect_tries=10)

    n = k = 3
    rng = np.random.default_rng(7)
    a, x = rng.standard_normal((48, 24)), rng.standard_normal(24)
    speeds = TraceInjector(np.array([[0.08, 1.0, 1.0]]))
    cfg = ClusterConfig(n_workers=n, k=k, row_cost=5e-3, starvation_timeout=5.0,
                        journal_dir=str(tmp_path))
    eng = CodedExecutionEngine(cfg, speeds, compute=numpy_backend, transport=transport(),
                               device="cpu")
    eng2 = None
    try:
        data = eng.load_matrix(a, chunks=2)
        h = eng.matvec_async(data, x, GeneralS2C2(n, k, 48, chunks=2))
        deadline = time.monotonic() + 30.0
        while (eng.registry.value("s2c2_journal_records_total") < 3 + 4
               and time.monotonic() < deadline):
            time.sleep(0.02)
        procs = eng.transport.procs
        eng.crash()
        with pytest.raises(EngineClosed):
            h.result(timeout=10.0)
        time.sleep(1.5)
        eng2 = LateResume.recover(cfg, speeds, compute=numpy_backend, transport=transport(),
                                  procs=procs, device="cpu")
        (handle,) = eng2.recovered.values()
        np.testing.assert_allclose(handle.result(timeout=30.0).y, a @ x, rtol=1e-9)
    finally:
        eng.shutdown()
        if eng2 is not None:
            eng2.shutdown()


@pytest.mark.cuda
def test_kill_scenario_on_the_card_at_a_small_d(cuda, tmp_path):
    demo = _demo()
    out = demo.SCENARIOS["kill"](0, str(tmp_path / "t.json"), 4, device=cuda, rows=1_200)
    assert out["spec"].startswith("kernel:cuda:")
    assert out["mem_regained"] >= 1_200 * demo.COLS * 4
    assert out["launches"]["mds_decode"] == out["rounds"]
