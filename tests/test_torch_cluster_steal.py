"""``tests/test_cluster_steal.py`` run against the port's cluster (``repro_torch.cluster``
and the port's ``core``), through :func:`_torch_mirror.mirror`: the
reference's own tests, on the CPU, with the reference's defaults
(float64 host compute).  A test is left out only where its outcome depends
on the clock; ``EXCLUDED`` gives each one's reason."""

from _torch_mirror import mirror

KEEP = [
    "TestRetractableDeque::test_retracted_chunks_are_never_computed",
    "TestRetractableDeque::test_retracting_every_queued_chunk_acks_once",
    "TestRetractableDeque::test_promote_round_reorders_queue",
    "TestRetractableDeque::test_retract_is_scoped_to_its_round",
    "TestStealCorrectness::test_steals_fire_under_backlog_and_decode_exactly",
    "TestStealCorrectness::test_stealing_on_off_bit_identical_under_forced_coverage",
    "TestStealCorrectness::test_steals_timeouts_and_cancel_acks_interleave_cleanly",
    "TestStealCorrectness::test_mds_never_steals",
    "TestWorkerCrash::test_backend_exception_is_reported_not_silent",
    "TestWorkerCrash::test_crash_mid_service_is_logged_and_survived",
    "TestXCacheLRU::test_alternating_vectors_both_stay_cached",
    "TestXCacheLRU::test_x_cache_is_lru_capped",
    "TestReplicatedLiveness::test_slow_but_alive_replicas_are_not_declared_unrecoverable",
]
EXCLUDED = {
    "TestReportWindow::test_idle_then_busy_service_reports_busy_window":
        "compares the report's window with durations measured with perf_counter and a sleep",
    "TestReportWindow::test_empty_service_falls_back_to_open_window":
        "asserts that the report's window spans a 0.05 s sleep",
}

mirror(globals(), "test_cluster_steal.py", KEEP, EXCLUDED)
