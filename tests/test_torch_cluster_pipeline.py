"""``tests/test_cluster_pipeline.py`` run against the port's cluster (``repro_torch.cluster``
and the port's ``core``), through :func:`_torch_mirror.mirror`: the
reference's own tests, on the CPU, with the reference's defaults
(float64 host compute).  A test is left out only where its outcome depends
on the clock; ``EXCLUDED`` gives each one's reason."""

from _torch_mirror import mirror

KEEP = [
    "TestAsyncRounds::test_two_tenants_overlap_and_decode_exactly",
    "TestAsyncRounds::test_reassign_in_one_round_while_other_collects",
    "TestAsyncRounds::test_stale_cancel_ack_is_dropped_not_misrouted",
    "TestAsyncRounds::test_busy_worker_is_not_fail_stop_detected",
    "TestServiceOverlap::test_multi_slot_scheduler_overlaps_jobs",
    "TestServiceOverlap::test_max_inflight_one_still_serializes",
    "TestServiceOverlap::test_bad_max_inflight_rejected",
    "TestDecodeCache::test_decode_matrix_solve_matches_inv",
    "TestDecodeCache::test_cached_weights_bit_identical_and_hit",
    "TestDecodeCache::test_compact_weights_consistent_with_full",
    "TestDecodeCache::test_decode_bit_stable_for_repeated_coverage",
    "TestKernelBackendCache::test_shard_cache_populates_and_evicts",
    "TestKernelBackendCache::test_inplace_mutated_x_is_not_served_stale",
    "TestKernelBackendCache::test_row_bucketing_handles_odd_chunk_sizes",
]
EXCLUDED = {
    "TestAsyncRounds::test_matvec_async_returns_immediately_and_is_exact":
        "asserts that a submission took less than half of the round's measured makespan",
    "TestAsyncRounds::test_undecodable_round_starves_with_error_not_hang":
        "asserts that the starvation error came within 10 s of wall time",
    "TestAsyncRounds::test_undecodable_round_starves_even_while_engine_busy":
        "asserts that the starvation error came within 20 s of wall time",
}

mirror(globals(), "test_cluster_pipeline.py", KEEP, EXCLUDED)
