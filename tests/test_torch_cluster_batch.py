"""``tests/test_cluster_batch.py`` run against the port's cluster (``repro_torch.cluster``
and the port's ``core``), through :func:`_torch_mirror.mirror`: the
reference's own tests, on the CPU, with the reference's defaults
(float64 host compute).  A test is left out only where its outcome depends
on the clock; ``EXCLUDED`` gives each one's reason."""

from _torch_mirror import mirror

KEEP = [
    "TestBatchedRounds::test_matmul_decodes_to_reference",
    "TestBatchedRounds::test_matvec_is_strictly_1d_and_matmul_strictly_2d",
    "TestBatchedRounds::test_batched_bit_identical_to_sequential_under_forced_coverage",
    "TestBatchedRounds::test_batched_waves_and_steals_interleave",
    "TestBatchedRounds::test_replicated_path_is_width_generic",
    "TestBatchedRounds::test_decode_compact_multi_rhs_matches_per_column",
    "TestStealSizing::test_bad_steal_sizing_rejected",
    "TestStealSizing::test_speed_sizing_steals_and_decodes_exactly",
    "TestXCacheKeying::test_small_operands_content_keyed_parity",
    "TestXCacheKeying::test_large_readonly_identity_keyed",
    "TestXCacheKeying::test_dead_identity_anchor_is_dropped_not_served",
    "TestXCacheKeying::test_large_writeable_bypasses_but_stays_fresh",
    "TestXCacheKeying::test_engine_snapshots_are_immutable",
    "TestCoalescer::test_compatible_jobs_merge_and_outputs_fan_out",
    "TestCoalescer::test_iterative_jobs_recoalesce_each_iteration",
    "TestCoalescer::test_max_batch_cap",
    "TestCoalescer::test_incompatible_requests_never_merge",
    "TestCoalescer::test_merged_round_failure_isolated_per_job",
    "TestCoalescer::test_matvec_job_self_batching",
]
EXCLUDED = {
    "TestBatchedRounds::test_virtual_time_scales_with_rhs_width":
        "asserts on two durations measured with perf_counter (t8 > 4 * t1)",
    "TestCoalescer::test_private_data_jobs_bypass_coalescer":
        "asserts that a drain took less than 0.5 s of wall time",
}

mirror(globals(), "test_cluster_batch.py", KEEP, EXCLUDED)
