"""``tests/test_cluster_recovery.py`` run against the port's cluster (``repro_torch.cluster``
and the port's ``core``), through :func:`_torch_mirror.mirror`: the
reference's own tests, on the CPU, with the reference's defaults
(float64 host compute).  A test is left out only where its outcome depends
on the clock; ``EXCLUDED`` gives each one's reason."""

from _torch_mirror import mirror

KEEP = [
    "TestRoundJournal::test_roundtrip_all_kinds",
    "TestRoundJournal::test_torn_final_line_tolerated",
    "TestRoundJournal::test_unregistered_kind_rejected",
    "TestRoundJournal::test_array_codec_roundtrips_exactly",
    "TestEpochFencing::test_master_rejects_stale_event",
    "TestEpochFencing::test_master_rejects_stale_heartbeat",
    "TestEpochFencing::test_chunk_dedup_across_epoch_boundary",
    "TestEpochFencing::test_child_drops_stale_submit_without_ack",
    "TestEpochFencing::test_child_epoch_adoption_resets_task_dedup",
    "TestMasterRecovery::test_crash_recover_zero_recompute_bit_identical",
    "TestServiceRecovery::test_admitted_never_planned_job_is_resubmitted",
    "TestPartitionHeal::test_partition_credit_and_rejoin",
]
EXCLUDED = {
    "TestServiceRecovery::test_crashed_job_resubmitted_resolves_via_replay_cache":
        "one of the JAX package's wall-clock flakes (ROADMAP.md §3, Reference caveats)",
}

mirror(globals(), "test_cluster_recovery.py", KEEP, EXCLUDED)
