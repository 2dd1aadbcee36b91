"""``tests/test_cluster_shm.py`` run against the port's cluster (``repro_torch.cluster``
and the port's ``core``), through :func:`_torch_mirror.mirror`: the
reference's own tests, on the CPU, with the reference's defaults
(float64 host compute).  Every test is kept: none depends on the clock."""

from _torch_mirror import mirror

KEEP = [
    "TestSegmentPool::test_share_attach_bit_identical",
    "TestSegmentPool::test_threshold_and_disabled_fall_back",
    "TestSegmentPool::test_retire_recycles_with_generation_bump",
    "TestSegmentPool::test_retired_tag_refuses_share_and_attach",
    "TestSegmentPool::test_release_names_unlinks_non_recycled",
    "TestSegmentPool::test_release_prefix_sweeps_one_workers_installs",
    "TestSegmentPool::test_close_then_sweep_reclaims_everything",
    "TestSegmentPool::test_attach_missing_segment_returns_none",
    "TestSegmentPool::test_tracer_annotations",
    "TestCodecOutOfBand::test_large_array_roundtrip_is_bitwise",
    "TestCodecOutOfBand::test_noncontiguous_and_scalar_payloads",
    "TestCodecOutOfBand::test_truncated_oob_frame_rejected",
    "TestShmTransport::test_shm_decode_bit_identical_to_inline",
    "TestShmTransport::test_shm_cuts_install_bytes_over_socket",
    "TestShmChaosLifecycle::test_sigkill_mid_round_leaves_no_segments",
    "TestShmChaosLifecycle::test_forced_conn_drop_reconnect_keeps_plane_consistent",
    "TestShmChaosLifecycle::test_partition_rejoin_leaves_no_segments",
    "TestShmChaosLifecycle::test_master_crash_recover_sweeps_orphans",
    "TestJournalCompaction::test_compacted_replay_resumes_identically",
    "TestJournalCompaction::test_floor_survives_full_retirement",
    "TestJournalCompaction::test_compaction_bounds_journal_size",
    "TestJournalCompaction::test_engine_hook_compacts_every_n_retires",
]
EXCLUDED: dict = {}

mirror(globals(), "test_cluster_shm.py", KEEP, EXCLUDED)
