"""``tests/test_cluster_transport.py`` run against the port's cluster (``repro_torch.cluster``
and the port's ``core``), through :func:`_torch_mirror.mirror`: the
reference's own tests, on the CPU, with the reference's defaults
(float64 host compute).  Every test is kept: none depends on the clock."""

from _torch_mirror import mirror

KEEP = [
    "TestFrameCodec::test_roundtrip_is_bitwise",
    "TestFrameCodec::test_short_buffers_rejected",
    "TestFrameCodec::test_back_to_back_frames",
    "TestChaosConfigValidation::test_out_of_range_probability_rejected",
    "TestChaosConfigValidation::test_bad_delay_range_rejected",
    "TestSocketTransport::test_proc_pool_matches_reference_and_exports_metrics",
    "TestSocketTransport::test_sigkill_mid_round_fails_over_and_completes",
    "TestSocketTransport::test_injected_failstop_silences_heartbeats_remotely",
    "TestSocketTransport::test_forced_conn_drop_reconnects",
]
EXCLUDED: dict = {}

mirror(globals(), "test_cluster_transport.py", KEEP, EXCLUDED)
