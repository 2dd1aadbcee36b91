"""``tests/test_cluster_robustness.py`` run against the port's cluster (``repro_torch.cluster``
and the port's ``core``), through :func:`_torch_mirror.mirror`: the
reference's own tests, on the CPU, with the reference's defaults
(float64 host compute).  A test is left out only where its outcome depends
on the clock; ``EXCLUDED`` gives each one's reason."""

from _torch_mirror import mirror

KEEP = [
    "TestEngineClose::test_double_shutdown_is_noop",
    "TestEngineClose::test_submit_after_close_raises",
    "TestEngineClose::test_close_under_load_resolves_inflight_handles",
    "TestServiceClose::test_double_close_is_noop",
    "TestServiceClose::test_submit_after_close_raises",
    "TestServiceClose::test_close_under_load_resolves_every_handle",
    "TestCoalescedFailover::test_worker_crash_inside_merged_round_resolves_all_participants",
]
EXCLUDED = {
    "TestAdmissionTimeout::test_saturation_raises_typed_timeout_and_counts_rejection":
        "asserts that a blocking submit waited at least 0.04 s of wall time",
}

mirror(globals(), "test_cluster_robustness.py", KEEP, EXCLUDED)
