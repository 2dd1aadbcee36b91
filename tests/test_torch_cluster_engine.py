"""``tests/test_cluster.py`` run against the port's cluster (``repro_torch.cluster``
and the port's ``core``), through :func:`_torch_mirror.mirror`: the
reference's own tests, on the CPU, with the reference's defaults
(float64 host compute).  A test is left out only where its outcome depends
on the clock; ``EXCLUDED`` gives each one's reason."""

from _torch_mirror import mirror

KEEP = [
    "TestInjectors::test_trace_injector_clamps_iterations",
    "TestInjectors::test_bursty_deterministic_and_bounded",
    "TestInjectors::test_failstop_permanent",
    "TestExactDecode::test_decode_matches_reference",
    "TestExactDecode::test_kernel_backend_decodes_exactly",
    "TestExactDecode::test_multi_tenant_shards_are_independent",
    "TestTimeoutReassign::test_mds_baseline_never_reassigns",
    "TestAdaptation::test_bursty_injector_rounds_all_decode",
]
EXCLUDED = {
    "TestTimeoutReassign::test_sudden_slowdown_triggers_wave_and_still_decodes":
        ("one of the JAX package's wall-clock flakes (ROADMAP.md §3, Reference caveats); it also"
         " asserts on a speed the engine measured with the clock"),
    "TestTimeoutReassign::test_failstop_worker_detected_and_planned_around":
        "one of the JAX package's wall-clock flakes (ROADMAP.md §3, Reference caveats)",
    "TestAdaptation::test_allocation_tracks_measured_straggler":
        ("asserts on the predicted speeds, which the engine measures from response times on the "
         "clock"),
    "TestAdaptation::test_wasted_work_general_below_mds":
        ("compares wasted rows, the rows a worker computed before its cancel arrived: elapsed "
         "time times speed"),
    "TestExecutedVsSimulated::test_latency_ordering_matches_simulator":
        ("one of the JAX package's wall-clock flakes (ROADMAP.md §3, Reference caveats); it "
         "compares makespans measured on the clock"),
}

mirror(globals(), "test_cluster.py", KEEP, EXCLUDED)
