"""``tests/test_cluster_obs.py`` run against the port's cluster (``repro_torch.cluster``
and the port's ``core``), through :func:`_torch_mirror.mirror`: the
reference's own tests, on the CPU, with the reference's defaults
(float64 host compute).  A test is left out only where its outcome depends
on the clock; ``EXCLUDED`` gives each one's reason."""

from _torch_mirror import mirror

KEEP = [
    "TestTracer::test_ring_buffer_keeps_newest",
    "TestTracer::test_disabled_emit_is_a_noop",
    "TestTracer::test_record_fields_and_args",
    "TestTracer::test_timestamps_are_monotonic_by_default",
    "TestTracer::test_clear",
    "TestTracer::test_capacity_validation",
    "TestTraceSchema::test_retracted_chunks_never_execute_after_retraction",
    "TestTraceSchema::test_round_phase_spans_cover_every_round",
    "TestTraceSchema::test_injected_and_observed_speeds_are_annotated",
    "TestTraceReportConsistency::test_multi_tenant_counts_match",
    "TestMetricsRegistry::test_counter_semantics",
    "TestMetricsRegistry::test_gauge_semantics",
    "TestMetricsRegistry::test_histogram_buckets_and_quantile",
    "TestMetricsRegistry::test_get_or_create_is_idempotent_and_conflict_checked",
    "TestMetricsRegistry::test_unlabeled_access_of_labeled_family_raises",
    "TestMetricsRegistry::test_prometheus_render_format",
    "TestMetricsRegistry::test_log_buckets_are_log_spaced",
    "TestJobMetricsRegression::test_unstamped_job_has_nan_not_negative_timings",
    "TestJobMetricsRegression::test_from_jobs_excludes_errored_jobs_from_percentiles",
    "TestJobMetricsRegression::test_half_stamped_job_clamps_to_zero_not_negative",
    "TestJobMetricsRegression::test_from_registry_bridges_service_totals",
    "TestLogging::test_component_loggers_are_children",
    "TestLogging::test_configure_logging_is_idempotent",
    "TestLogging::test_debug_logs_cross_reference_trace_records",
    "TestOverheadGuard::test_untraced_engine_emits_nothing",
    "TestOverheadGuard::test_tracer_can_be_toggled_mid_engine",
]
EXCLUDED = {
    "TestTraceSchema::test_forced_coverage_run_has_well_formed_spans":
        ("one of the JAX package's wall-clock flakes (ROADMAP.md §3, Reference caveats); it "
         "orders timestamps taken on two threads"),
    "TestTraceSchema::test_exported_json_is_valid_chrome_trace":
        "one of the JAX package's wall-clock flakes (ROADMAP.md §3, Reference caveats)",
}

mirror(globals(), "test_cluster_obs.py", KEEP, EXCLUDED)
