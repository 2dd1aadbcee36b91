"""``tests/test_cluster_service.py`` run against the port's cluster (``repro_torch.cluster``
and the port's ``core``), through :func:`_torch_mirror.mirror`: the
reference's own tests, on the CPU, with the reference's defaults
(float64 host compute).  Every test is kept: none depends on the clock."""

from _torch_mirror import mirror

KEEP = [
    "TestServiceThroughput::test_sustains_100_plus_heterogeneous_jobs",
    "TestServiceThroughput::test_regression_job_learns",
    "TestBackpressure::test_bounded_queue_saturates",
    "TestBackpressure::test_job_error_is_isolated",
]
EXCLUDED: dict = {}

mirror(globals(), "test_cluster_service.py", KEEP, EXCLUDED)
