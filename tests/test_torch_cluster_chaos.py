"""``tests/test_cluster_chaos.py`` run against the port's cluster (``repro_torch.cluster``
and the port's ``core``), through :func:`_torch_mirror.mirror`: the
reference's own tests, on the CPU, with the reference's defaults
(float64 host compute).  Every test is kept: none depends on the clock."""

from _torch_mirror import mirror

KEEP = [
    "test_chaos_run_completes_all_jobs_bit_correct",
]
EXCLUDED: dict = {}

mirror(globals(), "test_cluster_chaos.py", KEEP, EXCLUDED)
