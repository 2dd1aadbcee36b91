"""``tests/test_cluster_contracts.py`` run against the port's cluster (``repro_torch.cluster``
and the port's ``core``), through :func:`_torch_mirror.mirror`: the
reference's own tests, on the CPU, with the reference's defaults
(float64 host compute).  Every test is kept: none depends on the clock."""

from _torch_mirror import mirror

KEEP = [
    "TestPromoteRoundLocking::test_backlog_read_holds_endpoint_lock",
    "TestPromoteRoundLocking::test_unknown_round_backlog_defaults_to_zero",
    "TestIterationSnapshotPerRound::test_every_dispatch_in_a_round_sees_one_iteration",
    "TestServiceCloseUnderLoad::test_every_handle_resolves_when_closed_midstream",
]
EXCLUDED: dict = {}

mirror(globals(), "test_cluster_contracts.py", KEEP, EXCLUDED)
