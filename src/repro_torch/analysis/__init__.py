"""s2c2lint — project static analysis for the S²C² cluster engine.

Run as ``python -m repro_torch.analysis [paths]`` (``scripts/s2c2lint.py``
runs the JAX package's copy).  Rules (see README "Static analysis &
concurrency contracts"):

* S2C201 guarded-by — ``# guarded_by:``-declared attributes accessed
  outside their lock / off their confining thread
* S2C202 lock-order-cycle — deadlock cycles in the nested-``with``
  acquisition graph (and same-lock re-acquisition)
* S2C203 blocking-under-lock — sleeps, socket/queue/Future blocking
  calls made while a lock is held
* S2C204 tracer-guard — tracer emissions not dominated by an
  ``if <tracer>.enabled:`` check (PR-6 overhead contract)
* S2C205 wire-protocol — frames/events missing from the WIRE_PROTOCOL
  registry, missing receive-side handlers, or a chaos protection set
  that diverges from the protocol table
"""

from .core import (Baseline, Finding, Project, RULE_REGISTRY, SourceFile,
                   load_project, render_json, render_line, run_rules)
from . import rules_concurrency, rules_protocol  # noqa: F401  (register)

__all__ = [
    "Baseline", "Finding", "Project", "RULE_REGISTRY", "SourceFile",
    "load_project", "render_json", "render_line", "run_rules", "analyze",
]


def analyze(paths, select=None):
    """Convenience one-shot: (findings, project). Paths may be files or
    directories."""
    project, errors = load_project(paths)
    findings = errors + run_rules(project, select=select)
    return findings, project
