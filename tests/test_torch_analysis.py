"""The port's static analyser (``repro_torch.analysis``) against the JAX
package's (``repro.analysis``), of which it is a copy.

* Every test of ``tests/test_analysis.py`` runs with its module's
  ``analyze`` and ``main`` replaced by twins that run both analysers on
  the same fixture sources and require the same findings (path, line,
  rule, message) and the same exit codes; the reference's own assertions
  then run on the reference's results.
* Both analysers over both cluster trees give the same findings, none.
* ``python -m repro_torch.analysis`` analyses the port's cluster by
  default: 0 findings in its 11 files.
"""

import inspect
import os
import subprocess
import sys
from pathlib import Path

import pytest

import test_analysis as REF
from repro.analysis import analyze as ref_analyze
from repro.analysis.__main__ import main as ref_main
from repro_torch.analysis import analyze
from repro_torch.analysis.__main__ import main

ROOT = Path(__file__).resolve().parents[1]


def _key(findings) -> list:
    return [(f.path, f.line, f.rule, f.message) for f in findings]


def _both_analyze(paths, select=None):
    want, project = ref_analyze(paths, select=select)
    got, _ = analyze(paths, select=select)
    assert _key(got) == _key(want)
    return want, project


def _both_main(argv=None):
    code = ref_main(argv)
    assert main(argv) == code
    return code


REF_TESTS = [(cls, name) for cls_name, cls in inspect.getmembers(REF, inspect.isclass)
             if cls_name.startswith("Test")
             for name, _ in inspect.getmembers(cls, inspect.isfunction)
             if name.startswith("test_")]


@pytest.mark.parametrize("cls,name", REF_TESTS,
                         ids=[f"{c.__name__}.{n}" for c, n in REF_TESTS])
def test_reference_fixtures_give_the_same_findings(cls, name, request, monkeypatch):
    monkeypatch.setattr(REF, "analyze", _both_analyze)
    monkeypatch.setattr(REF, "main", _both_main)
    method = getattr(cls(), name)
    method(**{p: request.getfixturevalue(p) for p in inspect.signature(method).parameters})


@pytest.mark.parametrize("tree", ["src/repro/cluster", "src/repro_torch/cluster"])
def test_cluster_trees_give_the_same_findings(tree):
    findings, project = _both_analyze([str(ROOT / tree)])
    assert findings == []
    assert len(project.files) == 11


def test_module_runs_on_the_port_cluster_by_default():
    out = subprocess.run([sys.executable, "-m", "repro_torch.analysis"], capture_output=True,
                         text=True, cwd=ROOT, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stdout + out.stderr
    assert "0 finding(s) in 11 file(s)" in out.stderr
