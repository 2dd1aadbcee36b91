"""Run one of the JAX package's cluster test files against the port's cluster.

A mirror file is three statements::

    from _torch_mirror import mirror
    KEEP = [...]                 # "Class::test" or "test", as in the reference
    EXCLUDED = {...: "reason"}   # every other test of the reference
    mirror(globals(), "test_cluster_batch.py", KEEP, EXCLUDED)

:func:`mirror` reads ``tests/<reference>``, rewrites ``repro.`` to
``repro_torch.`` (imports, the module paths the tests patch, the logger
names they read), compiles it with pytest's assertion rewriting under the
reference's own file name, so a failure points at the reference's line,
and runs it in the mirror module's namespace.  The mirrored tests are the
reference's text.  ``KEEP`` and ``EXCLUDED`` must together name every test
of the reference exactly once; the excluded ones are removed.

The port's cluster runs on the card unless the caller asks for the CPU,
and its default compute is the float32 ``coded_matvec`` kernel, where the
reference's default is float64 BLAS on the host (``ROADMAP.md`` §3,
"Deliberate differences").  The reference's tests call with the defaults
and hold float64 results at 1e-9, so for the whole mirror module the
port's defaults are set to what the reference's defaults mean
(:func:`reference_defaults`): ``device="cpu"`` wherever the port takes a
device, and ``numpy_backend`` where the engine or a ``Worker`` is given no
compute.  A test that passes ``kernel_backend()`` gets the port's kernel on
the CPU, its plain version, as the reference's gets Pallas in interpret
mode.  The kernel default stays covered by ``tests/test_torch_cluster.py``.
"""

from __future__ import annotations

import ast
import inspect
import re
from pathlib import Path

import pytest

TESTS = Path(__file__).resolve().parent


def _source(reference: str):
    path = TESTS / reference
    text = re.sub(r"\brepro\.", "repro_torch.", path.read_text())
    tree = ast.parse(text, filename=str(path))
    try:
        from _pytest.assertion.rewrite import rewrite_asserts
        rewrite_asserts(tree, text.encode(), str(path))
    except ImportError:           # plain asserts still fail, with less detail
        pass
    return compile(tree, str(path), "exec")


def _tests(ns: dict) -> list:
    names = []
    for name, obj in list(ns.items()):
        if name.startswith("test") and inspect.isfunction(obj):
            names.append(name)
        elif name.startswith("Test") and inspect.isclass(obj):
            names += [f"{name}::{m}" for m in vars(obj) if m.startswith("test")]
    return names


def _defaults(fn, **values):
    """``fn``'s ``(__defaults__, __kwdefaults__)`` with ``values`` as the
    defaults of the parameters they name."""
    params = list(inspect.signature(fn).parameters.values())
    missing = set(values) - {p.name for p in params}
    assert not missing, (fn, missing)
    positional = tuple(values.get(p.name, p.default) for p in params
                       if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
                       and p.default is not p.empty)
    keyword = {p.name: values.get(p.name, p.default) for p in params
               if p.kind is p.KEYWORD_ONLY and p.default is not p.empty}
    return positional or None, keyword or None


def reference_defaults():
    """(function, parameter defaults) pairs that make the port's cluster
    take the reference's defaults: the CPU and float64 host compute."""
    from repro_torch.cluster import data, master, worker

    engine = master.CodedExecutionEngine
    return [
        (engine.__init__, dict(compute=worker.numpy_backend, device="cpu")),
        (engine.recover.__func__, dict(compute=worker.numpy_backend, device="cpu")),
        (worker.Worker.__init__, dict(compute=worker.numpy_backend)),
        (worker.KernelBackend.__init__, dict(device="cpu")),
        (worker.kernel_backend, dict(device="cpu")),
        (data.CodedData.decode, dict(device="cpu")),
        (data.CodedData.decode_compact, dict(device="cpu")),
    ]


@pytest.fixture(scope="module", autouse=True)
def _reference_defaults():
    with pytest.MonkeyPatch.context() as mp:
        for fn, values in reference_defaults():
            positional, keyword = _defaults(fn, **values)
            mp.setattr(fn, "__defaults__", positional)
            mp.setattr(fn, "__kwdefaults__", keyword)
        yield


def mirror(ns: dict, reference: str, keep, excluded: dict) -> None:
    """Run ``tests/<reference>`` against the port in the namespace ``ns``
    (a mirror module's ``globals()``), keeping the tests ``keep`` names and
    removing those ``excluded`` names."""
    doc = ns.get("__doc__")
    exec(_source(reference), ns)
    ns["__doc__"] = doc
    found = _tests(ns)
    both = set(keep) & set(excluded)
    named = list(keep) + list(excluded)
    assert not both, f"{reference}: kept and excluded: {sorted(both)}"
    assert sorted(named) == sorted(found), (
        f"{reference}: not named {sorted(set(found) - set(named))}, "
        f"not in the reference {sorted(set(named) - set(found))}")
    for name in excluded:
        cls, _, test = name.rpartition("::")
        if cls:
            delattr(ns[cls], test)
        else:
            del ns[name]
    ns["_reference_defaults"] = _reference_defaults
