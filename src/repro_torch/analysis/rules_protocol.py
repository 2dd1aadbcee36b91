"""Tracer-guard and wire-protocol rules.

S2C204 enforces the PR-6 overhead contract: with tracing off, a call
site costs exactly one attribute read — so every ``<tracer>.emit(...)``
outside ``obs.py`` must be lexically dominated by an
``if <tracer>.enabled:`` test.  The hot-loop alias form

    if self.tracer.enabled:
        emit = self.tracer.emit
        ...
        emit(...)

is tracked: a name bound from ``<tracer>.emit`` inherits the emission
obligation, and the binding site itself must sit under the guard.

S2C205 cross-checks the wire protocol: ``transport.py`` owns a
``WIRE_PROTOCOL`` registry (frame class -> ``WireSpec(direction,
protected)``); every frame dataclass sent anywhere in ``transport.py``
must be registered, every registered frame must have an ``isinstance``
dispatch on its receiving side (child-side classes are those named like
``*Child*``/``*Node*``; everything else plus ``master.py`` is the master
side), ``_PROTECTED`` must be *derived* from the registry (a hand-listed
tuple can silently diverge from it — the chaos plane reads
``_PROTECTED`` to decide which frames it may drop), and the chaos
transport must actually consult it.  Worker event dataclasses (anything
``.put(...)`` onto the event queue in ``worker.py``) must have an
``isinstance`` handler in ``master.py``.

Two further cross-checks ride on S2C205:

* **Fenced frames.**  A frame registered ``fenced=True`` carries the
  epoch fencing token: its dataclass must declare an ``epoch`` field,
  and every receiving side's handler function must contain an epoch
  comparison (an ``ast.Compare`` touching a ``.epoch`` attribute) — a
  fenced frame accepted without checking its token reopens the
  split-brain window the epochs exist to close.

* **Journal kinds.**  ``journal.py`` owns a ``JOURNAL_KINDS`` registry
  mirroring ``WIRE_PROTOCOL``: every ``append_record("<kind>", ...)``
  / ``_journal("<kind>", ...)`` call site anywhere in the package must
  use a registered kind, and every registered kind must be folded by
  ``RoundJournal.replay`` — an unfolded kind silently drops durable
  state on recovery.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from .core import Finding, Project, SourceFile, register_rule
from .rules_concurrency import iter_functions

__all__ = ["TracerGuardRule", "WireProtocolRule"]


def _is_tracer_expr(expr: ast.AST) -> bool:
    """``self.tracer`` / ``t.tracer`` / bare ``tracer``."""
    if isinstance(expr, ast.Attribute):
        return "tracer" in expr.attr.lower()
    if isinstance(expr, ast.Name):
        return "tracer" in expr.id.lower()
    return False


def _test_reads_enabled(test: ast.AST) -> bool:
    return any(isinstance(n, ast.Attribute) and n.attr == "enabled"
               for n in ast.walk(test))


@register_rule
class TracerGuardRule:
    rule_id = "S2C204"
    name = "tracer-guard"

    EXEMPT_BASENAMES = {"obs.py"}

    def run(self, project: Project) -> List[Finding]:
        findings: List[Finding] = []
        for src in project.files:
            base = src.path.rsplit("/", 1)[-1]
            if base in self.EXEMPT_BASENAMES:
                continue
            for _cls, fn in iter_functions(src):
                findings.extend(self._check_function(src, fn))
        return findings

    def _check_function(self, src: SourceFile,
                        fn: ast.FunctionDef) -> List[Finding]:
        findings: List[Finding] = []
        aliases: Set[str] = set()

        def visit(node: ast.AST, guarded: bool) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                return  # nested defs run later; checked on their own
            if isinstance(node, ast.If):
                visit(node.test, guarded)
                body_guarded = guarded or _test_reads_enabled(node.test)
                for stmt in node.body:
                    visit(stmt, body_guarded)
                for stmt in node.orelse:
                    visit(stmt, guarded)
                return
            if isinstance(node, ast.IfExp):
                visit(node.test, guarded)
                body_guarded = guarded or _test_reads_enabled(node.test)
                visit(node.body, body_guarded)
                visit(node.orelse, guarded)
                return
            if isinstance(node, ast.Assign) and \
                    isinstance(node.value, ast.Attribute) and \
                    node.value.attr == "emit" and \
                    _is_tracer_expr(node.value.value):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        aliases.add(t.id)
                if not guarded:
                    findings.append(self._finding(
                        src, node.lineno, fn.name, "binding of tracer.emit"))
                return
            if isinstance(node, ast.Call):
                label = self._emission(node, aliases)
                if label is not None and not guarded:
                    findings.append(self._finding(
                        src, node.lineno, fn.name, label))
            for child in ast.iter_child_nodes(node):
                visit(child, guarded)

        for stmt in fn.body:
            visit(stmt, False)
        return findings

    @staticmethod
    def _emission(node: ast.Call, aliases: Set[str]) -> Optional[str]:
        func = node.func
        if isinstance(func, ast.Attribute) and func.attr == "emit" and \
                _is_tracer_expr(func.value):
            return "tracer.emit call"
        if isinstance(func, ast.Name) and func.id in aliases:
            return f"call through tracer.emit alias '{func.id}'"
        return None

    @staticmethod
    def _finding(src: SourceFile, line: int, fn_name: str,
                 what: str) -> Finding:
        return Finding(
            "S2C204", src.path, line,
            f"{what} in '{fn_name}' not dominated by an "
            f"'if <tracer>.enabled:' guard (PR-6 overhead contract)")


# -- wire protocol ----------------------------------------------------------

def _dataclass_names(src: SourceFile) -> Dict[str, int]:
    """Names (and lines) of dataclass-decorated classes in a module."""
    out: Dict[str, int] = {}
    for node in ast.walk(src.tree):
        if not isinstance(node, ast.ClassDef):
            continue
        for dec in node.decorator_list:
            target = dec.func if isinstance(dec, ast.Call) else dec
            name = target.attr if isinstance(target, ast.Attribute) else \
                target.id if isinstance(target, ast.Name) else ""
            if name == "dataclass":
                out[node.name] = node.lineno
    return out


def _isinstance_targets(tree: ast.AST) -> Set[str]:
    """Class names appearing as the second arg of isinstance() calls."""
    out: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Name) and \
                node.func.id == "isinstance" and len(node.args) == 2:
            t = node.args[1]
            elts = t.elts if isinstance(t, ast.Tuple) else [t]
            for e in elts:
                if isinstance(e, ast.Name):
                    out.add(e.id)
    return out


def _instantiations_under_send(tree: ast.AST,
                               class_names: Set[str]) -> Dict[str, int]:
    """Frame classes constructed inside the argument list of a send-ish
    call (``self._send(_Promote(rid))``), or assigned then (potentially)
    sent — any construction of a frame class counts as "sent"."""
    out: Dict[str, int] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Name) and \
                node.func.id in class_names:
            out.setdefault(node.func.id, node.lineno)
    return out


@register_rule
class WireProtocolRule:
    rule_id = "S2C205"
    name = "wire-protocol"

    def run(self, project: Project) -> List[Finding]:
        transport = project.file_named("transport.py")
        if transport is None:
            return []
        findings: List[Finding] = []
        registry, reg_line = self._parse_registry(transport)
        if registry is None:
            findings.append(Finding(
                "S2C205", transport.path, 1,
                "transport.py defines no WIRE_PROTOCOL registry "
                "(dict literal: frame class -> WireSpec)"))
            return findings

        frame_classes = {
            name: line for name, line in _dataclass_names(transport).items()
            if name.startswith("_")
            and not transport.is_ignored("S2C205", line)}
        sent = _instantiations_under_send(transport.tree,
                                          set(frame_classes))

        # 1. every sent frame is registered
        for name, line in sorted(sent.items()):
            if name not in registry:
                findings.append(Finding(
                    "S2C205", transport.path, line,
                    f"frame '{name}' is constructed/sent but not "
                    f"registered in WIRE_PROTOCOL"))
        # ...and every frame dataclass at all (sent or not: dead frames
        # are protocol drift too)
        for name, line in sorted(frame_classes.items()):
            if name not in registry and name not in sent:
                findings.append(Finding(
                    "S2C205", transport.path, line,
                    f"frame dataclass '{name}' is not registered in "
                    f"WIRE_PROTOCOL (mark the class with an ignore "
                    f"directive if it never crosses the wire)"))

        # 2. every registered frame has a handler on its receiving side
        master_names, child_names = self._handler_sides(project, transport)
        for name, (direction, _prot, _fen, line) in sorted(registry.items()):
            if direction not in ("c2m", "m2c", "both"):
                findings.append(Finding(
                    "S2C205", transport.path, line,
                    f"frame '{name}' has unknown direction "
                    f"{direction!r} (want c2m/m2c/both)"))
                continue
            if direction in ("c2m", "both") and name not in master_names:
                findings.append(Finding(
                    "S2C205", transport.path, line,
                    f"frame '{name}' ({direction}) has no isinstance "
                    f"handler on the master side"))
            if direction in ("m2c", "both") and name not in child_names:
                findings.append(Finding(
                    "S2C205", transport.path, line,
                    f"frame '{name}' ({direction}) has no isinstance "
                    f"handler on the child side"))

        # 3. _PROTECTED derived from the registry, and consulted by chaos
        findings.extend(self._check_protected(transport, set(registry)))

        # 4. worker events handled by the master collector
        findings.extend(self._check_worker_events(project))

        # 5. fenced frames declare + check the epoch token
        findings.extend(self._check_fenced(project, transport, registry))

        # 6. journal kinds: registered at every append, folded on replay
        findings.extend(self._check_journal(project))
        return findings

    # -- registry parsing ---------------------------------------------------

    @staticmethod
    def _parse_registry(transport: SourceFile
                        ) -> Tuple[Optional[Dict[str,
                                                 Tuple[str, bool, bool,
                                                       int]]],
                                   int]:
        """name -> (direction, protected, fenced, line) from the
        WIRE_PROTOCOL dict literal."""
        for node in ast.walk(transport.tree):
            targets = []
            if isinstance(node, ast.Assign):
                targets = node.targets
                value = node.value
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                targets = [node.target]
                value = node.value
            else:
                continue
            if not any(isinstance(t, ast.Name) and t.id == "WIRE_PROTOCOL"
                       for t in targets):
                continue
            if not isinstance(value, ast.Dict):
                return None, node.lineno
            out: Dict[str, Tuple[str, bool, bool, int]] = {}
            for k, v in zip(value.keys, value.values):
                if not isinstance(k, ast.Name):
                    continue
                direction, protected, fenced = "?", False, False
                if isinstance(v, ast.Call):
                    for i, arg in enumerate(v.args):
                        if not isinstance(arg, ast.Constant):
                            continue
                        if i == 0:
                            direction = arg.value
                        elif i == 1:
                            protected = bool(arg.value)
                        elif i == 2:
                            fenced = bool(arg.value)
                    for kw in v.keywords:
                        if isinstance(kw.value, ast.Constant):
                            if kw.arg == "direction":
                                direction = kw.value.value
                            elif kw.arg == "protected":
                                protected = bool(kw.value.value)
                            elif kw.arg == "fenced":
                                fenced = bool(kw.value.value)
                elif isinstance(v, ast.Tuple) and v.elts:
                    consts = [e.value if isinstance(e, ast.Constant)
                              else None for e in v.elts]
                    if consts and consts[0] is not None:
                        direction = consts[0]
                    if len(consts) > 1 and consts[1] is not None:
                        protected = bool(consts[1])
                    if len(consts) > 2 and consts[2] is not None:
                        fenced = bool(consts[2])
                out[k.id] = (direction, protected, fenced, k.lineno)
            return out, node.lineno
        return None, 1

    # -- handler discovery --------------------------------------------------

    @staticmethod
    def _handler_sides(project: Project, transport: SourceFile
                       ) -> Tuple[Set[str], Set[str]]:
        master: Set[str] = set()
        child: Set[str] = set()
        for node in transport.tree.body:
            if not isinstance(node, ast.ClassDef):
                continue
            targets = _isinstance_targets(node)
            if "Child" in node.name or "Node" in node.name:
                child |= targets
            else:
                master |= targets
        for basename in ("master.py", "worker.py"):
            src = project.file_named(basename)
            if src is not None:
                side = master if basename == "master.py" else child
                side |= _isinstance_targets(src.tree)
        return master, child

    # -- _PROTECTED sync ----------------------------------------------------

    @staticmethod
    def _check_protected(transport: SourceFile,
                         frame_names: Set[str]) -> List[Finding]:
        findings: List[Finding] = []
        prot_node = None
        for node in ast.walk(transport.tree):
            if isinstance(node, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == "_PROTECTED"
                    for t in node.targets):
                prot_node = node
                break
        if prot_node is None:
            findings.append(Finding(
                "S2C205", transport.path, 1,
                "transport.py defines no _PROTECTED chaos-exemption "
                "tuple"))
            return findings
        names_in_value = {n.id for n in ast.walk(prot_node.value)
                          if isinstance(n, ast.Name)}
        if "WIRE_PROTOCOL" not in names_in_value:
            findings.append(Finding(
                "S2C205", transport.path, prot_node.lineno,
                "_PROTECTED is hand-listed instead of derived from "
                "WIRE_PROTOCOL; the chaos exemption set can silently "
                "diverge from the protocol table"))
        elif names_in_value & frame_names:
            findings.append(Finding(
                "S2C205", transport.path, prot_node.lineno,
                "_PROTECTED mixes hand-listed frames into the "
                "WIRE_PROTOCOL derivation"))
        if "_PROTECTED" not in _isinstance_targets(transport.tree):
            findings.append(Finding(
                "S2C205", transport.path, prot_node.lineno,
                "no isinstance(..., _PROTECTED) check found: the chaos "
                "transport does not consult the protection table"))
        return findings

    # -- fenced frames ------------------------------------------------------

    _SIDES = {"c2m": ("master",), "m2c": ("child",),
              "both": ("master", "child")}

    @classmethod
    def _check_fenced(cls, project: Project, transport: SourceFile,
                      registry: Dict[str, Tuple[str, bool, bool, int]]
                      ) -> List[Finding]:
        fenced = {name: (direction, line)
                  for name, (direction, _p, fen, line) in registry.items()
                  if fen}
        if not fenced:
            return []
        findings: List[Finding] = []
        # (i) the frame dataclass declares an epoch field
        fields: Dict[str, Set[str]] = {}
        for node in ast.walk(transport.tree):
            if isinstance(node, ast.ClassDef) and node.name in fenced:
                fields[node.name] = {
                    s.target.id for s in node.body
                    if isinstance(s, ast.AnnAssign)
                    and isinstance(s.target, ast.Name)}
        for name, (_direction, line) in sorted(fenced.items()):
            if "epoch" not in fields.get(name, set()):
                findings.append(Finding(
                    "S2C205", transport.path, line,
                    f"fenced frame '{name}' declares no 'epoch' field "
                    f"(the fencing token has nowhere to ride)"))
        # (ii) every receiving side's handler compares the token
        handlers: Dict[str, List[ast.FunctionDef]] = {"master": [],
                                                      "child": []}
        for cdef, fn in iter_functions(transport):
            side = "child" if cdef is not None and \
                ("Child" in cdef.name or "Node" in cdef.name) else "master"
            handlers[side].append(fn)
        for basename, side in (("master.py", "master"),
                               ("worker.py", "child")):
            src = project.file_named(basename)
            if src is not None:
                for _cdef, fn in iter_functions(src):
                    handlers[side].append(fn)
        for name, (direction, line) in sorted(fenced.items()):
            for side in cls._SIDES.get(direction, ()):
                fns = [fn for fn in handlers[side]
                       if name in _isinstance_targets(fn)]
                if fns and not any(cls._has_epoch_compare(fn)
                                   for fn in fns):
                    findings.append(Finding(
                        "S2C205", transport.path, line,
                        f"fenced frame '{name}' ({direction}) is handled "
                        f"on the {side} side without an epoch comparison "
                        f"— stale-epoch traffic would be accepted"))
        return findings

    @staticmethod
    def _has_epoch_compare(fn: ast.FunctionDef) -> bool:
        for node in ast.walk(fn):
            if isinstance(node, ast.Compare):
                for sub in ast.walk(node):
                    if isinstance(sub, ast.Attribute) and \
                            sub.attr == "epoch":
                        return True
        return False

    # -- journal kinds ------------------------------------------------------

    @staticmethod
    def _check_journal(project: Project) -> List[Finding]:
        journal = project.file_named("journal.py")
        if journal is None:
            return []
        findings: List[Finding] = []
        kinds: Optional[Set[str]] = None
        kinds_line = 1
        for node in ast.walk(journal.tree):
            targets = []
            if isinstance(node, ast.Assign):
                targets = node.targets
                value = node.value
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                targets = [node.target]
                value = node.value
            else:
                continue
            if any(isinstance(t, ast.Name) and t.id == "JOURNAL_KINDS"
                   for t in targets):
                kinds_line = node.lineno
                if isinstance(value, ast.Dict):
                    kinds = {k.value for k in value.keys
                             if isinstance(k, ast.Constant)
                             and isinstance(k.value, str)}
                break
        if kinds is None:
            findings.append(Finding(
                "S2C205", journal.path, kinds_line,
                "journal.py defines no JOURNAL_KINDS registry "
                "(dict literal: kind -> payload contract)"))
            return findings
        # every append site uses a registered kind
        for src in project.files:
            for node in ast.walk(src.tree):
                if isinstance(node, ast.Call) and \
                        isinstance(node.func, ast.Attribute) and \
                        node.func.attr in ("append_record", "_journal") \
                        and node.args and \
                        isinstance(node.args[0], ast.Constant) and \
                        isinstance(node.args[0].value, str):
                    kind = node.args[0].value
                    if kind not in kinds:
                        findings.append(Finding(
                            "S2C205", src.path, node.lineno,
                            f"journal record kind {kind!r} is appended "
                            f"but not registered in JOURNAL_KINDS"))
        # every registered kind is folded by replay()
        replay_fn = None
        for _cdef, fn in iter_functions(journal):
            if fn.name == "replay":
                replay_fn = fn
                break
        if replay_fn is None:
            findings.append(Finding(
                "S2C205", journal.path, kinds_line,
                "journal.py defines JOURNAL_KINDS but no replay() folds "
                "the records back"))
            return findings
        folded = {n.value for n in ast.walk(replay_fn)
                  if isinstance(n, ast.Constant)
                  and isinstance(n.value, str)}
        for kind in sorted(kinds):
            if kind not in folded:
                findings.append(Finding(
                    "S2C205", journal.path, kinds_line,
                    f"journal kind {kind!r} is registered but never "
                    f"folded in RoundJournal.replay — durable state "
                    f"would be dropped on recovery"))
        return findings

    # -- worker events ------------------------------------------------------

    @staticmethod
    def _check_worker_events(project: Project) -> List[Finding]:
        worker = project.file_named("worker.py")
        master = project.file_named("master.py")
        if worker is None or master is None:
            return []
        event_classes = _dataclass_names(worker)
        emitted: Dict[str, int] = {}
        for node in ast.walk(worker.tree):
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr == "put":
                for arg in node.args:
                    if isinstance(arg, ast.Call) and \
                            isinstance(arg.func, ast.Name) and \
                            arg.func.id in event_classes:
                        emitted.setdefault(arg.func.id, arg.lineno)
        handled = _isinstance_targets(master.tree)
        findings = []
        for name, line in sorted(emitted.items()):
            if name not in handled and not worker.is_ignored("S2C205", line):
                findings.append(Finding(
                    "S2C205", worker.path, line,
                    f"worker event '{name}' is emitted but has no "
                    f"isinstance handler in master.py"))
        return findings
