"""Concurrency-contract rules: guarded-by, lock-order, blocking-under-lock.

All three rules share one walk over every function body that tracks the
lexically-held lock stack (nested ``with <lock>:`` statements).  A
"lock-ish" with-expression is one whose terminal name looks like a lock
(contains ``lock``, or is a condition variable ``_cv``/``cv``/``cond``).

Lock identity is *name-based*, matching how this codebase is written:
``with self._lock:`` satisfies a ``# guarded_by: _lock`` declaration on
any attribute of the enclosing object.  That is deliberately a lexical
(not alias-precise) analysis — the same tradeoff every guarded-by
annotation system makes — and it is exactly strong enough to catch the
bug class PRs 3 and 7 fixed by hand: a ledger touched outside its
``with`` block.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Set, Tuple

from .core import Finding, GuardSpec, Project, SourceFile, register_rule

__all__ = ["GuardedByRule", "LockOrderRule", "BlockingUnderLockRule"]

_CV_NAMES = {"_cv", "cv", "cond", "_cond", "condition"}


def _terminal_name(expr: ast.AST) -> Optional[str]:
    """``self._lock`` -> ``_lock``; ``lock`` -> ``lock``."""
    if isinstance(expr, ast.Attribute):
        return expr.attr
    if isinstance(expr, ast.Name):
        return expr.id
    return None


def is_lockish(expr: ast.AST) -> bool:
    name = _terminal_name(expr)
    if name is None:
        return False
    low = name.lower()
    return "lock" in low or low in _CV_NAMES


def _expr_text(expr: ast.AST) -> str:
    try:
        return ast.unparse(expr)
    except Exception:  # pragma: no cover - unparse is total on real trees
        return "<expr>"


@dataclasses.dataclass
class HeldLock:
    name: str          # terminal lock name, e.g. "_lock"
    owner: str         # resolved owner key, e.g. "Worker" or "<module>"
    text: str          # source text of the with-expression
    site: Tuple[str, int]

    @property
    def key(self) -> str:
        return f"{self.owner}.{self.name}"


class _FunctionContext:
    """Per-function state: local variable -> class-name type environment."""

    def __init__(self, src: SourceFile, cls: Optional[ast.ClassDef],
                 fn: ast.FunctionDef, project: Project):
        self.src = src
        self.cls = cls
        self.fn = fn
        self.thread_tag = src.thread_tag_at(fn)
        self.env: Dict[str, str] = {}
        known = project.classes
        args = fn.args
        for a in (args.posonlyargs + args.args + args.kwonlyargs):
            cname = _annotation_class(a.annotation)
            if cname and cname in known:
                self.env[a.arg] = cname
        if cls is not None and (args.args or args.posonlyargs):
            first = (args.posonlyargs + args.args)[0].arg
            self.env[first] = cls.name
        # locals assigned from a known-class constructor or annotated
        for node in ast.walk(fn):
            if isinstance(node, ast.AnnAssign) and \
                    isinstance(node.target, ast.Name):
                cname = _annotation_class(node.annotation)
                if cname and cname in known:
                    self.env[node.target.id] = cname
            elif isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and isinstance(node.value, ast.Call) \
                    and isinstance(node.value.func, ast.Name) \
                    and node.value.func.id in known:
                self.env[node.targets[0].id] = node.value.func.id

    def resolve(self, expr: ast.AST) -> Optional[str]:
        """Class name an expression statically refers to, if known."""
        if isinstance(expr, ast.Name):
            return self.env.get(expr.id)
        return None


def _annotation_class(ann: Optional[ast.AST]) -> Optional[str]:
    if ann is None:
        return None
    if isinstance(ann, ast.Name):
        return ann.id
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        # string annotation: take the bare name ("'_RoundState'")
        return ann.value.strip().split("[")[0]
    if isinstance(ann, ast.Attribute):
        return ann.attr
    if isinstance(ann, ast.Subscript):  # Optional[X] / list[X] -> not an
        return None                     # instance the rules can track
    return None


def iter_functions(src: SourceFile):
    """Yield (classdef-or-None, functiondef) for every function, with the
    *innermost* enclosing class attached to methods."""

    def walk(node: ast.AST, cls: Optional[ast.ClassDef]):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                yield from walk(child, child)
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield (cls, child)
                # nested defs belong to the same class context
                yield from walk(child, cls)
            else:
                yield from walk(child, cls)

    yield from walk(src.tree, None)


def collect_guard_decls(project: Project
                        ) -> Dict[Tuple[str, str], GuardSpec]:
    """(class name, attr name) -> GuardSpec from ``# guarded_by:``
    comments on declaring assignments (class body or ``self.x = ...``)."""
    decls: Dict[Tuple[str, str], GuardSpec] = {}
    for src in project.files:
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            for stmt in ast.walk(node):
                if isinstance(stmt, ast.Assign):
                    targets = stmt.targets
                elif isinstance(stmt, ast.AnnAssign):
                    targets = [stmt.target]
                else:
                    continue
                raw = src.guard_at(stmt.lineno)
                if raw is None:
                    continue
                spec = GuardSpec.parse(raw, stmt.lineno)
                for t in targets:
                    if isinstance(t, ast.Attribute) and \
                            isinstance(t.value, ast.Name) and \
                            t.value.id == "self":
                        decls[(node.name, t.attr)] = spec
                    elif isinstance(t, ast.Name):
                        decls[(node.name, t.id)] = spec
    return decls


class _Walker:
    """One pass per function: guarded accesses, lock edges, blocking calls."""

    BLOCKING_ATTRS = {
        "sendall", "recv", "recv_exact", "recv_into", "accept",
        "connect", "communicate", "result",
    }
    _PATHLIKE = {"os", "path", "posixpath", "ntpath", "shlex"}
    _QUEUEISH = ("queue", "inbox", "events", "mailbox")

    def __init__(self, project: Project,
                 decls: Dict[Tuple[str, str], GuardSpec]):
        self.project = project
        self.decls = decls
        self.guarded_findings: List[Finding] = []
        self.blocking_findings: List[Finding] = []
        # lock-order edges: (from_key, to_key) -> first site
        self.edges: Dict[Tuple[str, str], Tuple[str, int]] = {}
        self.reacquires: List[Finding] = []
        self.guarded_attr_names: Set[str] = {a for (_, a) in decls}

    # -- per-function entry -------------------------------------------------

    def walk_function(self, src: SourceFile, cls: Optional[ast.ClassDef],
                      fn: ast.FunctionDef) -> None:
        ctx = _FunctionContext(src, cls, fn, self.project)
        held: List[HeldLock] = []
        for stmt in fn.body:
            self._visit(stmt, src, ctx, held)

    # -- recursive visit ----------------------------------------------------

    def _visit(self, node: ast.AST, src: SourceFile, ctx: _FunctionContext,
               held: List[HeldLock]) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return  # nested scopes analyzed separately; locks don't flow in
        if isinstance(node, ast.With):
            pushed = 0
            for item in node.items:
                expr = item.context_expr
                if is_lockish(expr):
                    lock = self._make_lock(expr, src, ctx)
                    self._record_acquire(held, lock, src)
                    held.append(lock)
                    pushed += 1
                else:
                    self._visit(expr, src, ctx, held)
            for stmt in node.body:
                self._visit(stmt, src, ctx, held)
            for _ in range(pushed):
                held.pop()
            return
        if isinstance(node, ast.Call):
            self._check_blocking(node, src, ctx, held)
        if isinstance(node, ast.Attribute):
            self._check_guarded(node, src, ctx, held)
        for child in ast.iter_child_nodes(node):
            self._visit(child, src, ctx, held)

    def _make_lock(self, expr: ast.AST, src: SourceFile,
                   ctx: _FunctionContext) -> HeldLock:
        name = _terminal_name(expr) or "<lock>"
        owner = "<module>"
        if isinstance(expr, ast.Attribute):
            base = expr.value
            resolved = ctx.resolve(base)
            if resolved:
                owner = resolved
            else:
                owner = _expr_text(base)
        return HeldLock(name=name, owner=owner, text=_expr_text(expr),
                        site=(src.path, expr.lineno))

    # -- S2C202 edges -------------------------------------------------------

    def _record_acquire(self, held: List[HeldLock], lock: HeldLock,
                        src: SourceFile) -> None:
        for h in held:
            if h.text == lock.text:
                line = lock.site[1]
                if not src.is_ignored("S2C202", line):
                    self.reacquires.append(Finding(
                        "S2C202", src.path, line,
                        f"nested acquisition of non-reentrant lock "
                        f"'{lock.text}' (already held since line "
                        f"{h.site[1]}) deadlocks"))
                continue
            edge = (h.key, lock.key)
            if edge not in self.edges:
                self.edges[edge] = lock.site

    # -- S2C201 -------------------------------------------------------------

    def _check_guarded(self, node: ast.Attribute, src: SourceFile,
                       ctx: _FunctionContext, held: List[HeldLock]) -> None:
        if node.attr not in self.guarded_attr_names:
            return
        owner = ctx.resolve(node.value)
        if owner is None:
            return
        spec = self.decls.get((owner, node.attr))
        if spec is None:
            return
        is_self = (isinstance(node.value, ast.Name) and
                   ctx.cls is not None and
                   ctx.env.get(node.value.id) == ctx.cls.name and
                   node.value.id in {"self", "cls"})
        if is_self and ctx.fn.name in ("__init__", "__new__",
                                       "__getstate__", "__setstate__"):
            return  # construction / pickling precede sharing
        if spec.kind == "lock":
            if any(h.name == spec.name for h in held):
                return
            msg = (f"{owner}.{node.attr} is declared guarded_by "
                   f"'{spec.name}' but is accessed in '{ctx.fn.name}' "
                   f"without holding it")
        else:
            if ctx.thread_tag == spec.name:
                return
            msg = (f"{owner}.{node.attr} is confined to thread "
                   f"'{spec.name}' but '{ctx.fn.name}' carries "
                   f"{'no thread tag' if ctx.thread_tag is None else 'tag ' + repr(ctx.thread_tag)}")
        self.guarded_findings.append(
            Finding("S2C201", src.path, node.lineno, msg))

    # -- S2C203 -------------------------------------------------------------

    def _check_blocking(self, node: ast.Call, src: SourceFile,
                        ctx: _FunctionContext, held: List[HeldLock]) -> None:
        if not held:
            return
        label = self._blocking_label(node)
        if label is None:
            return
        lock = held[-1]
        self.blocking_findings.append(Finding(
            "S2C203", src.path, node.lineno,
            f"blocking call '{label}' in '{ctx.fn.name}' while holding "
            f"'{lock.text}'"))

    def _blocking_label(self, node: ast.Call) -> Optional[str]:
        func = node.func
        if isinstance(func, ast.Name):
            if func.id == "sleep":
                return "sleep"
            return None
        if not isinstance(func, ast.Attribute):
            return None
        attr = func.attr
        base = func.value
        base_name = _terminal_name(base)
        if attr == "sleep":
            if base_name == "time":
                return "time.sleep"
            return None
        if attr in self.BLOCKING_ATTRS:
            return f"{_expr_text(base)}.{attr}"
        if attr == "join":
            if isinstance(base, (ast.Constant, ast.JoinedStr)):
                return None  # ", ".join(...)
            if base_name in self._PATHLIKE:
                return None  # os.path.join
            return f"{_expr_text(base)}.join"
        if attr == "wait":
            if is_lockish(base):
                return None  # cv.wait releases the lock it waits on
            return f"{_expr_text(base)}.wait"
        if attr == "get":
            has_block_kw = any(kw.arg in ("timeout", "block")
                               for kw in node.keywords)
            queueish = base_name is not None and (
                base_name == "q" or
                any(h in base_name.lower() for h in self._QUEUEISH))
            if has_block_kw or queueish:
                return f"{_expr_text(base)}.get"
            return None
        return None


def _run_walker(project: Project) -> _Walker:
    decls = collect_guard_decls(project)
    walker = _Walker(project, decls)
    for src in project.files:
        for cls, fn in iter_functions(src):
            walker.walk_function(src, cls, fn)
    return walker


# Each rule re-runs the shared walk; project trees here are small (a
# package, not a monorepo) and rules stay independently selectable.

@register_rule
class GuardedByRule:
    rule_id = "S2C201"
    name = "guarded-by"

    def run(self, project: Project) -> List[Finding]:
        return _run_walker(project).guarded_findings


@register_rule
class LockOrderRule:
    rule_id = "S2C202"
    name = "lock-order-cycle"

    def run(self, project: Project) -> List[Finding]:
        walker = _run_walker(project)
        findings = list(walker.reacquires)
        findings.extend(self._cycles(walker.edges))
        return findings

    @staticmethod
    def _cycles(edges: Dict[Tuple[str, str], Tuple[str, int]]
                ) -> List[Finding]:
        graph: Dict[str, Set[str]] = {}
        for (a, b) in edges:
            graph.setdefault(a, set()).add(b)
            graph.setdefault(b, set())
        # DFS cycle enumeration; dedupe cycles by their node *set* so
        # A->B->A and B->A->B report once
        seen_cycles: Set[frozenset] = set()
        findings: List[Finding] = []
        for start in sorted(graph):
            stack = [(start, [start])]
            while stack:
                node, path = stack.pop()
                for nxt in sorted(graph[node]):
                    if nxt == start and len(path) > 1:
                        key = frozenset(path)
                        if key in seen_cycles:
                            continue
                        seen_cycles.add(key)
                        cyc = path + [start]
                        site = edges.get((path[-1], start)) or \
                            edges.get((path[0], path[1]))
                        findings.append(Finding(
                            "S2C202", site[0], site[1],
                            "lock-order cycle: " + " -> ".join(cyc)))
                    elif nxt not in path:
                        stack.append((nxt, path + [nxt]))
        return findings


@register_rule
class BlockingUnderLockRule:
    rule_id = "S2C203"
    name = "blocking-under-lock"

    def run(self, project: Project) -> List[Finding]:
        return _run_walker(project).blocking_findings
