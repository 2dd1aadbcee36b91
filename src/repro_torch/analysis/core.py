"""s2c2lint core: source model, findings, baseline, reporters, runner.

The analyzer is a project lint — its rules encode *this* codebase's
concurrency and wire-protocol contracts (see ``repro_torch.analysis.rules``),
not generic Python style.  Everything here is stdlib-only so the lint
runs in the barest environment the test suite supports.

Source conventions understood by the analyzer:

``# guarded_by: <lock>``
    On (or immediately above) an attribute's declaring assignment:
    every read/write of that attribute must happen inside a
    ``with <obj>.<lock>:`` block.  ``__init__`` of the declaring class
    is exempt (construction precedes sharing).

``# guarded_by: thread:<tag>``
    The attribute is *thread-confined* rather than lock-guarded: it may
    only be touched from functions annotated ``# thread: <tag>``.

``# thread: <tag>``
    On (or immediately above) a ``def``: declares which logical thread
    the function runs on, for ``thread:`` guards.

``# s2c2lint: ignore[S2C2NN] <reason>``
    Suppresses findings of the given rule id(s) anchored to that line.
    A reason is required — bare ignores are themselves a finding.
"""

from __future__ import annotations

import ast
import dataclasses
import io
import json
import os
import re
import tokenize
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "Finding", "SourceFile", "Project", "Baseline",
    "load_project", "render_line", "render_json",
    "RULE_REGISTRY", "register_rule",
]

_IGNORE_RE = re.compile(
    r"#\s*s2c2lint:\s*ignore\[([A-Z0-9,\s]+)\]\s*(.*)")
_GUARD_RE = re.compile(r"#\s*guarded_by:\s*([A-Za-z_][\w:.\-]*)")
_THREAD_RE = re.compile(r"#\s*thread:\s*([\w\-]+)")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation, anchored to a source line.

    The baseline fingerprint deliberately excludes the line number so
    unrelated edits above a finding don't invalidate its suppression.
    """

    rule: str
    path: str
    line: int
    message: str

    def fingerprint(self) -> Tuple[str, str, str]:
        return (self.rule, self.path, self.message)

    def to_dict(self) -> Dict[str, object]:
        return {"rule": self.rule, "path": self.path,
                "line": self.line, "message": self.message}


@dataclasses.dataclass(frozen=True)
class GuardSpec:
    """Parsed ``# guarded_by:`` declaration for one class attribute."""

    kind: str          # "lock" | "thread"
    name: str          # lock attr name, or thread tag
    line: int

    @classmethod
    def parse(cls, raw: str, line: int) -> "GuardSpec":
        if raw.startswith("thread:"):
            return cls("thread", raw.split(":", 1)[1], line)
        return cls("lock", raw, line)


class SourceFile:
    """One parsed module: AST + the comment directives the rules need."""

    def __init__(self, path: str, text: str):
        self.path = path
        self.text = text
        self.tree = ast.parse(text, filename=path)
        self.lines = text.splitlines()
        # line -> full comment text (tokenize: comments the AST drops)
        self.comments: Dict[int, str] = {}
        # line -> comment is the only thing on its line
        self._own_line: Dict[int, bool] = {}
        try:
            toks = tokenize.generate_tokens(io.StringIO(text).readline)
            for tok in toks:
                if tok.type == tokenize.COMMENT:
                    row = tok.start[0]
                    self.comments[row] = tok.string
                    src = self.lines[row - 1] if row <= len(self.lines) else ""
                    self._own_line[row] = src.lstrip().startswith("#")
        except tokenize.TokenError:
            pass
        # line -> (set of suppressed rule ids, reason); an own-line
        # ignore comment (possibly continued over several comment lines)
        # applies to the next source line, an inline one to its own line
        self.ignores: Dict[int, Tuple[set, str]] = {}
        for row, comment in self.comments.items():
            m = _IGNORE_RE.search(comment)
            if not m:
                continue
            rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
            reason = m.group(2).strip()
            target = row
            if self._own_line.get(row):
                target = row + 1
                while self._own_line.get(target):
                    target += 1
            entry = self.ignores.get(target)
            if entry:
                self.ignores[target] = (entry[0] | rules,
                                        entry[1] or reason)
            else:
                self.ignores[target] = (rules, reason)

    # -- directive lookup ---------------------------------------------------

    def directive_at(self, regex: re.Pattern, line: int) -> Optional[str]:
        """Match a directive on ``line`` or on an own-line comment above."""
        c = self.comments.get(line)
        if c is not None:
            m = regex.search(c)
            if m:
                return m.group(1)
        c = self.comments.get(line - 1)
        if c is not None and self._own_line.get(line - 1):
            m = regex.search(c)
            if m:
                return m.group(1)
        return None

    def guard_at(self, line: int) -> Optional[str]:
        return self.directive_at(_GUARD_RE, line)

    def thread_tag_at(self, node: ast.AST) -> Optional[str]:
        """``# thread:`` tag for a def: on the def line, the line above
        it (above decorators too), or any signature line."""
        assert isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
        first = min([node.lineno] + [d.lineno for d in node.decorator_list])
        tag = self.directive_at(_THREAD_RE, first)
        if tag:
            return tag
        body_start = node.body[0].lineno if node.body else node.lineno + 1
        for row in range(node.lineno, body_start):
            c = self.comments.get(row)
            if c:
                m = _THREAD_RE.search(c)
                if m:
                    return m.group(1)
        return None

    def is_ignored(self, rule: str, line: int) -> bool:
        entry = self.ignores.get(line)
        return bool(entry and rule in entry[0])


class Project:
    """The set of files under analysis plus a cross-file class index."""

    def __init__(self, files: List[SourceFile]):
        self.files = files
        # class name -> (file, ClassDef); later files win on collision,
        # which is fine for this repo (cluster class names are unique)
        self.classes: Dict[str, Tuple[SourceFile, ast.ClassDef]] = {}
        for f in files:
            for node in ast.walk(f.tree):
                if isinstance(node, ast.ClassDef):
                    self.classes[node.name] = (f, node)

    def file_named(self, basename: str) -> Optional[SourceFile]:
        for f in self.files:
            if os.path.basename(f.path) == basename:
                return f
        return None


# -- rule registry ----------------------------------------------------------

RULE_REGISTRY: Dict[str, type] = {}


def register_rule(cls):
    """Class decorator: adds a rule (with ``rule_id``/``run``) to the
    registry keyed by its stable id."""
    RULE_REGISTRY[cls.rule_id] = cls
    return cls


# -- project loading --------------------------------------------------------

def iter_py_files(paths: Sequence[str]) -> List[str]:
    out: List[str] = []
    for p in paths:
        if os.path.isfile(p):
            out.append(p)
            continue
        for root, dirs, names in os.walk(p):
            dirs[:] = sorted(d for d in dirs if d != "__pycache__")
            for name in sorted(names):
                if name.endswith(".py"):
                    out.append(os.path.join(root, name))
    return out


def load_project(paths: Sequence[str]) -> Tuple[Project, List[Finding]]:
    """Parse every .py under ``paths``.  Unparseable files become
    findings (rule S2C200) instead of crashing the run."""
    srcs: List[SourceFile] = []
    errors: List[Finding] = []
    for path in iter_py_files(paths):
        rel = os.path.relpath(path).replace(os.sep, "/")
        try:
            with open(path, "r", encoding="utf-8") as fh:
                text = fh.read()
            srcs.append(SourceFile(rel, text))
        except (SyntaxError, UnicodeDecodeError) as e:
            line = getattr(e, "lineno", 1) or 1
            errors.append(Finding("S2C200", rel, line,
                                  f"unparseable module: {e.__class__.__name__}: {e}"))
    return Project(srcs), errors


def run_rules(project: Project, select: Optional[Iterable[str]] = None
              ) -> List[Finding]:
    wanted = set(select) if select else set(RULE_REGISTRY)
    findings: List[Finding] = []
    for rid in sorted(wanted):
        rule_cls = RULE_REGISTRY.get(rid)
        if rule_cls is None:
            raise KeyError(f"unknown rule id {rid!r}; known: "
                           f"{', '.join(sorted(RULE_REGISTRY))}")
        findings.extend(rule_cls().run(project))
    # drop inline-suppressed findings; flag reasonless suppressions
    kept: List[Finding] = []
    by_path = {f.path: f for f in project.files}
    for fi in findings:
        src = by_path.get(fi.path)
        if src is not None and src.is_ignored(fi.rule, fi.line):
            entry = src.ignores[fi.line]
            if not entry[1]:
                kept.append(Finding(
                    fi.rule, fi.path, fi.line,
                    "suppression without a reason (add one after the "
                    "ignore directive): " + fi.message))
            continue
        kept.append(fi)
    kept.sort(key=lambda f: (f.path, f.line, f.rule, f.message))
    return kept


# -- baseline ---------------------------------------------------------------

class Baseline:
    """Fingerprint-keyed suppression file for pre-existing debt.

    Format (JSON, committed next to the repo root)::

        {"version": 1,
         "suppressions": [{"rule": ..., "path": ..., "message": ...,
                           "reason": ...}]}
    """

    VERSION = 1

    def __init__(self, entries: Optional[List[Dict[str, str]]] = None):
        self.entries: List[Dict[str, str]] = list(entries or [])

    @classmethod
    def load(cls, path: str) -> "Baseline":
        with open(path, "r", encoding="utf-8") as fh:
            doc = json.load(fh)
        if doc.get("version") != cls.VERSION:
            raise ValueError(f"unsupported baseline version in {path}: "
                             f"{doc.get('version')!r}")
        return cls(doc.get("suppressions", []))

    def save(self, path: str) -> None:
        doc = {"version": self.VERSION, "suppressions": self.entries}
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(doc, fh, indent=2, sort_keys=True)
            fh.write("\n")

    @classmethod
    def from_findings(cls, findings: Iterable[Finding],
                      reason: str = "baselined pre-existing debt"
                      ) -> "Baseline":
        entries = [{"rule": f.rule, "path": f.path, "message": f.message,
                    "reason": reason} for f in findings]
        return cls(entries)

    def _keys(self) -> set:
        return {(e["rule"], e["path"], e["message"]) for e in self.entries}

    def apply(self, findings: List[Finding]
              ) -> Tuple[List[Finding], List[Dict[str, str]]]:
        """Split into (non-baselined findings, stale baseline entries)."""
        keys = self._keys()
        live = [f for f in findings if f.fingerprint() not in keys]
        seen = {f.fingerprint() for f in findings}
        stale = [e for e in self.entries
                 if (e["rule"], e["path"], e["message"]) not in seen]
        return live, stale


# -- reporters --------------------------------------------------------------

def render_line(findings: Sequence[Finding]) -> str:
    return "\n".join(f"{f.path}:{f.line}: {f.rule} {f.message}"
                     for f in findings)


def render_json(findings: Sequence[Finding],
                suppressed: int = 0,
                stale_baseline: Sequence[Dict[str, str]] = ()) -> str:
    counts: Dict[str, int] = {}
    for f in findings:
        counts[f.rule] = counts.get(f.rule, 0) + 1
    doc = {
        "tool": "s2c2lint",
        "version": 1,
        "findings": [f.to_dict() for f in findings],
        "counts": counts,
        "suppressed_by_baseline": suppressed,
        "stale_baseline_entries": list(stale_baseline),
    }
    return json.dumps(doc, indent=2, sort_keys=True)
