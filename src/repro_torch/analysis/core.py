"""svmlint framework: findings, rule registry, suppressions, tree walk.

The engine's correctness rests on cross-tier *contracts* (batched ==
scalar byte-identity, frozen compiled-trace columns, counter
conservation, determinism, manager encapsulation) that runtime
equivalence tests can only probe pointwise.  `repro_torch.analysis` checks
the contracts at the **source** level: each `Rule` walks a module's AST and
reports `Finding`s; the CLI (``python -m repro_torch.analysis``) exits 1
on any finding over `src/repro_torch`.

Suppressions
------------
A finding is silenced by an inline comment on the flagged line (or on a
comment-only line directly above it)::

    t0 = time.time()   # svmlint: disable=determinism -- host-side timer,
                       # not the simulated clock

The reason string after ``--`` is **mandatory**: a bare
``# svmlint: disable=<rule>`` is itself reported (rule
``suppression-reason``), so every exemption documents why it is sound.
``disable=all`` silences every rule on that line (still needs a reason).
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Iterable, Sequence

SUPPRESS_RE = re.compile(
    r"#\s*svmlint:\s*disable=([A-Za-z0-9_,-]+)(?:\s+--\s*(\S.*?))?\s*$")

#: rule id reserved for the framework's bare-suppression check
SUPPRESSION_RULE = "suppression-reason"


@dataclasses.dataclass(frozen=True)
class Finding:
    """One contract violation at a source location."""

    rule: str
    path: str
    line: int
    col: int
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: " \
               f"[{self.rule}] {self.message}"


@dataclasses.dataclass(frozen=True)
class Suppression:
    line: int
    rules: frozenset[str]      # rule names, possibly {"all"}
    reason: str | None
    own_line: bool             # comment-only line (covers the next line)


class LintModule:
    """One parsed source module handed to every rule.

    ``relpath`` locates the module inside the package tree (used by
    scoped rules — e.g. manager encapsulation only applies under
    ``repro_torch/svm`` + ``repro_torch/launch``); for fixture snippets
    the caller passes whatever path places the snippet in the scope under
    test.
    """

    def __init__(self, source: str, path: str):
        self.source = source
        self.path = path
        self.tree = ast.parse(source, filename=path)
        self.lines = source.splitlines()
        self.suppressions = _parse_suppressions(self.lines)

    @property
    def package(self) -> str:
        """Dotted package guess from the path: everything from the
        ``repro_torch`` component to the module's parent directory."""
        parts = self.path.replace(os.sep, "/").split("/")
        if "repro_torch" not in parts:
            return ""
        return ".".join(parts[parts.index("repro_torch"):-1])

    def suppressed(self, finding: Finding) -> bool:
        for line in (finding.line, finding.line - 1):
            sup = self.suppressions.get(line)
            if sup is None:
                continue
            if line == finding.line - 1 and not sup.own_line:
                continue       # trailing comment only covers its own line
            if finding.rule in sup.rules or "all" in sup.rules:
                return True
        return False


def _parse_suppressions(lines: Sequence[str]) -> dict[int, Suppression]:
    out: dict[int, Suppression] = {}
    for i, text in enumerate(lines, start=1):
        m = SUPPRESS_RE.search(text)
        if m is None:
            continue
        rules = frozenset(r.strip() for r in m.group(1).split(",")
                          if r.strip())
        out[i] = Suppression(line=i, rules=rules, reason=m.group(2),
                             own_line=text.lstrip().startswith("#"))
    return out


class Rule:
    """Base class: subclasses set ``name``/``doc``/``invariant`` and
    implement `check`.  ``scope`` (dotted-package prefixes) limits where
    the rule applies; empty means the whole tree."""

    name = ""
    doc = ""
    invariant = ""
    scope: tuple[str, ...] = ()

    def applies(self, mod: LintModule) -> bool:
        if not self.scope:
            return True
        pkg = mod.package
        return any(pkg == s or pkg.startswith(s + ".") for s in self.scope)

    def check(self, mod: LintModule) -> Iterable[Finding]:
        raise NotImplementedError


RULES: dict[str, Rule] = {}


def register_rule(cls: type[Rule]) -> type[Rule]:
    """Class decorator adding a rule instance to the registry."""
    rule = cls()
    if not rule.name:
        raise ValueError(f"rule {cls.__name__} has no name")
    if rule.name in RULES:
        raise ValueError(f"duplicate rule name {rule.name!r}")
    RULES[rule.name] = rule
    return cls


def _resolve(rules: Sequence[str] | None) -> list[Rule]:
    if rules is None:
        return list(RULES.values())
    missing = [r for r in rules if r not in RULES]
    if missing:
        raise KeyError(f"unknown rule(s) {missing}; "
                       f"available: {sorted(RULES)}")
    return [RULES[r] for r in rules]


def _suppression_findings(mod: LintModule) -> list[Finding]:
    """Every svmlint suppression must carry a ``-- reason`` string."""
    return [
        Finding(SUPPRESSION_RULE, mod.path, sup.line, 0,
                "bare suppression: add ' -- <reason>' saying why the "
                "flagged site is sound")
        for sup in mod.suppressions.values() if not sup.reason
    ]


def lint_source(source: str, path: str = "<string>", *,
                rules: Sequence[str] | None = None) -> list[Finding]:
    """Lint one source string (fixture entry point; `lint_paths` wraps
    this for files).  Returns surviving findings, suppression-filtered,
    plus bare-suppression findings."""
    mod = LintModule(source, path)
    found: list[Finding] = []
    for rule in _resolve(rules):
        if rule.applies(mod):
            found.extend(rule.check(mod))
    found = [f for f in found if not mod.suppressed(f)]
    found.extend(_suppression_findings(mod))
    # dedupe: nested expressions can trip one rule twice at one location
    found = list(dict.fromkeys(found))
    found.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return found


def iter_py_files(paths: Iterable[str]) -> list[str]:
    out: list[str] = []
    for p in paths:
        if os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = sorted(d for d in dirnames
                                     if d != "__pycache__")
                out.extend(os.path.join(dirpath, f)
                           for f in sorted(filenames)
                           if f.endswith(".py"))
        elif p.endswith(".py"):
            out.append(p)
    return out


def lint_paths(paths: Iterable[str], *,
               rules: Sequence[str] | None = None) -> list[Finding]:
    """Lint every ``.py`` file under the given files/directories."""
    found: list[Finding] = []
    for path in iter_py_files(paths):
        with open(path, encoding="utf-8") as f:
            source = f.read()
        found.extend(lint_source(source, path, rules=rules))
    return found


# ---------------------------------------------------------- AST utilities

def walk_functions(tree: ast.AST):
    """Yield ``(node, qualname)`` for every (async) function, with class
    nesting reflected in the qualname (``Cls.meth``)."""

    def visit(node, prefix):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                q = f"{prefix}{child.name}"
                yield child, q
                yield from visit(child, q + ".")
            elif isinstance(child, ast.ClassDef):
                yield from visit(child, f"{prefix}{child.name}.")
            else:
                yield from visit(child, prefix)

    yield from visit(tree, "")


def attr_chain(node: ast.AST) -> str | None:
    """Dotted text of a Name/Attribute chain (``self.plan.mgr`` ->
    ``"self.plan.mgr"``), or None for non-trivial expressions."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None
