"""Framework core: findings, the rule registry, suppressions, drivers
(the port's own copy of ``photon_tpu/analysis/core.py``, which has no
JAX in it either).

The analyzer is a plain ``ast`` pass — no imports of the analyzed code —
so it runs in milliseconds over the whole package and can gate CI on
machines with no accelerator. Rules register themselves via
:func:`rule`; each receives a parsed :class:`ModuleContext` and yields
:class:`Finding`s. The port registers no tier-1 rule yet (ROADMAP Queue
A item 13); the SPMD tier's lint (``spmd.audit_source``) uses the
context and the suppressions. Suppressions are per-line comments::

    x = bad_thing()  # photon: ignore[rule-id] -- why this is fine here

A reason after ``--`` (or ``:``) is strongly encouraged; ``ignore[*]``
silences every rule on the line. Suppressed findings are retained (with
``suppressed=True``) so reporters can audit them.
"""

from __future__ import annotations

import ast
import dataclasses
import io
import re
import tokenize
from pathlib import Path
from typing import Callable, Iterable, Iterator

_SUPPRESS_RE = re.compile(
    r"#\s*photon:\s*ignore\[([^\]]*)\]\s*(?:(?:--|:)\s*(?P<reason>.*))?"
)


@dataclasses.dataclass(frozen=True)
class Finding:
    """One diagnostic: a rule violation at a source location."""

    rule: str
    path: str
    line: int
    col: int
    message: str
    suppressed: bool = False
    suppress_reason: str | None = None

    def format(self) -> str:
        tag = " (suppressed)" if self.suppressed else ""
        return (
            f"{self.path}:{self.line}:{self.col + 1}: "
            f"[{self.rule}] {self.message}{tag}"
        )

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class Suppression:
    rules: frozenset[str]  # {"*"} means every rule
    reason: str | None

    def covers(self, rule_id: str) -> bool:
        return "*" in self.rules or rule_id in self.rules


class ModuleContext:
    """One parsed source file plus the shared per-file indexes rules need.

    ``parents`` maps every AST node to its parent; ``imports`` maps local
    alias -> canonical dotted module path (``np`` -> ``numpy``,
    ``dist`` -> ``torch.distributed``). ``resolve`` expands an attribute/name chain to
    its canonical dotted path, or None when the root isn't an import.
    """

    def __init__(self, path: str, source: str, tree: ast.Module):
        self.path = path
        self.source = source
        self.tree = tree
        self.lines = source.splitlines()
        self.parents: dict[ast.AST, ast.AST] = {}
        for node in ast.walk(tree):
            for child in ast.iter_child_nodes(node):
                self.parents[child] = node
        self.imports = _collect_imports(tree)
        self.suppressions = _collect_suppressions(source)
        self._resolve_cache: dict[ast.AST, str | None] = {}

    def resolve(self, node: ast.AST) -> str | None:
        """Canonical dotted path for a Name/Attribute chain, else None."""
        if node in self._resolve_cache:
            return self._resolve_cache[node]
        parts: list[str] = []
        cur = node
        while isinstance(cur, ast.Attribute):
            parts.append(cur.attr)
            cur = cur.value
        out = None
        if isinstance(cur, ast.Name):
            root = self.imports.get(cur.id)
            if root is not None:
                out = ".".join([root, *reversed(parts)])
        self._resolve_cache[node] = out
        return out

    def parent_chain(self, node: ast.AST) -> Iterator[ast.AST]:
        cur = self.parents.get(node)
        while cur is not None:
            yield cur
            cur = self.parents.get(cur)

    def enclosing_function(self, node: ast.AST) -> ast.AST | None:
        for anc in self.parent_chain(node):
            if isinstance(
                anc, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
            ):
                return anc
        return None


def _collect_imports(tree: ast.Module) -> dict[str, str]:
    table: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                table[alias.asname or alias.name.split(".")[0]] = (
                    alias.name if alias.asname else alias.name.split(".")[0]
                )
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            for alias in node.names:
                table[alias.asname or alias.name] = (
                    f"{node.module}.{alias.name}"
                )
    return table


def _collect_suppressions(source: str) -> dict[int, Suppression]:
    """Suppressions from COMMENT tokens only — a ``photon: ignore``
    sequence inside a string literal must not silence findings."""
    out: dict[int, Suppression] = {}
    try:
        tokens = tokenize.generate_tokens(io.StringIO(source).readline)
        comments = [
            (tok.start[0], tok.string)
            for tok in tokens
            if tok.type == tokenize.COMMENT
        ]
    except (tokenize.TokenError, IndentationError, SyntaxError):
        return out  # unparseable source is reported as syntax-error
    for lineno, text in comments:
        m = _SUPPRESS_RE.search(text)
        if not m:
            continue
        rules = frozenset(
            r.strip() for r in m.group(1).split(",") if r.strip()
        )
        reason = m.group("reason")
        out[lineno] = Suppression(
            rules=rules or frozenset({"*"}),
            reason=reason.strip() if reason else None,
        )
    return out


# --------------------------------------------------------------------------
# rule registry
# --------------------------------------------------------------------------

RuleFn = Callable[[ModuleContext], Iterable[Finding]]


@dataclasses.dataclass(frozen=True)
class Rule:
    id: str
    summary: str
    fn: RuleFn


_REGISTRY: dict[str, Rule] = {}


def rule(rule_id: str, summary: str) -> Callable[[RuleFn], RuleFn]:
    """Register ``fn`` as the implementation of ``rule_id``."""

    def deco(fn: RuleFn) -> RuleFn:
        if rule_id in _REGISTRY:
            raise ValueError(f"duplicate rule id: {rule_id}")
        _REGISTRY[rule_id] = Rule(id=rule_id, summary=summary, fn=fn)
        return fn

    return deco


def registered_rules() -> dict[str, Rule]:
    return dict(_REGISTRY)


# --------------------------------------------------------------------------
# drivers
# --------------------------------------------------------------------------


def analyze_source(
    source: str,
    path: str = "<string>",
    select: Iterable[str] | None = None,
) -> list[Finding]:
    """All findings for one source blob, suppressions applied (not dropped)."""
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as exc:
        return [
            Finding(
                rule="syntax-error",
                path=path,
                line=exc.lineno or 1,
                col=(exc.offset or 1) - 1,
                message=f"file does not parse: {exc.msg}",
            )
        ]
    ctx = ModuleContext(path, source, tree)
    active = registered_rules()
    if select is not None:
        wanted = set(select)
        unknown = wanted - set(active)
        if unknown:
            raise ValueError(f"unknown rule id(s): {sorted(unknown)}")
        active = {k: v for k, v in active.items() if k in wanted}
    findings: list[Finding] = []
    seen: set[tuple] = set()
    for r in active.values():
        for f in r.fn(ctx):
            # A nested def can be reached twice (as its own jit scope and
            # through the enclosing scope's walk): identical findings
            # collapse to one.
            key = (f.rule, f.line, f.col, f.message)
            if key in seen:
                continue
            seen.add(key)
            sup = ctx.suppressions.get(f.line)
            if sup is not None and sup.covers(f.rule):
                f = dataclasses.replace(
                    f, suppressed=True, suppress_reason=sup.reason
                )
            findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


def analyze_file(
    path: str | Path, select: Iterable[str] | None = None
) -> list[Finding]:
    p = Path(path)
    return analyze_source(
        p.read_text(encoding="utf-8"), path=str(p), select=select
    )


def iter_python_files(paths: Iterable[str | Path]) -> Iterator[Path]:
    for p in paths:
        p = Path(p)
        if p.is_dir():
            yield from sorted(p.rglob("*.py"))
        elif p.suffix == ".py":
            yield p


def analyze_paths(
    paths: Iterable[str | Path], select: Iterable[str] | None = None
) -> list[Finding]:
    findings: list[Finding] = []
    for f in iter_python_files(paths):
        findings.extend(analyze_file(f, select=select))
    return findings
