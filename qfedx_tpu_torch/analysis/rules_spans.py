"""QFX003 — span-leak; QFX103 — the span taxonomy contract.

Counterpart of ``qfedx_tpu/analysis/rules_spans.py``, copied as it is.

**QFX003 (span-leak).** A registry span must CLOSE: an opened-but-
never-exited span corrupts the thread's span stack (every later span
mis-parents under it), and the phase rollup/trace.json silently lose
whatever the leaked span was supposed to time. The safe spellings are
the context-manager ones, so the rule flags:

- a ``span(...)`` / ``obs.span(...)`` / ``trace_context(...)`` call
  that is neither a ``with`` item nor assigned to a name that is
  later used as a ``with`` item in the same function scope;
- an explicit ``.__enter__()`` call not protected by a ``try`` that
  has a ``finally`` (the manual-pairing spelling is only provably
  balanced when the exit is in a finally).

**QFX103 (span-taxonomy).** A string literal as
the first argument of a ``span(...)`` call IS a span name, and every
name needs a row in docs/OBSERVABILITY.md's "## Span taxonomy" table —
both directions.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path

from qfedx_tpu_torch.analysis.engine import Finding, LintContext, Rule, register
from qfedx_tpu_torch.analysis.loader import Module

SPAN_FACTORIES = {"span", "trace_context"}

_TABLE_ROW = re.compile(r"^\|\s*`([a-z0-9_.]+)`")
_HEADING = "## Span taxonomy"
SPAN_DOC = "docs/OBSERVABILITY.md"


def _call_name(node: ast.Call) -> str | None:
    fn = node.func
    if isinstance(fn, ast.Attribute):
        return fn.attr
    if isinstance(fn, ast.Name):
        return fn.id
    return None


def _statement(node: ast.AST) -> ast.stmt | None:
    cur = node
    while cur is not None and not isinstance(cur, ast.stmt):
        cur = getattr(cur, "parent", None)
    return cur


def _in_withitem(node: ast.AST) -> bool:
    cur, prev = getattr(node, "parent", None), node
    while cur is not None:
        if isinstance(cur, ast.withitem) and cur.context_expr is prev:
            return True
        if isinstance(cur, ast.stmt):
            return False
        prev, cur = cur, getattr(cur, "parent", None)
    return False


def _enclosing_scope(node: ast.AST) -> ast.AST:
    cur = getattr(node, "parent", None)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.Lambda, ast.Module)):
            return cur
        cur = getattr(cur, "parent", None)
    return node


def _names_used_as_with_context(scope: ast.AST) -> set[str]:
    out: set[str] = set()
    for node in ast.walk(scope):
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                ce = item.context_expr
                if isinstance(ce, ast.Name):
                    out.add(ce.id)
    return out


def _protected_by_finally(node: ast.AST) -> bool:
    cur = getattr(node, "parent", None)
    while cur is not None:
        if isinstance(cur, ast.Try) and cur.finalbody:
            return True
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.Lambda)):
            return False
        cur = getattr(cur, "parent", None)
    return False


def span_leaks(mod: Module) -> list[tuple[int, str]]:
    """``[(lineno, description)]`` of span-open sites that cannot be
    proven to close."""
    out: list[tuple[int, str]] = []
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        name = _call_name(node)
        if name in SPAN_FACTORIES:
            if _in_withitem(node):
                continue
            stmt = _statement(node)
            if isinstance(stmt, (ast.Return, ast.Yield)):
                continue  # handing the manager to the caller is their job
            scope = _enclosing_scope(node)
            if isinstance(stmt, ast.Assign) and all(
                isinstance(t, ast.Name) for t in stmt.targets
            ):
                targets = {t.id for t in stmt.targets}  # type: ignore[union-attr]
                if targets & _names_used_as_with_context(scope):
                    continue  # assigned, then `with name:` later — closes
            # a bare argument position (e.g. stack.enter_context(span(..)))
            parent = getattr(node, "parent", None)
            if isinstance(parent, ast.Call) and node in parent.args:
                pname = _call_name(parent)
                if pname == "enter_context":
                    continue  # ExitStack owns the exit
            out.append((
                node.lineno,
                f"{name}(...) opened outside a `with` — the span can "
                "leak open and corrupt the span stack",
            ))
        elif name == "__enter__" and isinstance(node.func, ast.Attribute):
            if not _protected_by_finally(node):
                out.append((
                    node.lineno,
                    "manual .__enter__() without an enclosing "
                    "try/finally — the matching exit is not provable",
                ))
    return out


def _run_span_leak(ctx: LintContext) -> list[Finding]:
    out: list[Finding] = []
    for rel, mod in sorted(ctx.modules.items()):
        for lineno, msg in span_leaks(mod):
            out.append(Finding("QFX003", rel, lineno, msg))
    return out


register(Rule(
    "QFX003", "span-leak",
    "every registry span provably closes (with-statement or "
    "try/finally) — a leaked span mis-parents all later spans",
    _run_span_leak,
))


# -- QFX103 ---------------------------------------------------------------


def _span_literals(mod: Module) -> list[tuple[str, int]]:
    out: list[tuple[str, int]] = []
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call) or not node.args:
            continue
        if _call_name(node) != "span":
            continue
        first = node.args[0]
        if isinstance(first, ast.Constant) and isinstance(first.value, str):
            out.append((first.value, node.lineno))
    return out


def documented_span_rows(doc_path: str | Path) -> dict[str, int]:
    """``{span_name: doc line}`` from the "## Span taxonomy" section."""
    path = Path(doc_path)
    names: dict[str, int] = {}
    in_section = False
    for i, line in enumerate(path.read_text().splitlines(), start=1):
        stripped = line.strip()
        if stripped.startswith("#"):
            in_section = stripped.startswith(_HEADING)
            continue
        if not in_section:
            continue
        m = _TABLE_ROW.match(stripped)
        if m and m.group(1) != "span":  # skip a literal header row
            names.setdefault(m.group(1), i)
    return names


def _run_span_taxonomy(ctx: LintContext) -> list[Finding]:
    out: list[Finding] = []
    doc = ctx.doc(SPAN_DOC)
    rows = documented_span_rows(doc) if doc.exists() else {}
    spans: dict[str, list[tuple[str, int]]] = {}
    for rel, mod in sorted(ctx.modules.items()):
        for name, lineno in _span_literals(mod):
            spans.setdefault(name, []).append((rel, lineno))
    for name, sites in sorted(spans.items()):
        if name not in rows:
            rel, lineno = sites[0]
            out.append(Finding(
                "QFX103", rel, lineno,
                f"span {name!r} has no row in the {SPAN_DOC} "
                "span-taxonomy table",
            ))
    for name, doc_line in sorted(rows.items()):
        if name not in spans:
            out.append(Finding(
                "QFX103", SPAN_DOC, doc_line,
                f"span-taxonomy row {name!r} matches no span literal "
                "in package code (stale doc row?)",
            ))
    return out


register(Rule(
    "QFX103", "span-taxonomy",
    "every recorded span name has a docs/OBSERVABILITY.md taxonomy row "
    "and every row matches source (both directions)",
    _run_span_taxonomy,
))
