"""QFX002 — raw pin reads; QFX101 — the pin table contract.

Counterpart of ``qfedx_tpu/analysis/rules_pins.py``.

**QFX002 (raw-pin-read).** Every ``os.environ`` / ``os.getenv`` use
outside ``utils/pins.py`` is a finding. The pin module is THE env
funnel: it owns the on/off grammar and the loud-typo contract (a
misspelled value must raise, never silently route the other path). A
raw read elsewhere re-opens exactly the drift the funnel closed.
Intentional raw uses — ``run/config.py``'s save/restore snapshotting of
``QFEDX_SCAN_LAYERS`` — carry per-line suppressions with reasons.

**QFX101 (pin-doc-table).** An exact ``"QFEDX_*"`` string literal in
package code IS a pin reference, and every pin must have a row in the
docs/OBSERVABILITY.md pin table — both directions (a stale row
misdocuments the system as surely as a missing one). The port keeps
the reference's pin names, so this holds the port against the
reference's own table. ``REFERENCE_ONLY_PINS`` names the rows the port
deliberately does not read, each with its reason: such a row needs no
port literal, and a port literal of one of them is a finding. The
table of those names in this module is not a read, so this module's
own literals are not collected.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path

from qfedx_tpu_torch.analysis.engine import Finding, LintContext, Rule, register
from qfedx_tpu_torch.analysis.loader import Module

PINS_MODULE_SUFFIX = "utils/pins.py"

_PIN_LITERAL = re.compile(r"QFEDX_[A-Z0-9_]+\Z")
_TABLE_ROW = re.compile(r"^\|\s*`(QFEDX_[A-Z0-9_]+)`")

PIN_DOC = "docs/OBSERVABILITY.md"

# Pin-table rows of the reference that the port does not read, each with
# the reason it has no counterpart.
REFERENCE_ONLY_PINS: dict[str, str] = {
    "QFEDX_COMPILE_CACHE": "configures XLA's persistent compilation cache",
    "QFEDX_DONATE": "configures XLA's buffer donation",
}
# The module that holds REFERENCE_ONLY_PINS: its literals are the table
# above, not pin reads.
_SELF_SUFFIX = "analysis/rules_pins.py"


# -- QFX002 --------------------------------------------------------------------


def raw_env_uses(mod: Module) -> list[tuple[int, str]]:
    """``[(lineno, spelling)]`` of ``os.environ`` attribute uses and
    ``os.getenv`` calls, via this module's import aliases."""
    os_aliases = {"os"}
    getenv_aliases = set()
    environ_aliases = set()
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "os":
                    os_aliases.add(a.asname or "os")
        elif isinstance(node, ast.ImportFrom) and node.module == "os":
            for a in node.names:
                if a.name == "getenv":
                    getenv_aliases.add(a.asname or "getenv")
                elif a.name == "environ":
                    environ_aliases.add(a.asname or "environ")
    out: list[tuple[int, str]] = []
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Attribute):
            if node.attr in ("environ", "getenv") and isinstance(
                node.value, ast.Name
            ) and node.value.id in os_aliases:
                out.append((node.lineno, f"os.{node.attr}"))
        elif isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
            if node.id in getenv_aliases:
                out.append((node.lineno, "os.getenv"))
            elif node.id in environ_aliases:
                out.append((node.lineno, "os.environ"))
    return out


def _run_raw_pin_read(ctx: LintContext) -> list[Finding]:
    out: list[Finding] = []
    for rel, mod in sorted(ctx.modules.items()):
        if rel.endswith(PINS_MODULE_SUFFIX):
            continue
        for lineno, spelling in raw_env_uses(mod):
            out.append(Finding(
                "QFX002", rel, lineno,
                f"raw {spelling} outside utils/pins.py — route the read "
                "through a pins helper (bool_pin/str_pin/choice_pin/...) "
                "so the grammar and the loud-typo contract hold",
            ))
    return out


register(Rule(
    "QFX002", "raw-pin-read",
    "every env read funnels through utils/pins (one grammar, loud "
    "typos, documented trace-time semantics)",
    _run_raw_pin_read,
))


# -- QFX101 ---------------------------------------------------------------------


def _pin_literals(modules: dict[str, Module]) -> dict[str, list[tuple[str, int]]]:
    """``{pin_name: [(rel, lineno), ...]}`` for every exact ``QFEDX_*``
    string literal in ``modules`` (this module's own table excepted)."""
    pins: dict[str, list[tuple[str, int]]] = {}
    for rel, mod in sorted(modules.items()):
        if rel.endswith(_SELF_SUFFIX):
            continue
        for node in ast.walk(mod.tree):
            if (
                isinstance(node, ast.Constant)
                and isinstance(node.value, str)
                and _PIN_LITERAL.fullmatch(node.value)
            ):
                pins.setdefault(node.value, []).append((rel, node.lineno))
    return pins


def documented_pin_rows(doc_path: str | Path) -> dict[str, int]:
    """``{pin_name: doc line number}`` — the line-carrying variant the
    engine anchors stale-row findings on."""
    path = Path(doc_path)
    names: dict[str, int] = {}
    for i, line in enumerate(path.read_text().splitlines(), start=1):
        m = _TABLE_ROW.match(line.strip())
        if m:
            names.setdefault(m.group(1), i)
    return names


def _run_pin_table(ctx: LintContext) -> list[Finding]:
    out: list[Finding] = []
    doc = ctx.doc(PIN_DOC)
    rows = documented_pin_rows(doc) if doc.exists() else {}
    pins = _pin_literals(ctx.modules)
    for name, sites in sorted(pins.items()):
        if name in REFERENCE_ONLY_PINS:
            for rel, lineno in sites:
                out.append(Finding(
                    "QFX101", rel, lineno,
                    f"pin {name} is reference-only "
                    f"({REFERENCE_ONLY_PINS[name]}) — the port must not "
                    "read it",
                ))
            continue
        if name not in rows:
            rel, lineno = sites[0]
            out.append(Finding(
                "QFX101", rel, lineno,
                f"pin {name} has no row in the {PIN_DOC} pin table "
                f"(also read at: "
                f"{', '.join(f'{r}:{l}' for r, l in sites[1:]) or 'nowhere else'})",
            ))
    for name, doc_line in sorted(rows.items()):
        if name not in pins and name not in REFERENCE_ONLY_PINS:
            out.append(Finding(
                "QFX101", PIN_DOC, doc_line,
                f"pin table row {name} matches no QFEDX_* literal in "
                "package code (stale doc row?)",
            ))
    return out


register(Rule(
    "QFX101", "pin-doc-table",
    "every QFEDX_* pin in source has a docs/OBSERVABILITY.md table row "
    "and every row matches source (both directions), reference-only "
    "rows excepted and never read",
    _run_pin_table,
))
