"""QFX105 — no bare ``print()`` in library code.

Counterpart of ``qfedx_tpu/analysis/rules_prints.py``, copied as it is.
Telemetry goes through ``obs`` (spans/counters) and ``run/metrics``
(JSONL artifacts); progress text goes through the primary-gated
``say`` in ``run/cli.py`` and ``run/sweep.py``. A stray ``print`` in
library code interleaves across the processes of a process group and
is invisible to every exporter. AST-based (string literals and
docstrings mentioning print are fine); the allowlist names the two
terminal-output entry points and nothing else.
"""

from __future__ import annotations

import ast

from qfedx_tpu_torch.analysis.engine import Finding, LintContext, Rule, register
from qfedx_tpu_torch.analysis.loader import Module

# Files whose job is terminal output: the argparse CLI (primary-gated
# ``say``) and the walkthrough demo script. Package-relative.
ALLOWED = {"run/cli.py", "run/demo.py"}


def print_calls(mod: Module) -> list[int]:
    return [
        node.lineno
        for node in ast.walk(mod.tree)
        if isinstance(node, ast.Call)
        and isinstance(node.func, ast.Name)
        and node.func.id == "print"
    ]


def _run(ctx: LintContext) -> list[Finding]:
    out: list[Finding] = []
    for rel, mod in sorted(ctx.modules.items()):
        if any(rel.endswith(a) for a in ALLOWED):
            continue
        for lineno in print_calls(mod):
            out.append(Finding(
                "QFX105", rel, lineno,
                "bare print() in library code — route telemetry through "
                "obs spans/counters or run/metrics JSONL (prints "
                "interleave across hosts and reach no exporter)",
            ))
    return out


register(Rule(
    "QFX105", "no-print",
    "no bare print() outside run/cli.py + run/demo.py — telemetry "
    "flows through obs/metrics where exporters can see it",
    _run,
))
