"""The rule registry, baseline semantics and report rendering.

Counterpart of ``qfedx_tpu/analysis/engine.py``, copied as it is. One
engine, many rules: each rule is registered once with a stable ID
(``QFX002``…), a one-line claim of what it proves, and a ``run(ctx)``
returning findings. The engine owns everything rules share — the
parsed module tree, the call graph, suppression accounting, the
committed baseline of grandfathered findings — so adding a rule is a
~50-line file, not another script with its own file walker.

**Baseline semantics.** A finding is *baselined* (reported but not
failing) when the committed baseline file carries a matching entry.
Entries match on ``(rule, path, stripped source line text)`` — line
*text*, not line number, so unrelated edits above a grandfathered
finding don't churn the file — with multiset counting (two identical
lines need two entries). A baseline entry matching nothing is *stale*
and fails the run: the finding it grandfathered was fixed, so the
entry must go — the same both-directions discipline as the doc-table
rules. ``lint --update-baseline`` rewrites the file from the current
findings.

**Suppressions** (``# qfedx: ignore[QFX002] reason`` on the finding's
line, loader.py grammar) remove the finding entirely; a suppression
without a reason is itself a finding (QFX000), because an undocumented
exemption is exactly the drift this engine exists to stop.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable

from qfedx_tpu_torch.analysis.callgraph import CallGraph, build_callgraph
from qfedx_tpu_torch.analysis.config import LintConfig, load_config
from qfedx_tpu_torch.analysis.loader import Module, load_tree

JSON_SCHEMA_VERSION = 1


@dataclass(frozen=True)
class Finding:
    """One rule violation at one source (or doc) line."""

    rule: str
    path: str        # repo-relative posix path
    line: int        # 1-based
    message: str

    def location(self) -> str:
        return f"{self.path}:{self.line}"


@dataclass
class Rule:
    id: str
    title: str                    # short name, e.g. "span-leak"
    proves: str                   # one line: the invariant it proves
    run: Callable[["LintContext"], list[Finding]]


_REGISTRY: dict[str, Rule] = {}


def register(rule: Rule) -> Rule:
    if rule.id in _REGISTRY:
        raise ValueError(f"duplicate rule id {rule.id}")
    _REGISTRY[rule.id] = rule
    return rule


def all_rules() -> dict[str, Rule]:
    return dict(_REGISTRY)


class LintContext:
    """What every rule sees: config, parsed modules, lazy call graph."""

    def __init__(self, config: LintConfig):
        self.config = config
        self.root = config.root
        # {repo-relative rel: Module} across all configured packages —
        # rel_prefix makes the loader emit repo coordinates directly,
        # so Finding paths, module names and import resolution speak
        # one system and the parse cache stays shared (no re-keying of
        # cached objects).
        self.modules: dict[str, Module] = {}
        for pkg_root in config.package_roots():
            if not pkg_root.exists():
                continue
            pkg_prefix = pkg_root.relative_to(config.root).as_posix()
            self.modules.update(
                load_tree(pkg_root, config.exclude, rel_prefix=pkg_prefix)
            )
        self._callgraph: CallGraph | None = None

    @property
    def callgraph(self) -> CallGraph:
        if self._callgraph is None:
            self._callgraph = build_callgraph(self.modules)
        return self._callgraph

    def doc(self, rel: str) -> Path:
        return self.root / rel


@dataclass
class LintResult:
    """One lint run: new findings fail, baselined/suppressed don't."""

    findings: list[Finding] = field(default_factory=list)     # NEW (fail)
    baselined: list[Finding] = field(default_factory=list)
    suppressed: int = 0
    stale_baseline: list[dict] = field(default_factory=list)  # fail too
    rules_run: tuple[str, ...] = ()

    @property
    def ok(self) -> bool:
        return not self.findings and not self.stale_baseline

    def counts_by_rule(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for f in self.findings + self.baselined:
            out[f.rule] = out.get(f.rule, 0) + 1
        return dict(sorted(out.items()))

    def delta_line(self) -> str:
        """The one-line vs-baseline delta the bench artifact prints."""
        by_rule = self.counts_by_rule()
        total = sum(by_rule.values())
        per = ",".join(f"{k}:{v}" for k, v in by_rule.items()) or "none"
        return (
            f"lint: {total} findings ({len(self.findings)} new, "
            f"{len(self.baselined)} baselined, "
            f"{len(self.stale_baseline)} stale baseline entries, "
            f"{self.suppressed} suppressed) by rule: {per}"
        )


# -- QFX000: suppression hygiene (lives with the engine because it lints
# the engine's own escape hatch) -----------------------------------------------


def _run_suppression_hygiene(ctx: LintContext) -> list[Finding]:
    """A ``# qfedx: ignore[...]`` without a reason is itself a finding:
    an exemption is a documented claim or it is drift. Unknown rule IDs
    in the bracket fail too — they would silently suppress nothing."""
    out: list[Finding] = []
    for rel, mod in ctx.modules.items():
        for sup in mod.suppressions.values():
            if not sup.reason:
                out.append(Finding(
                    "QFX000", rel, sup.line,
                    "suppression without a reason — say why this line is "
                    "exempt (`qfedx: ignore[<rule>] <reason>`)",
                ))
            bad = [r for r in sup.rules
                   if r != "*" and r not in _REGISTRY]
            if bad:
                out.append(Finding(
                    "QFX000", rel, sup.line,
                    f"suppression names unknown rule id(s) {bad} — it "
                    "would suppress nothing",
                ))
    return out


register(Rule(
    "QFX000", "suppression-hygiene",
    "every per-line exemption carries a reason and a real rule ID",
    _run_suppression_hygiene,
))


# -- baseline ------------------------------------------------------------------


def baseline_key(ctx: LintContext, finding: Finding) -> tuple[str, str, str]:
    mod = ctx.modules.get(finding.path)
    if mod is not None:
        text = mod.line_text(finding.line)
    else:  # doc-file findings: read the line from disk
        try:
            lines = (ctx.root / finding.path).read_text().splitlines()
            text = lines[finding.line - 1].strip() if (
                1 <= finding.line <= len(lines)
            ) else ""
        except OSError:
            text = ""
    return (finding.rule, finding.path, text)


def load_baseline(path: Path) -> list[dict]:
    if not path.exists():
        return []
    data = json.loads(path.read_text())
    return list(data.get("entries", []))


def write_baseline(path: Path, ctx: LintContext,
                   findings: list[Finding],
                   rules_run: tuple[str, ...] | None = None) -> int:
    """Rewrite the baseline from ``findings``. Entries for rules
    OUTSIDE ``rules_run`` are preserved verbatim — a ``--rules`` subset
    run never judged them (run_lint ignores them for matching and
    staleness alike), so it must not drop them either. Returns the
    entry count written."""
    preserved = (
        [e for e in load_baseline(path) if e.get("rule") not in rules_run]
        if rules_run is not None else []
    )
    entries = preserved + [
        {
            "rule": f.rule,
            "path": f.path,
            "text": baseline_key(ctx, f)[2],
            "reason": "grandfathered by --update-baseline",
        }
        for f in sorted(findings, key=lambda f: (f.rule, f.path, f.line))
    ]
    entries.sort(key=lambda e: (
        e.get("rule") or "", e.get("path") or "", e.get("text") or ""
    ))
    path.write_text(json.dumps(
        {"version": JSON_SCHEMA_VERSION, "entries": entries}, indent=2
    ) + "\n")
    return len(entries)


# -- the run -------------------------------------------------------------------


def run_lint(
    root: str | Path | None = None,
    config: LintConfig | None = None,
    rules: tuple[str, ...] | None = None,
) -> LintResult:
    """Run every registered rule (or the selected ``rules``) and apply
    suppression + baseline semantics."""
    cfg = config if config is not None else load_config(root)
    ctx = LintContext(cfg)
    selected = sorted(rules) if rules is not None else sorted(_REGISTRY)
    unknown = [r for r in selected if r not in _REGISTRY]
    if unknown:
        raise ValueError(
            f"unknown rule id(s) {unknown}; known: {sorted(_REGISTRY)}"
        )

    result = LintResult(rules_run=tuple(selected))
    raw: list[Finding] = []
    for rid in selected:
        raw.extend(_REGISTRY[rid].run(ctx))

    # Per-line suppressions. QFX000 findings are immune — a reasonless
    # suppression must not be able to suppress its own hygiene finding.
    kept: list[Finding] = []
    for f in raw:
        mod = ctx.modules.get(f.path)
        if mod is not None and f.rule != "QFX000" and mod.suppressed(
            f.line, f.rule
        ):
            result.suppressed += 1
            continue
        kept.append(f)
    kept.sort(key=lambda f: (f.rule, f.path, f.line))

    # Baseline matching: multiset on (rule, path, line text). Entries
    # for rules NOT selected this run are ignored outright — a subset
    # run can't judge them matched OR stale.
    remaining: dict[tuple, list[dict]] = {}
    for entry in load_baseline(cfg.baseline_path):
        if entry.get("rule") not in selected:
            continue
        k = (entry.get("rule"), entry.get("path"), entry.get("text"))
        remaining.setdefault(k, []).append(entry)
    for f in kept:
        bucket = remaining.get(baseline_key(ctx, f))
        if bucket:
            bucket.pop()
            result.baselined.append(f)
        else:
            result.findings.append(f)
    for bucket in remaining.values():
        result.stale_baseline.extend(bucket)
    result.stale_baseline.sort(
        key=lambda e: (e.get("rule") or "", e.get("path") or "")
    )
    return result


# -- rendering -----------------------------------------------------------------


def render_text(result: LintResult, verbose_baselined: bool = False) -> str:
    lines: list[str] = []
    for f in result.findings:
        lines.append(f"{f.location()}: {f.rule}: {f.message}")
    if verbose_baselined:
        for f in result.baselined:
            lines.append(
                f"{f.location()}: {f.rule}: {f.message} [baselined]"
            )
    for e in result.stale_baseline:
        lines.append(
            f"baseline: stale entry {e.get('rule')} at {e.get('path')} "
            f"({e.get('text', '')!r}) matches nothing — remove it or run "
            "--update-baseline"
        )
    lines.append(result.delta_line())
    return "\n".join(lines)


def render_json(result: LintResult) -> str:
    """The machine-readable report (schema v1, the reference's key for
    key)."""
    return json.dumps({
        "version": JSON_SCHEMA_VERSION,
        "ok": result.ok,
        "rules_run": list(result.rules_run),
        "counts_by_rule": result.counts_by_rule(),
        "summary": {
            "new": len(result.findings),
            "baselined": len(result.baselined),
            "suppressed": result.suppressed,
            "stale_baseline": len(result.stale_baseline),
        },
        "findings": [
            {
                "rule": f.rule, "path": f.path, "line": f.line,
                "message": f.message, "baselined": False,
            }
            for f in result.findings
        ] + [
            {
                "rule": f.rule, "path": f.path, "line": f.line,
                "message": f.message, "baselined": True,
            }
            for f in result.baselined
        ],
        "stale_baseline": result.stale_baseline,
        "delta": result.delta_line(),
    }, indent=2)
