"""QFX100/QFX102/QFX104/QFX106/QFX107 — the doc-taxonomy contracts.

Counterpart of ``qfedx_tpu/analysis/rules_doc.py``. The port keeps every
reference name (fault sites and kinds, profile fields, alert rules,
tune decisions), so QFX102, QFX104, QFX106 and QFX107 hold the port's
code against the reference's own tables in docs/OBSERVABILITY.md and
docs/ROBUSTNESS.md: they read those tables and never edit them.

**QFX100 (rule-taxonomy).** Every registered rule ID needs a row in
docs/TORCH_ANALYSIS.md's "## Rule taxonomy" table, and every row must
name a registered rule — both directions (a lint rule nobody can look
up is as invisible as an undocumented pin; a row for a deleted rule
misdocuments the guarantees).

**QFX102 (fault-taxonomy).** ``utils/faults``'s ``doc_taxonomy()``
(derived from the ``SITES``/``*_KINDS`` code tuples) vs the
docs/ROBUSTNESS.md "## Fault-site taxonomy" table, per site and per
kind, both directions.

**QFX104 (profile-schema).** ``obs/profile.py``'s ``SUMMARY_FIELDS`` vs
the docs/OBSERVABILITY.md "## The `profile_summary.json` schema" table,
both directions.

**QFX106 (alert-taxonomy)** and **QFX107 (tune-taxonomy).**
``obs/watch.rule_taxonomy()`` and ``tune.decision_taxonomy()`` vs their
docs/OBSERVABILITY.md tables: IDs both directions, threshold pins exact.

These rules import their source-of-truth modules lazily inside ``run``
— ``lint`` must not pay a torch import when they are deselected, and
must degrade loudly (a finding, not a crash) if the contract surface
moved.
"""

from __future__ import annotations

import re
from pathlib import Path

from qfedx_tpu_torch.analysis import engine as _engine
from qfedx_tpu_torch.analysis.engine import Finding, LintContext, Rule, register

RULE_DOC = "docs/TORCH_ANALYSIS.md"
_RULE_HEADING = "## Rule taxonomy"
_RULE_ROW = re.compile(r"^\|\s*`(QFX[0-9]{3})`")

FAULT_DOC = "docs/ROBUSTNESS.md"
_FAULT_HEADING = "## Fault-site taxonomy"
_FAULT_ROW = re.compile(r"^\|\s*`([a-z0-9_.]+)`\s*\|([^|]*)\|")
_TICKED = re.compile(r"`([^`]+)`")

PROFILE_DOC = "docs/OBSERVABILITY.md"
_PROFILE_HEADING = "## The `profile_summary.json` schema"
_PROFILE_ROW = re.compile(r"^\|\s*`([a-z0-9_]+)`")


def _default_repo_root() -> Path:
    return Path(__file__).resolve().parents[2]


def _section_rows(
    path: Path, heading: str, row_re: re.Pattern, skip: str | None = None
) -> dict[str, int]:
    """``{first_cell: line}`` for table rows under ``heading`` (to the
    next heading)."""
    rows: dict[str, int] = {}
    in_section = False
    for i, line in enumerate(path.read_text().splitlines(), start=1):
        stripped = line.strip()
        if stripped.startswith("#"):
            in_section = stripped.startswith(heading)
            continue
        if not in_section:
            continue
        m = row_re.match(stripped)
        if m and m.group(1) != skip:
            rows.setdefault(m.group(1), i)
    return rows


# -- QFX100 --------------------------------------------------------------------


def documented_rules(doc_path: str | Path | None = None) -> dict[str, int]:
    path = Path(doc_path) if doc_path else _default_repo_root() / RULE_DOC
    if not path.exists():
        return {}
    return _section_rows(path, _RULE_HEADING, _RULE_ROW, skip=None)


def _run_rule_taxonomy(ctx: LintContext) -> list[Finding]:
    out: list[Finding] = []
    doc = ctx.doc(RULE_DOC)
    rows = documented_rules(doc)
    registered = _engine.all_rules()
    if not doc.exists():
        return [Finding(
            "QFX100", RULE_DOC, 1,
            f"{RULE_DOC} is missing — the rule-taxonomy table is the "
            "operator contract for every lint rule",
        )]
    for rid in sorted(registered):
        if rid not in rows:
            out.append(Finding(
                "QFX100", RULE_DOC, 1,
                f"rule {rid} ({registered[rid].title}) has no row in "
                f"the {RULE_DOC} rule-taxonomy table",
            ))
    for rid, line in sorted(rows.items()):
        if rid not in registered:
            out.append(Finding(
                "QFX100", RULE_DOC, line,
                f"rule-taxonomy row {rid} matches no registered rule "
                "(stale doc row?)",
            ))
    return out


register(Rule(
    "QFX100", "rule-taxonomy",
    "every registered lint rule has a docs/TORCH_ANALYSIS.md taxonomy row "
    "and every row names a live rule (both directions)",
    _run_rule_taxonomy,
))


# -- QFX102 --------------------------------------------------------------


def documented_taxonomy(doc_path: str | Path | None = None) -> dict:
    """``{site: (kinds...)}`` parsed from the docs/ROBUSTNESS.md
    fault-site table."""
    path = Path(doc_path) if doc_path else _default_repo_root() / FAULT_DOC
    out: dict[str, tuple[str, ...]] = {}
    in_section = False
    for line in path.read_text().splitlines():
        stripped = line.strip()
        if stripped.startswith("#"):
            in_section = stripped.startswith(_FAULT_HEADING)
            continue
        if not in_section:
            continue
        m = _FAULT_ROW.match(stripped)
        if m and m.group(1) != "site":  # skip a literal header row
            out[m.group(1)] = tuple(_TICKED.findall(m.group(2)))
    return out


def check_faults(doc_path: str | Path | None = None) -> list[str]:
    """Problem strings (empty = clean), the reference's wording."""
    from qfedx_tpu_torch.utils.faults import doc_taxonomy

    code = doc_taxonomy()
    doc = documented_taxonomy(doc_path)
    problems = []
    for site, kinds in sorted(code.items()):
        if site not in doc:
            problems.append(
                f"fault site {site} (utils/faults.py) has no row in the "
                "docs/ROBUSTNESS.md fault-site taxonomy table"
            )
            continue
        missing = [k for k in kinds if k not in doc[site]]
        if missing:
            problems.append(
                f"fault site {site}: kinds {missing} missing from its "
                "docs/ROBUSTNESS.md taxonomy row"
            )
        stale = [k for k in doc[site] if k not in kinds]
        if stale:
            problems.append(
                f"fault site {site}: taxonomy row lists {stale}, not in "
                "utils/faults.py (stale doc kinds?)"
            )
    for site in sorted(set(doc) - set(code)):
        problems.append(
            f"taxonomy row {site} matches no site in utils/faults.py "
            "(stale doc row?)"
        )
    return problems


def _run_fault_taxonomy(ctx: LintContext) -> list[Finding]:
    doc = ctx.doc(FAULT_DOC)
    if not doc.exists():
        return [Finding(
            "QFX102", FAULT_DOC, 1,
            f"{FAULT_DOC} is missing — the fault-site taxonomy is the "
            "operator contract for FaultPlan",
        )]
    try:
        problems = check_faults(doc)
    except Exception as exc:  # noqa: BLE001 — a moved surface is a finding
        return [Finding(
            "QFX102", FAULT_DOC, 1,
            f"fault-taxonomy source unavailable: {exc}",
        )]
    rows = _section_rows(doc, _FAULT_HEADING, _FAULT_ROW, skip="site")
    out = []
    for p in problems:
        # anchor on the doc row when the problem names a known site
        line = next(
            (ln for site, ln in rows.items() if site in p), 1
        )
        out.append(Finding("QFX102", FAULT_DOC, line, p))
    return out


register(Rule(
    "QFX102", "fault-taxonomy",
    "utils/faults injection sites+kinds and the docs/ROBUSTNESS.md "
    "taxonomy table agree (both directions)",
    _run_fault_taxonomy,
))


# -- QFX104 --------------------------------------------------------------


def source_fields() -> set[str]:
    """The field names ``obs.profile.summarize`` emits — the
    SUMMARY_FIELDS contract."""
    from qfedx_tpu_torch.obs.profile import SUMMARY_FIELDS

    return set(SUMMARY_FIELDS)


def documented_fields(doc_path: str | Path | None = None) -> set[str]:
    path = Path(doc_path) if doc_path else _default_repo_root() / PROFILE_DOC
    return set(_section_rows(path, _PROFILE_HEADING, _PROFILE_ROW,
                             skip="field"))


def check_profile(
    doc_path: str | Path | None = None, fields: set[str] | None = None
) -> list[str]:
    """Problem strings (empty = clean), the reference's wording."""
    fields = source_fields() if fields is None else set(fields)
    documented = documented_fields(doc_path)
    problems = [
        f"profile_summary.json field {name!r} (obs/profile.py "
        "SUMMARY_FIELDS) has no row in the docs/OBSERVABILITY.md "
        "schema table"
        for name in sorted(fields - documented)
    ]
    problems += [
        f"schema-table row {name!r} matches no SUMMARY_FIELDS entry in "
        "obs/profile.py (stale doc row?)"
        for name in sorted(documented - fields)
    ]
    return problems


def _run_profile_schema(ctx: LintContext) -> list[Finding]:
    doc = ctx.doc(PROFILE_DOC)
    if not doc.exists():
        return [Finding(
            "QFX104", PROFILE_DOC, 1,
            f"{PROFILE_DOC} is missing — it carries the "
            "profile_summary.json schema table",
        )]
    try:
        problems = check_profile(doc)
    except Exception as exc:  # noqa: BLE001 — a moved surface is a finding
        return [Finding(
            "QFX104", PROFILE_DOC, 1,
            f"profile-schema source unavailable: {exc}",
        )]
    rows = _section_rows(doc, _PROFILE_HEADING, _PROFILE_ROW, skip="field")
    out = []
    for p in problems:
        line = next((ln for f, ln in rows.items() if f"'{f}'" in p), 1)
        out.append(Finding("QFX104", PROFILE_DOC, line, p))
    return out


register(Rule(
    "QFX104", "profile-schema",
    "obs/profile SUMMARY_FIELDS and the docs/OBSERVABILITY.md "
    "profile_summary.json schema table agree (both directions)",
    _run_profile_schema,
))


# -- QFX106 (alert-rule taxonomy) ----------------------------------------------
#
# The watchdog's detection contract: every rule ID in
# obs/watch.RULES needs a row in docs/OBSERVABILITY.md's "## Alert-rule
# taxonomy" table, every row must name a live rule, and each row's
# threshold-pin cell must name the pin the rule actually reads — an
# operator paged by ``qfedx_alert_serve.shed_rate`` looks the ID up in
# exactly one place, and that place must not lie about which knob
# retunes it.

ALERT_DOC = "docs/OBSERVABILITY.md"
_ALERT_HEADING = "## Alert-rule taxonomy"
_ALERT_ROW = re.compile(r"^\|\s*`([a-z0-9_.]+)`")


def documented_alert_rules(
    doc_path: str | Path | None = None,
) -> dict[str, str]:
    """``{rule_id: threshold_pin_cell}`` parsed from the alert-rule
    taxonomy table (columns: rule ID | signal | threshold pin |
    fires on)."""
    path = Path(doc_path) if doc_path else _default_repo_root() / ALERT_DOC
    out: dict[str, str] = {}
    in_section = False
    for line in path.read_text().splitlines():
        stripped = line.strip()
        if stripped.startswith("#"):
            in_section = stripped.startswith(_ALERT_HEADING)
            continue
        if not in_section or not _ALERT_ROW.match(stripped):
            continue
        cells = [c.strip() for c in stripped.strip("|").split("|")]
        if len(cells) >= 3:
            ticked = _TICKED.findall(cells[2])
            out[cells[0].strip("`")] = ticked[0] if ticked else ""
    return out


def check_alerts(doc_path: str | Path | None = None) -> list[str]:
    """Problem strings (empty = clean), the reference's wording."""
    from qfedx_tpu_torch.obs.watch import rule_taxonomy

    code = rule_taxonomy()
    doc = documented_alert_rules(doc_path)
    problems = []
    for rid, spec in sorted(code.items()):
        if rid not in doc:
            problems.append(
                f"alert rule {rid} (obs/watch.py) has no row in the "
                "docs/OBSERVABILITY.md alert-rule taxonomy table"
            )
        elif doc[rid] != spec["threshold_pin"]:
            problems.append(
                f"alert rule {rid}: taxonomy row names threshold pin "
                f"{doc[rid]!r}, obs/watch.py reads "
                f"{spec['threshold_pin']!r}"
            )
    for rid in sorted(set(doc) - set(code)):
        problems.append(
            f"alert-rule taxonomy row {rid} matches no rule in "
            "obs/watch.py (stale doc row?)"
        )
    return problems


def _run_alert_taxonomy(ctx: LintContext) -> list[Finding]:
    doc = ctx.doc(ALERT_DOC)
    if not doc.exists():
        return [Finding(
            "QFX106", ALERT_DOC, 1,
            f"{ALERT_DOC} is missing — it carries the alert-rule "
            "taxonomy table (the watchdog's operator contract)",
        )]
    try:
        problems = check_alerts(doc)
    except Exception as exc:  # noqa: BLE001 — a moved surface is a finding
        return [Finding(
            "QFX106", ALERT_DOC, 1,
            f"alert-taxonomy source unavailable: {exc}",
        )]
    rows = _section_rows(doc, _ALERT_HEADING, _ALERT_ROW, skip="rule ID")
    out = []
    for p in problems:
        line = next((ln for rid, ln in rows.items() if rid in p), 1)
        out.append(Finding("QFX106", ALERT_DOC, line, p))
    return out


register(Rule(
    "QFX106", "alert-taxonomy",
    "obs/watch alert rules and the docs/OBSERVABILITY.md alert-rule "
    "taxonomy table agree — IDs both directions, threshold pins exact",
    _run_alert_taxonomy,
))


# -- QFX107 (tune-decision taxonomy) -------------------------------------------
#
# The auto-tuner's adaptation contract: every decision ID in
# tune/controller.DECISIONS needs a row in docs/OBSERVABILITY.md's
# "## Tune decision taxonomy" table, every row must name a live
# decision, and each row's threshold-pin cell must name the pin the
# controller actually compares against — an operator reading a
# ``{"event": "tune", "decision": "deadline.tighten"}`` row looks the
# ID up in exactly one place, and that place must not lie about which
# knob changes the behaviour.

TUNE_DOC = "docs/OBSERVABILITY.md"
_TUNE_HEADING = "## Tune decision taxonomy"
_TUNE_ROW = re.compile(r"^\|\s*`([a-z0-9_.]+)`")


def documented_tune_decisions(
    doc_path: str | Path | None = None,
) -> dict[str, str]:
    """``{decision_id: threshold_pin_cell}`` parsed from the tune
    decision taxonomy table (columns: decision ID | signal |
    threshold pin | means)."""
    path = Path(doc_path) if doc_path else _default_repo_root() / TUNE_DOC
    out: dict[str, str] = {}
    in_section = False
    for line in path.read_text().splitlines():
        stripped = line.strip()
        if stripped.startswith("#"):
            in_section = stripped.startswith(_TUNE_HEADING)
            continue
        if not in_section or not _TUNE_ROW.match(stripped):
            continue
        cells = [c.strip() for c in stripped.strip("|").split("|")]
        if len(cells) >= 3:
            ticked = _TICKED.findall(cells[2])
            out[cells[0].strip("`")] = ticked[0] if ticked else ""
    return out


def check_tune(doc_path: str | Path | None = None) -> list[str]:
    """Problem strings (empty = clean), the reference's wording."""
    from qfedx_tpu_torch.tune import decision_taxonomy

    code = decision_taxonomy()
    doc = documented_tune_decisions(doc_path)
    problems = []
    for did, spec in sorted(code.items()):
        if did not in doc:
            problems.append(
                f"tune decision {did} (tune/controller.py) has no row in "
                "the docs/OBSERVABILITY.md tune decision taxonomy table"
            )
        elif doc[did] != spec["threshold_pin"]:
            problems.append(
                f"tune decision {did}: taxonomy row names threshold pin "
                f"{doc[did]!r}, tune/controller.py reads "
                f"{spec['threshold_pin']!r}"
            )
    for did in sorted(set(doc) - set(code)):
        problems.append(
            f"tune-decision taxonomy row {did} matches no decision in "
            "tune/controller.py (stale doc row?)"
        )
    return problems


def _run_tune_taxonomy(ctx: LintContext) -> list[Finding]:
    doc = ctx.doc(TUNE_DOC)
    if not doc.exists():
        return [Finding(
            "QFX107", TUNE_DOC, 1,
            f"{TUNE_DOC} is missing — it carries the tune decision "
            "taxonomy table (the auto-tuner's operator contract)",
        )]
    try:
        problems = check_tune(doc)
    except Exception as exc:  # noqa: BLE001 — a moved surface is a finding
        return [Finding(
            "QFX107", TUNE_DOC, 1,
            f"tune-taxonomy source unavailable: {exc}",
        )]
    rows = _section_rows(doc, _TUNE_HEADING, _TUNE_ROW, skip="decision ID")
    out = []
    for p in problems:
        line = next((ln for did, ln in rows.items() if did in p), 1)
        out.append(Finding("QFX107", TUNE_DOC, line, p))
    return out


register(Rule(
    "QFX107", "tune-taxonomy",
    "tune/controller decisions and the docs/OBSERVABILITY.md tune "
    "decision taxonomy table agree — IDs both directions, threshold "
    "pins exact",
    _run_tune_taxonomy,
))
