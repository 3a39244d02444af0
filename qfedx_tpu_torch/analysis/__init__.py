"""``lint`` — the AST static-analysis engine of the port.

Counterpart of ``qfedx_tpu/analysis/``: the same engine, loader,
baseline, suppression grammar (``# qfedx: ignore[ID] reason``), text
report and JSON schema, over ``qfedx_tpu_torch/``. The invariants the
tests can only sample are proved over the whole tree on every run:

- ``loader``      — parse the tree once into parent-annotated ASTs,
                    with per-line ``qfedx: ignore[<rule>]`` suppressions
- ``callgraph``   — who calls whom, reachability with witness paths
                    from roots given by key
- ``engine``      — rule registry (stable IDs), baseline file for
                    grandfathered findings, text + JSON reports
- ``rules_*``     — the reference's rules that carry over to eager code
                    (QFX002–QFX004, QFX100–QFX107) and the port's own
                    wiring rules (QFX006 seeded draws, QFX007 port
                    isolation, QFX008 no device fall-back)

The reference's trace purity (QFX001) and donation (QFX005) rules key
on JAX tracing and buffer donation, which the eager port has neither
of; they are not registered here (docs/TORCH_ANALYSIS.md, "Not
carried").

Entry points: ``python -m qfedx_tpu_torch lint`` (run/cli.py) and the
tier-1 gate (tests/test_torch_lint.py). docs/TORCH_ANALYSIS.md is the
operator contract — its rule-taxonomy table is enforced in both
directions by rule QFX100.

Import-light on purpose (stdlib only at import time): ``lint`` answers
in seconds and never initializes torch or a device.
"""

from qfedx_tpu_torch.analysis.engine import (  # noqa: F401
    Finding,
    LintResult,
    all_rules,
    render_json,
    render_text,
    run_lint,
)
from qfedx_tpu_torch.analysis.config import LintConfig, load_config  # noqa: F401

# Importing the rule modules registers them (engine.register at module
# scope) — the registry is populated exactly once, at package import.
from qfedx_tpu_torch.analysis import (  # noqa: F401, E402
    rules_doc,
    rules_draws,
    rules_fallback,
    rules_isolation,
    rules_locks,
    rules_pins,
    rules_prints,
    rules_spans,
)
