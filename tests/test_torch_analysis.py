"""The port's lint engine (``qfedx_tpu_torch/analysis``) against the
reference's (``qfedx_tpu/analysis``), and its three rules of its own.

The carried rules (QFX000, QFX002–QFX004, QFX100–QFX107) run through
both engines on the same ``tmp_path`` trees and must give the same
``(rule, path, line, message)`` findings, the same baseline outcome and
the same JSON report (``rules_run`` aside: the registries differ by
design). The call graph's nodes, edges and reachability match the
reference's on its own fixtures. The doc-table rules give no finding on
the real docs in either package, and the same problem strings on a copy
of each doc with one row removed and one ghost row added. QFX006,
QFX007 and QFX008 each fire and stay quiet on fixtures of their own.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from qfedx_tpu import analysis as ref  # noqa: E402
from qfedx_tpu.analysis import engine as ref_engine  # noqa: E402
from qfedx_tpu.analysis.callgraph import (  # noqa: E402
    build_callgraph as ref_build_callgraph,
)
from qfedx_tpu.analysis.loader import load_tree as ref_load_tree  # noqa: E402
from qfedx_tpu_torch import analysis as port  # noqa: E402
from qfedx_tpu_torch.analysis import config as port_config  # noqa: E402
from qfedx_tpu_torch.analysis import engine as port_engine  # noqa: E402
from qfedx_tpu_torch.analysis.callgraph import build_callgraph  # noqa: E402
from qfedx_tpu_torch.analysis.loader import load_tree  # noqa: E402

ENGINES = {"ref": (ref, ref_engine), "port": (port, port_engine)}


def write_pkg(tmp_path, files: dict[str, str], pkg: str = "pkg") -> None:
    root = tmp_path / pkg
    root.mkdir(exist_ok=True)
    (root / "__init__.py").write_text("")
    for rel, text in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(text))


def configs(tmp_path, packages=("pkg",)) -> dict:
    """One LintConfig per engine over the same tree and baseline."""
    return {
        name: mod.LintConfig(root=tmp_path, packages=tuple(packages),
                             baseline=str(tmp_path / "baseline.json"))
        for name, (mod, _) in ENGINES.items()
    }


def rows(result) -> list:
    return [(f.rule, f.path, f.line, f.message) for f in result.findings]


def run_both(tmp_path, rules, packages=("pkg",)) -> dict:
    return {
        name: ENGINES[name][0].run_lint(config=cfg, rules=tuple(rules))
        for name, cfg in configs(tmp_path, packages).items()
    }


# --- the carried rules: the reference's fixtures through both engines ----------

_LOCK_CLASS = """
    import threading

    class Registry:
        def __init__(self):
            self.counters = {}
            self._lock = threading.Lock()

        def good(self, name):
            with self._lock:
                self.counters[name] = self.counters.get(name, 0) + 1

        def _bump_locked(self, name):
            self.counters[name] = 1  # caller holds the lock (convention)
"""

_KERNEL_WITH_SPANS = """
    import jax
    from jax.experimental import pallas as pl
    from qfedx_tpu.utils import obs


    def _kernel(x_ref, o_ref):
        i = pl.program_id(0)

        @pl.when(i == 0)
        def _init():
            o_ref[...] = x_ref[...]

        o_ref[...] = o_ref[...] * 2.0


    def launch(x):
        with obs.span("pallas.launch"):
            return pl.pallas_call(
                _kernel,
                out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
                grid=(1,),
            )(x)
"""

# (rules run, files, findings expected, suppressions expected)
CARRIED = {
    "qfx002_fires_on_raw_environ_and_getenv": (("QFX002",), {"mod.py": """
        import os
        a = os.environ.get("QFEDX_X")
        b = os.getenv("QFEDX_Y")
    """}, 2, 0),
    "qfx002_quiet_in_pins_module_and_helper_callers": (("QFX002",), {
        "utils/pins.py": """
            import os
            def bool_pin(name, default):
                return os.environ.get(name, default)
        """,
        "mod.py": """
            from pkg.utils import pins
            val = pins.bool_pin("QFEDX_X", False)
        """,
    }, 0, 0),
    "qfx003_fires_on_unclosed_span": (("QFX003",), {"mod.py": """
        from pkg import obs

        def f():
            sp = obs.span("leaky.phase")
            sp.__enter__()
            do_work()
    """}, 2, 0),
    "qfx003_quiet_on_with_and_assigned_with": (("QFX003",), {"mod.py": """
        from pkg import obs

        def f():
            with obs.span("clean.phase"):
                pass
            ctx = obs.span("later.phase")
            with ctx:
                pass
    """}, 0, 0),
    "qfx003_quiet_on_pallas_kernel_with_spans": (
        ("QFX003",), {"kern.py": _KERNEL_WITH_SPANS}, 0, 0),
    "qfx004_fires_on_unlocked_mutation": (("QFX004",), {"mod.py": """
        import threading

        class Registry:
            def __init__(self):
                self.counters = {}
                self._lock = threading.Lock()

            def bad(self, name):
                self.counters[name] = 0
    """}, 1, 0),
    "qfx004_quiet_under_lock_and_locked_suffix": (
        ("QFX004",), {"mod.py": _LOCK_CLASS}, 0, 0),
    "qfx105_fires_on_library_print": (("QFX105",), {"mod.py": """
        def f():
            print("progress")
    """}, 1, 0),
    "qfx105_quiet_in_cli_and_demo_and_strings": (("QFX105",), {
        "run/cli.py": "print('terminal output')\n",
        "run/demo.py": "print('walkthrough')\n",
        "mod.py": '''
            """Docs may say print() freely."""
            s = "print(x)"
        ''',
    }, 0, 0),
    "suppression_with_reason_silences_and_counts": (
        ("QFX000", "QFX002"), {"mod.py": """
        import os
        a = os.environ.get("QFEDX_X")  # qfedx: ignore[QFX002] fixture exemption
    """}, 0, 1),
    "reasonless_suppression_cannot_self_suppress": (
        ("QFX000", "QFX002"), {"mod.py": """
        import os
        a = os.environ.get("QFEDX_X")  # qfedx: ignore[QFX002,QFX000]
    """}, 1, 1),
    "unknown_rule_id_in_suppression": (("QFX000",), {"mod.py": """
        x = 1  # qfedx: ignore[QFX999] names no rule
    """}, 1, 0),
    "suppression_grammar_in_strings_is_inert": (
        ("QFX000", "QFX002"), {"mod.py": '''
        """Example: x()  # qfedx: ignore[QFX002]"""
        import os
        s = 'os.environ  # qfedx: ignore[QFX002]'; a = os.environ.get("QFEDX_X")
    '''}, 1, 0),
    "suppression_of_other_rule_does_not_silence": (("QFX002",), {"mod.py": """
        import os
        a = os.environ.get("QFEDX_X")  # qfedx: ignore[QFX003] wrong rule
    """}, 1, 0),
}


@pytest.mark.parametrize("case", sorted(CARRIED))
def test_carried_rule_fixture_matches_reference(tmp_path, case):
    rules, files, n_found, n_suppressed = CARRIED[case]
    write_pkg(tmp_path, files)
    got = run_both(tmp_path, rules)
    assert rows(got["port"]) == rows(got["ref"])
    assert len(got["port"].findings) == n_found
    assert got["port"].suppressed == got["ref"].suppressed == n_suppressed


# --- baseline semantics, the same in both engines ------------------------------


def _baseline(tmp_path, entries):
    (tmp_path / "baseline.json").write_text(
        json.dumps({"version": 1, "entries": entries}))


_ENV_MOD = {"mod.py": """
    import os
    a = os.environ.get("QFEDX_X")
"""}


def _outcome(result) -> tuple:
    return (rows(result), [(f.rule, f.path, f.line) for f in result.baselined],
            result.stale_baseline, result.ok)


@pytest.mark.parametrize("case", [
    "line_text_match", "multiset_and_stale", "unselected_rules_ignored",
])
def test_baseline_matches_reference(tmp_path, case):
    write_pkg(tmp_path, _ENV_MOD)
    text = 'a = os.environ.get("QFEDX_X")'
    rules = ("QFX002",)
    if case == "line_text_match":
        _baseline(tmp_path, [{"rule": "QFX002", "path": "pkg/mod.py",
                              "text": text, "reason": "fixture"}])
    elif case == "multiset_and_stale":
        _baseline(tmp_path, [
            {"rule": "QFX002", "path": "pkg/mod.py", "text": text},
            {"rule": "QFX002", "path": "pkg/gone.py",
             "text": "vanished = os.environ"},
        ])
    else:
        _baseline(tmp_path, [{"rule": "QFX002", "path": "pkg/mod.py",
                              "text": "whatever"}])
        rules = ("QFX004",)
    got = run_both(tmp_path, rules)
    assert _outcome(got["port"]) == _outcome(got["ref"])
    expect = {"line_text_match": (0, 1, 0, True),
              "multiset_and_stale": (0, 1, 1, False),
              "unselected_rules_ignored": (0, 0, 0, True)}[case]
    res = got["port"]
    assert (len(res.findings), len(res.baselined), len(res.stale_baseline),
            res.ok) == expect


def test_update_baseline_subset_run_matches_reference(tmp_path):
    # A --rules subset rewrite keeps the entries it never judged.
    write_pkg(tmp_path, _ENV_MOD)
    kept = {"rule": "QFX004", "path": "pkg/other.py",
            "text": "self.counters[name] = 0",
            "reason": "kept: not judged by QFX002"}
    written = {}
    for name, (mod, eng) in ENGINES.items():
        _baseline(tmp_path, [kept])
        cfg = configs(tmp_path)[name]
        result = mod.run_lint(config=cfg, rules=("QFX002",))
        n = eng.write_baseline(cfg.baseline_path, eng.LintContext(cfg),
                               result.findings + result.baselined,
                               rules_run=result.rules_run)
        written[name] = json.loads(cfg.baseline_path.read_text())
        assert n == 2
        assert mod.run_lint(config=cfg, rules=("QFX002",)).ok
    assert written["port"] == written["ref"]
    assert {e["rule"] for e in written["port"]["entries"]} == {
        "QFX002", "QFX004"}


def test_json_report_matches_reference(tmp_path):
    write_pkg(tmp_path, {"mod.py": """
        import os
        import threading

        a = os.environ.get("QFEDX_X")
        b = os.getenv("QFEDX_Y")
        c = os.environ.get("QFEDX_Z")  # qfedx: ignore[QFX002] fixture

        def f():
            print("x")

        class R:
            def __init__(self):
                self.d = {}
                self._lock = threading.Lock()

            def bad(self):
                self.d["k"] = 1
    """})
    _baseline(tmp_path, [
        {"rule": "QFX002", "path": "pkg/mod.py",
         "text": 'b = os.getenv("QFEDX_Y")', "reason": "fixture"},
        {"rule": "QFX105", "path": "pkg/gone.py", "text": "print()"},
    ])
    rules = ("QFX000", "QFX002", "QFX003", "QFX004", "QFX105")
    reports = {}
    for name, res in run_both(tmp_path, rules).items():
        data = json.loads(ENGINES[name][0].render_json(res))
        data.pop("rules_run")
        reports[name] = data
    assert reports["port"] == reports["ref"]
    assert reports["port"]["version"] == 1
    assert reports["port"]["summary"] == {
        "new": 3, "baselined": 1, "suppressed": 1, "stale_baseline": 1}


def test_unknown_rule_id_raises(tmp_path):
    write_pkg(tmp_path, {"mod.py": "x = 1\n"})
    with pytest.raises(ValueError, match="QFX999"):
        port.run_lint(config=configs(tmp_path)["port"], rules=("QFX999",))


# --- the call graph --------------------------------------------------------------

GRAPHS = {
    "direct": {"a.py": """
        import jax

        def leaf():
            return 1

        def root(x):
            return leaf() + x

        fast = jax.jit(root)
    """},
    "aliased_import": {
        "helpers.py": """
            def impure():
                return 1
        """,
        "b.py": """
            import jax
            from cgpkg.helpers import impure as imp

            def root(x):
                return imp() + x

            fast = jax.jit(root)
        """,
    },
    "method": {"c.py": """
        import jax

        class Engine:
            def helper(self):
                return 2

            @jax.jit
            def apply(self, x):
                return self.helper() * x
    """},
    "lambda_and_nested": {"d.py": """
        import jax

        def leaf(x):
            return x

        def outer():
            def inner(x):
                return x + 1
            return jax.vmap(inner), jax.jit(lambda y: leaf(y))
    """},
}


@pytest.mark.parametrize("case", sorted(GRAPHS))
def test_callgraph_matches_reference(tmp_path, case):
    """Same nodes and edges as the reference's graph, and from the
    reference's traced roots (given here by key) the same reachable
    functions and witness paths."""
    write_pkg(tmp_path, GRAPHS[case], pkg="cgpkg")
    g_ref = ref_build_callgraph(ref_load_tree(tmp_path / "cgpkg",
                                              rel_prefix="cgpkg"))
    g = build_callgraph(load_tree(tmp_path / "cgpkg", rel_prefix="cgpkg"))
    assert set(g.functions) == set(g_ref.functions)
    assert g.edges == g_ref.edges
    assert g_ref.traced_roots
    reach = g.reachable_from(g_ref.traced_roots)
    ref_reach = g_ref.reachable_from_traced()
    assert reach == ref_reach
    assert len(reach) >= 2


# --- the doc-table rules -----------------------------------------------------------

# rule: (doc, the row replaced, the ghost row put in its place)
DOC_CASES = {
    "QFX101": ("docs/OBSERVABILITY.md", "| `QFEDX_GUARDS` |",
               "| `QFEDX_GHOST_PIN` | `0`/`1` | off | run | a ghost |"),
    "QFX102": ("docs/ROBUSTNESS.md", "| `client.slow` |",
               "| `ghost.site` | `drop` | never |"),
    "QFX103": ("docs/OBSERVABILITY.md", "| `round.eval` |",
               "| `ghost.span` | nowhere | a ghost |"),
    "QFX104": ("docs/OBSERVABILITY.md", "| `ops_distinct` |",
               "| `ghost_field` | a ghost |"),
    "QFX106": ("docs/OBSERVABILITY.md", "| `serve.shed_rate` |",
               "| `ghost.alert` | nothing | `QFEDX_WATCH_SHED` | never |"),
    "QFX107": ("docs/OBSERVABILITY.md", "| `deadline.relax` |",
               "| `ghost.decision` | nothing | `QFEDX_TUNE_LO` | never |"),
}


@pytest.mark.parametrize("rule", sorted(DOC_CASES))
def test_doc_rule_clean_on_real_docs_in_both(rule):
    assert ref.run_lint(rules=(rule,)).findings == []
    assert port.run_lint(rules=(rule,)).findings == []


def _normalized(result) -> list:
    """Doc-anchored findings as they are; source-anchored ones without
    their package path and line (the packages differ there)."""
    return sorted(
        (f.rule, f.path, f.line, f.message) if f.path.startswith("docs/")
        else (f.rule, "<source>", 0, f.message)
        for f in result.findings
    )


@pytest.fixture(scope="module")
def mirror(tmp_path_factory):
    """A repo root whose packages link to the real ones (one parse of
    each for every case) and whose docs each case writes anew."""
    root = tmp_path_factory.mktemp("mirror")
    for pkg in ("qfedx_tpu", "qfedx_tpu_torch"):
        (root / pkg).symlink_to(ROOT / pkg, target_is_directory=True)
    (root / "docs").mkdir()
    return root


@pytest.mark.parametrize("rule", sorted(DOC_CASES))
def test_doc_rule_same_problems_on_edited_doc(mirror, rule):
    doc, row, ghost = DOC_CASES[rule]
    for name in ("OBSERVABILITY.md", "ROBUSTNESS.md"):
        text = (ROOT / "docs" / name).read_text()
        if f"docs/{name}" == doc:
            lines = text.splitlines()
            (i,) = [k for k, ln in enumerate(lines) if ln.startswith(row)]
            lines[i] = ghost
            text = "\n".join(lines) + "\n"
        (mirror / "docs" / name).write_text(text)
    got = {}
    for name, pkg in (("ref", "qfedx_tpu"), ("port", "qfedx_tpu_torch")):
        cfg = ENGINES[name][0].LintConfig(
            root=mirror, packages=(pkg,),
            baseline=str(mirror / "none.json"))
        got[name] = ENGINES[name][0].run_lint(config=cfg, rules=(rule,))
    assert _normalized(got["port"]) == _normalized(got["ref"])
    messages = " ".join(f.message for f in got["port"].findings)
    assert len(got["port"].findings) == 2, messages
    assert "ghost" in messages.lower()


def test_qfx101_reference_only_pins(tmp_path):
    """A reference-only row needs no port literal; a port literal of one
    is a finding, wherever it is read; any other pin keeps both
    directions."""
    (tmp_path / "docs").mkdir()
    (tmp_path / "docs" / "OBSERVABILITY.md").write_text(
        "| Pin | Values |\n|---|---|\n| `QFEDX_X` | on |\n"
        "| `QFEDX_DONATE` | on |\n| `QFEDX_COMPILE_CACHE` | on |\n"
        "| `QFEDX_STALE_ROW` | on |\n")
    write_pkg(tmp_path, {"mod.py": """
        a = "QFEDX_X"
        b = "QFEDX_DONATE"
    """})
    found = port.run_lint(config=configs(tmp_path)["port"],
                          rules=("QFX101",)).findings
    assert [(f.path, f.line) for f in found] == [
        ("docs/OBSERVABILITY.md", 6), ("pkg/mod.py", 3)]
    assert "QFEDX_STALE_ROW" in found[0].message
    assert "reference-only" in found[1].message


# --- QFX006 seeded-draws --------------------------------------------------------


def port_findings(tmp_path, rule, files):
    write_pkg(tmp_path, files)
    return port.run_lint(config=configs(tmp_path)["port"],
                         rules=(rule,)).findings


QFX006_CASES = {
    # (files, findings expected, a word every finding's message carries)
    "a_fires_on_unseeded_torch_draws": ({"mod.py": """
        import torch
        from torch import randperm

        def f(x):
            a = torch.rand(3)
            b = randperm(5)
            x.normal_()
            return torch.randn_like(x), a, b
    """}, 4, "generator"),
    "a_quiet_on_seeded_torch_draws": ({"mod.py": """
        import torch

        def f(x, g):
            x.uniform_(0, 1, generator=g)
            return torch.rand(3, generator=g), torch.normal(0.0, 1.0, (2,), generator=g)
    """}, 0, ""),
    "b_fires_on_global_reseeds": ({"mod.py": """
        import torch

        torch.manual_seed(0)
        torch.cuda.manual_seed_all(0)
        torch.seed()
    """}, 3, "reseeds"),
    "b_quiet_on_generator_seeding": ({"mod.py": """
        import torch

        g = torch.Generator().manual_seed(0)
    """}, 0, ""),
    "c_fires_on_numpy_global_state": ({"mod.py": """
        import numpy as np
        from numpy.random import shuffle

        a = np.random.rand(3)
        rng = np.random.default_rng()
        shuffle([1, 2])
    """}, 3, "np.random"),
    "c_quiet_on_seeded_numpy": ({"mod.py": """
        import numpy as np

        rng = np.random.default_rng(7)
        x = rng.normal(size=3)
        s = np.random.SeedSequence([1, 2]).generate_state(1)
        g = np.random.Generator(np.random.PCG64(3))
    """}, 0, ""),
    "d_fires_on_stdlib_random": ({"mod.py": """
        import random

        a = random.random()
        r = random.Random()
    """}, 2, "random."),
    "d_quiet_on_seeded_stdlib_random": ({"mod.py": """
        import random

        r = random.Random(5)
        x = r.random()
    """}, 0, ""),
    "e_fires_on_round_draw_outside_round_draws": ({
        "fed/round.py": """
            from pkg.fed import helpers

            def make_fed_round(g):
                def step(x):
                    return helpers.noise(x, g)
                return step
        """,
        "fed/helpers.py": """
            import torch

            def noise(x, g):
                return x + torch.randn(x.shape, generator=g)
        """,
    }, 1, "make_fed_round -> make_fed_round.step -> noise"),
    "e_quiet_off_the_round_path": ({
        "fed/round.py": """
            def make_fed_round(g):
                return g
        """,
        "models/init.py": """
            import torch

            def init(g):
                return torch.rand(3, generator=g)
        """,
    }, 0, ""),
}


@pytest.mark.parametrize("case", sorted(QFX006_CASES))
def test_qfx006_seeded_draws(tmp_path, case):
    files, n, word = QFX006_CASES[case]
    found = port_findings(tmp_path, "QFX006", files)
    assert len(found) == n, [f.message for f in found]
    assert all(word in f.message for f in found)


def test_qfx006_round_draws_methods_are_exempt(tmp_path):
    """A seeded draw inside a ``RoundDraws`` method (a nested lambda
    included) is no finding even where the graph reaches it; the same
    draw in another class of the module is."""
    from qfedx_tpu_torch.analysis import rules_draws
    from qfedx_tpu_torch.analysis.engine import LintContext

    write_pkg(tmp_path, {"fed/round.py": """
        import torch

        class RoundDraws:
            def tree(self, g):
                draw = lambda: torch.randn(3, generator=g)  # noqa: E731
                return draw(), torch.rand(2, generator=g)

        class Other:
            def tree(self, g):
                return torch.rand(2, generator=g)

        def make_fed_round(g):
            return g
    """})
    ctx = LintContext(configs(tmp_path)["port"])
    g = ctx.callgraph
    root = "pkg/fed/round.py::make_fed_round"
    lam = next(k for k in g.functions if "<lambda@" in k)
    for target in (lam, "pkg/fed/round.py::RoundDraws.tree",
                   "pkg/fed/round.py::Other.tree"):
        g.edges[root].add(target)
    found = rules_draws.round_draws(ctx)
    assert [(f.path, f.line) for f in found] == [("pkg/fed/round.py", 11)]
    assert "make_fed_round -> Other.tree" in found[0].message


# --- QFX007 port-isolation ------------------------------------------------------

QFX007_CASES = {
    "fires_on_function_scope_import_jax": ({"mod.py": """
        def f():
            import jax
            return jax
    """}, 1),
    "fires_on_from_import_of_reference": ({"mod.py": """
        from qfedx_tpu.ops import fuse
        import flax.linen as nn
    """}, 2),
    "fires_on_string_form": ({"mod.py": """
        import importlib

        def f():
            a = importlib.import_module("jax.numpy")
            b = __import__("qfedx_tpu")
            return a, b
    """}, 2),
    "fires_on_module_scope_matplotlib": ({"mod.py": """
        import matplotlib.pyplot as plt
    """}, 1),
    "quiet_on_port_and_lookalikes": ({"mod.py": """
        import importlib
        import jaxtyping
        import qfedx_tpu_torch.ops
        from qfedx_tpu_torch.utils import pins

        def plot():
            import matplotlib
            return importlib.import_module("qfedx_tpu_torch.obs")
    """}, 0),
}


@pytest.mark.parametrize("case", sorted(QFX007_CASES))
def test_qfx007_port_isolation(tmp_path, case):
    files, n = QFX007_CASES[case]
    found = port_findings(tmp_path, "QFX007", files)
    assert len(found) == n, [f.message for f in found]


# --- QFX008 no-device-fallback --------------------------------------------------

QFX008_CASES = {
    "a_fires_on_plain_version_in_except": ({"mod.py": """
        from pkg.ops import scan_body_plain

        def run(x, launch):
            try:
                return launch(x)
            except RuntimeError:
                return scan_body_plain(x)
    """}, 1, "plain version"),
    "a_fires_on_cpu_moves_in_except": ({"mod.py": """
        import torch

        def run(x, launch):
            try:
                return launch(x)
            except RuntimeError:
                y = x.cpu()
                z = x.to("cpu")
                return torch.zeros(3, device="cpu"), y, z
    """}, 3, "CPU"),
    "a_quiet_when_the_handler_raises": ({"mod.py": """
        def run(x, launch):
            try:
                return launch(x)
            except RuntimeError as exc:
                raise RuntimeError("launch failed") from exc
        y = [1].copy()
    """}, 0, ""),
    "b_fires_on_availability_branch_to_cpu": ({"mod.py": """
        import torch

        dev = "cuda" if torch.cuda.is_available() else "cpu"
        if torch.cuda.device_count() > 0:
            d = torch.device("cuda")
        else:
            d = torch.device("cpu")
    """}, 2, "torch.cuda"),
    "b_quiet_without_a_cpu_branch": ({"mod.py": """
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        x = torch.zeros(1).cpu()
    """}, 0, ""),
}


@pytest.mark.parametrize("case", sorted(QFX008_CASES))
def test_qfx008_no_device_fallback(tmp_path, case):
    files, n, word = QFX008_CASES[case]
    found = port_findings(tmp_path, "QFX008", files)
    assert len(found) == n, [f.message for f in found]
    assert all(word in f.message for f in found)


# --- config and import weight ------------------------------------------------------


@pytest.mark.parametrize("parser", ["tomllib", "fallback"])
def test_config_section_through_both_parsers(tmp_path, monkeypatch, parser):
    (tmp_path / "pyproject.toml").write_text(textwrap.dedent("""
        [tool.qfedx.lint]
        packages = ["qfedx_tpu"]

        [tool.qfedx_tpu_torch.lint]
        # the port's own section
        packages = ["src_a", "src_b"]
        exclude = ["__pycache__", "gen"]
        baseline = "lint/base.json"
        unknown = { a = 1 }

        [tool.other]
        packages = ["nope"]
    """))
    if parser == "fallback":
        monkeypatch.setitem(sys.modules, "tomllib", None)
    cfg = port.load_config(tmp_path)
    assert cfg.packages == ("src_a", "src_b")
    assert cfg.exclude == ("__pycache__", "gen")
    assert cfg.baseline == "lint/base.json"
    assert cfg.baseline_path == tmp_path / "lint/base.json"


def test_config_defaults_without_a_section(tmp_path):
    (tmp_path / "pyproject.toml").write_text("[tool.qfedx.lint]\n"
                                             'packages = ["qfedx_tpu"]\n')
    cfg = port.load_config(tmp_path)
    assert cfg.packages == ("qfedx_tpu_torch",)
    assert cfg.exclude == ("__pycache__", "_build")
    assert cfg.baseline == "qfedx_tpu_torch/analysis/lint_baseline.json"
    assert port_config._fallback_parse(
        (tmp_path / "pyproject.toml").read_text()) == {}
    assert port.load_config().root == ROOT


def test_importing_the_engine_loads_no_torch():
    probe = ("import sys, qfedx_tpu_torch.analysis; print(sorted(m for m "
             "in sys.modules if m.split('.')[0] in ('torch', 'numpy', "
             "'jax', 'qfedx_tpu')))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"
