"""Tier-1 gate: the port is lint-clean modulo its committed baseline.

``python -m qfedx_tpu_torch lint`` (qfedx_tpu_torch/analysis,
docs/TORCH_ANALYSIS.md) proves the invariants tests can only sample:
pin discipline, span and lock hygiene, seeded draws, port isolation, no
device fall-back, and every doc-taxonomy contract against the
reference's own tables. This test wires it into the suite so a
violation fails here, as tests/test_lint.py does for the reference. The
engine's fixtures live in tests/test_torch_analysis.py.

It also holds the primary gating the lint rules exist to keep: with
``utils/host.is_primary`` false (a non-zero rank of a process group),
``train`` and ``run_sweep`` print nothing and write no plot, trace or
result.
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from qfedx_tpu.run import cli as ref_cli  # noqa: E402
from qfedx_tpu_torch.analysis import (  # noqa: E402
    all_rules,
    render_text,
    run_lint,
)
from qfedx_tpu_torch.run import checkpoint as pcheckpoint  # noqa: E402
from qfedx_tpu_torch.run import cli as pcli  # noqa: E402
from qfedx_tpu_torch.run import metrics as pmetrics  # noqa: E402
from qfedx_tpu_torch.run import sweep as psweep  # noqa: E402
from qfedx_tpu_torch.utils import host  # noqa: E402

RULES = {
    "QFX000", "QFX002", "QFX003", "QFX004", "QFX006", "QFX007", "QFX008",
    "QFX100", "QFX101", "QFX102", "QFX103", "QFX104", "QFX105", "QFX106",
    "QFX107",
}


@pytest.fixture(scope="module")
def result():
    return run_lint()


def test_port_is_clean_modulo_baseline(result):
    assert result.findings == [], (
        "lint found non-baselined findings:\n" + render_text(result))
    assert result.stale_baseline == [], (
        "stale baseline entries (their findings were fixed — remove "
        f"them): {result.stale_baseline}")
    # The port's baseline grandfathers nothing.
    assert result.baselined == []


def test_every_rule_is_registered_and_ran(result):
    # The reference's rules that carry over to eager code, and the
    # port's three in place of trace purity (QFX001) and donation
    # (QFX005).
    assert set(all_rules()) == RULES
    assert set(result.rules_run) == RULES


def test_real_sites_are_accounted_for(result):
    # The reasoned suppressions, pinned: 5 in run/config.py's
    # QFEDX_SCAN_LAYERS save/restore ledger (QFX002), obs/trace.py's
    # profiler range bridge and obs/profile.py's profiler enter (QFX003),
    # fed/client.py's shuffle stream and fed/secure_agg.py's pair-mask
    # stream (QFX006). Growing this number should be a conscious diff
    # here (docs/TORCH_ANALYSIS.md policy).
    assert result.suppressed == 9, (
        f"reasoned suppressions changed: {result.suppressed} != 9")


def _lint(*args) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-m", "qfedx_tpu_torch", "lint", *args], cwd=ROOT,
        capture_output=True, text=True, timeout=300)


def test_cli_lint_json_and_one_rule():
    proc = _lint("--json")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    data = json.loads(proc.stdout)
    assert data["version"] == 1 and data["ok"] is True
    assert set(data["rules_run"]) == RULES
    assert data["summary"]["new"] == 0
    proc = _lint("--rules", "QFX105")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().splitlines()[-1].startswith("lint: 0 findings")


def _lint_flags(parser) -> list:
    sub = next(a for a in parser._actions
               if a.__class__.__name__ == "_SubParsersAction")
    lint = sub.choices["lint"]
    return sorted((tuple(a.option_strings), a.dest, a.default)
                  for a in lint._actions)


def test_lint_parser_flags_match_reference():
    assert _lint_flags(pcli.build_parser()) == _lint_flags(
        ref_cli.build_parser())


# --- primary gating ---------------------------------------------------------------


@pytest.fixture
def non_primary(monkeypatch):
    for mod in (host, pmetrics, pcheckpoint):
        monkeypatch.setattr(mod, "is_primary", lambda: False)
    monkeypatch.setenv("QFEDX_TRACE", "0")


def test_train_on_a_non_primary_process_is_silent(tmp_path, capsys,
                                                   non_primary):
    pytest.importorskip("matplotlib")
    argv = ["train", "--model", "vqc", "--qubits", "4", "--layers", "1",
            "--classes", "0,1", "--clients", "2", "--rounds", "1",
            "--local-epochs", "1", "--checkpoint-every", "1",
            "--run-root", str(tmp_path), "--name", "rank1", "--trace",
            "--plots"]
    summary = pcli.main(argv, device="cpu")
    assert summary["rounds"] == 1
    out, err = capsys.readouterr()
    assert out == "" and err == ""
    assert [p for p in tmp_path.rglob("*")] == []


@pytest.mark.parametrize("primary", [True, False])
def test_sweep_writes_results_only_on_the_primary(tmp_path, capsys,
                                                  monkeypatch, primary):
    monkeypatch.setattr(host, "is_primary", lambda: primary)
    monkeypatch.setattr(psweep, "_run_cell", lambda cell, seed, **k: {
        "accuracy": 0.5, "auc": None, "epsilon": None, "wall_s": 1.0,
        "round_s": 0.1, "comm_mb_per_round": 0.0})
    plotted = []
    monkeypatch.setattr(psweep, "_plots", lambda *a: plotted.append(a))
    result = psweep.run_sweep(preset="quick", seeds=1, root=tmp_path,
                              cells=[psweep._cell("tiny", qubits=4)],
                              device="cpu")
    out = tmp_path / "sweep-quick"
    assert result["dir"] == str(out)
    assert set(result["aggregates"]) == {"tiny"}
    printed = capsys.readouterr().out
    if primary:
        assert (out / "results.json").exists()
        assert (out / "results.md").exists()
        assert len(plotted) == 1 and "[sweep]" in printed
    else:
        assert not out.exists() and plotted == [] and printed == ""
