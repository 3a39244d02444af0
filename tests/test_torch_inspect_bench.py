"""Port vs reference: ``inspect`` and ``bench history`` (run/cli.py).

- A traced, profiled port run directory that also holds alert and tune
  event rows, ``flight.json``, ``best_config.json`` and, beside it, a
  ``BENCH_r*.json`` trajectory: the port's ``run_inspect`` returns the
  same dict as the reference's ``run_inspect`` on that directory (both
  read the same route pins), ``floor_attribution`` included, and so it
  does on a directory with a torn artifact and an invalid row.
- ``bench history`` on ``BENCH_r*`` fixtures written into ``tmp_path``:
  the same report and exit codes as the reference's — the regression
  gate and ``--no-gate``, provenance, the parsed tail, an unparseable
  file, numeric sort, and 2 on an empty directory.
"""

import functools
import json

import numpy as np
import pytest
import torch

from qfedx_tpu.ops import fuse as rfuse
from qfedx_tpu.run import cli as rcli
from qfedx_tpu_torch import obs as pobs
from qfedx_tpu_torch import tune as ptune
from qfedx_tpu_torch.obs import flight as pflight
from qfedx_tpu_torch.obs import profile as pprofile
from qfedx_tpu_torch.obs import server as pserver
from qfedx_tpu_torch.obs import watch as pwatch
from qfedx_tpu_torch.run import cli as pcli
from qfedx_tpu_torch.run import config as pconfig
from qfedx_tpu_torch.run.metrics import ExperimentRun
from qfedx_tpu_torch.serve.engine import engine_from_run_dir

N = 4
_PINS = ("QFEDX_TRACE", "QFEDX_TRACE_XLA", "QFEDX_TUNE", "QFEDX_WATCH",
         "QFEDX_FLIGHT", "QFEDX_PROFILE", "QFEDX_METRICS_PORT",
         "QFEDX_SERVE_BUCKETS", "QFEDX_SERVE_DEADLINE_MS",
         "QFEDX_SERVE_SLO_MS")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several workers on one CPU."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _reset():
    pwatch.reset()
    pserver.stop_server()
    pflight.reset()
    ptune.clear_event_sink()
    pobs.reset()


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    """Pins unset before and restored after (``--trace`` and
    ``--tuned`` write them through utils/pins); one route for both."""
    for pin in _PINS:
        monkeypatch.setenv(pin, "")
        monkeypatch.delenv(pin)
    for pin in ("QFEDX_FUSE", "QFEDX_SCAN_LAYERS", "QFEDX_BATCHED"):
        monkeypatch.setenv(pin, "1")
    monkeypatch.setenv("QFEDX_PALLAS", "0")
    monkeypatch.setattr(rfuse, "_gather_ok", lambda: True)
    monkeypatch.setattr(rfuse, "_growmat_merge_ok", lambda: True)
    _reset()
    yield
    _reset()


def _bench(path, n, parsed=None, tail=None, rc=0):
    rec = {"rc": rc, "parsed": parsed}
    if tail is not None:
        rec["tail"] = tail
    (path / f"BENCH_r{n:02d}.json" if n < 100 else
     path / f"BENCH_r{n}.json").write_text(json.dumps(rec))


def _traced_run(root, monkeypatch):
    """A port run directory holding every artifact ``inspect`` reads."""
    monkeypatch.setattr(pcli, "DataConfig", functools.partial(
        pconfig.DataConfig, synthetic_train=192, synthetic_test=96))
    pcli.main(["train", "--model", "vqc", "--qubits", str(N), "--layers",
               "1", "--classes", "0,1", "--clients", "2", "--rounds", "2",
               "--local-epochs", "1", "--checkpoint-every", "1",
               "--rounds-per-call", "1", "--trace", "--profile",
               "--run-root", str(root), "--name", "run"], device="cpu")
    run = root / "run"
    pcli.main(["tune", "--run-dir", str(run), "--buckets", "1,2",
               "--deadlines", "5", "--requests", "8", "--slo-ms", "1000"],
              device="cpu")
    # Tune and alert rows, through the run's own sinks.
    monkeypatch.setenv("QFEDX_TUNE", "60")
    monkeypatch.setenv("QFEDX_FLIGHT", "on")
    with ExperimentRun(root, "run", resume=True):
        engine, _ = engine_from_run_dir(run, device="cpu")
        engine.warmup()
        ctl = engine.tuner
        for _ in range(ptune.MIN_WINDOW_COUNT):
            pobs.histogram("serve.latency_ms", 900.0)
        assert [d["decision"] for d in ctl.decide_once()] == [
            "deadline.tighten"]
        monkeypatch.setenv("QFEDX_WATCH", "1")
        pobs.gauge("fed.loss", float("nan"))
        pwatch.evaluate_once()
        assert [d["decision"] for d in ctl.decide_once()] == [
            "revert.alert"]
        ctl.stop()
        pflight.dump(run / "flight.json", reason="test")
    for name in ("metrics.jsonl", "summary.json", "profile_summary.json",
                 "config.json", "flight.json", "best_config.json"):
        assert (run / name).is_file(), name
    return run


def test_inspect_matches_reference(tmp_path, monkeypatch, capsys):
    root = tmp_path / "runs"
    root.mkdir()
    run = _traced_run(root, monkeypatch)
    # A trajectory beside the run root: both attach its compact row.
    _bench(tmp_path, 4, {"metric": "m", "value": 10.0})
    _bench(tmp_path, 5, {"metric": "m", "value": 12.0})
    capsys.readouterr()
    got = pcli.main(["inspect", str(run)], device="cpu")
    port_out = capsys.readouterr().out
    want = rcli.run_inspect(run)
    assert got == want
    assert got["tune_decisions"] == {"deadline.tighten": 1,
                                     "revert.alert": 1}
    assert got["tune_reverts"] == 1
    assert got["alerts_fired"] == {"serve.p95_slo": 1, "trainer.loss": 1}
    assert got["event_rows"] == 4 and got["rounds_completed"] == 2
    assert got["flight"]["reason"] == "test"
    assert got["tune"]["cells"] == 1
    assert got["floor_attribution"]["ops_executed"] == got["profile"][
        "ops_executed"] is not None
    assert got["bench_history"]["latest"] == 5
    assert got["route"] == {"fuse": True, "scan_layers": True,
                            "pallas": False}
    assert port_out.splitlines()[-1] == "[qfedx_tpu_torch] " + json.dumps(got)


def test_inspect_flags_bad_rows_and_torn_artifacts_as_reference(tmp_path):
    run = tmp_path / "run"
    run.mkdir()
    rows = [{"schema": 1, "round": 1, "ts": 1.0, "accuracy": 0.5,
             "loss": 0.7, "rejected_updates": 1},
            {"schema": 1, "round": 2, "ts": 2.0, "accuracy": 0.6,
             "loss": 0.6, "epsilon": 1.5, "skipped": True},
            {"schema": 2, "round": 3, "ts": 3.0},
            {"schema": 1, "event": "alert", "ts": 4.0, "rule": "fed.stall",
             "state": "firing"}]
    (run / "metrics.jsonl").write_text(
        "".join(json.dumps(r) + "\n" for r in rows) + "{torn\n")
    (run / "summary.json").write_text('{"final_accuracy": 0.6')
    (run / "config.json").write_text(json.dumps(
        {"model": {"model": "vqc", "n_qubits": 4, "n_layers": 1}}))
    (run / "flight.json").write_text("nope")
    got = pcli.run_inspect(run)
    assert got == rcli.run_inspect(run)
    assert got["invalid_rows"] == 2
    assert got["unreadable_artifacts"] == ["summary.json", "flight.json"]
    assert got["ledger"] == {"rejected_updates": 1}
    with pytest.raises(FileNotFoundError):
        pcli.run_inspect(tmp_path / "absent")


def _history(mod_main, argv, capsys):
    capsys.readouterr()
    with pytest.raises(SystemExit) as exc:
        mod_main(argv)
    out = capsys.readouterr().out.splitlines()
    return exc.value.code, out


def _both(argv, capsys):
    rc_p, out_p = _history(functools.partial(pcli.main, device="cpu"), argv,
                           capsys)
    rc_r, out_r = _history(rcli.main, argv, capsys)
    return (rc_p, out_p), (rc_r, out_r)


def _payload(lines, prefix):
    """The report: the last line of the form ``<prefix>{...}``."""
    last = [ln for ln in lines if ln.startswith(prefix + "{")][-1]
    return json.loads(last[len(prefix):])


def _ledger(d):
    d.mkdir()
    _bench(d, 1, {"metric": "m", "value": 5.0})  # pre-r04: excluded
    _bench(d, 4, None, tail='noise {"metric": "m", "value": 100.0, '
                            '"per_dispatch_value": 7.0} trailing')
    _bench(d, 5, {"metric": "m", "value": 110.0, "per_dispatch_value": 7.1,
                  "engine_fwd_grad_ms": {"n18": 20.0}})
    _bench(d, 9, {"metric": "m", "value": 90.0, "backend": "tpu",
                  "per_dispatch_value": 6.0,
                  "engine_fwd_grad_ms": {"n18": 19.0},
                  "time_to_target": {"seconds": 3.0}})
    _bench(d, 10, {"metric": "m", "value": 60.0, "backend": "cpu",
                   "engine_fwd_grad_ms": {"n18": 30.0}})
    (d / "BENCH_r11.json").write_text("{not json")
    return d


@pytest.mark.parametrize("extra", [[], ["--json"], ["--no-gate"],
                                   ["--json", "--no-gate"]])
def test_bench_history_matches_reference(tmp_path, capsys, extra):
    d = _ledger(tmp_path / "ledger")
    (rc_p, out_p), (rc_r, out_r) = _both(
        ["bench", "history", "--dir", str(d), *extra], capsys)
    assert rc_p == rc_r == (0 if "--no-gate" in extra else 1)
    if "--json" in extra:
        assert len(out_p) == len(out_r) == 1
        got, want = json.loads(out_p[0]), json.loads(out_r[0])
    else:
        got = _payload(out_p, "[qfedx_tpu_torch] ")
        want = _payload(out_r, "[qfedx_tpu] ")
        assert [ln.split("] ", 1)[1] for ln in out_p] == [
            ln.split("] ", 1)[1] for ln in out_r]
    assert got == want
    assert [r["round"] for r in got["rows"]] == [1, 4, 5, 9, 10, 11]
    rows = {r["round"]: r for r in got["rows"]}
    assert rows[4]["recovered_from_tail"] and rows[1]["methodology"] == \
        "pre-r04"
    assert rows[10]["provenance"] == "cpu" and not rows[11]["parseable"]
    v = got["verdicts"]
    assert v["value"]["verdict"] == "no-prior-same-provenance"
    assert v["engine_fwd_grad_ms.n18"]["verdict"] == \
        "no-prior-same-provenance"
    assert v["per_dispatch_value"]["verdict"] == "regressed"
    assert got["regressed"] == ["per_dispatch_value"]
    assert v["time_to_target.seconds"] == {"verdict": "n/a", "points": 1}


def test_bench_history_regression_gate(tmp_path, capsys):
    d = tmp_path / "gate"
    d.mkdir()
    _bench(d, 4, {"metric": "m", "value": 100.0})
    _bench(d, 5, {"metric": "m", "value": 94.0})
    (rc_p, out_p), (rc_r, out_r) = _both(
        ["bench", "history", "--dir", str(d)], capsys)
    assert rc_p == rc_r == 1
    assert out_p[-1].endswith("REGRESSED: value")
    got = json.loads(out_p[-2].split("] ", 1)[1])
    assert got == json.loads(out_r[-2].split("] ", 1)[1])
    assert got["regressed"] == ["value"]
    _bench(d, 6, {"metric": "m", "value": 99.0})  # recovered: improved
    (rc_p, _), (rc_r, _) = _both(["bench", "history", "--dir", str(d)],
                                 capsys)
    assert rc_p == rc_r == 0


def test_bench_history_empty_dir(tmp_path, capsys):
    (rc_p, out_p), (rc_r, out_r) = _both(
        ["bench", "history", "--dir", str(tmp_path)], capsys)
    assert rc_p == rc_r == 2
    assert out_p[-1].startswith("[qfedx_tpu_torch] no BENCH_r*.json")


def test_bench_history_of_this_checkout(capsys):
    """The committed trajectory of the reference: same report."""
    (rc_p, out_p), (rc_r, out_r) = _both(
        ["bench", "history", "--json"], capsys)
    assert rc_p == rc_r
    assert json.loads(out_p[0]) == json.loads(out_r[0])


def test_floor_attribution_matches_reference():
    from qfedx_tpu.obs import profile as rprofile

    summary = {"ops_executed": 10, "gap_p50_us": 3.5, "device_lanes": 1,
               "device_busy_fraction": 0.25}
    for static in (None, 40):
        assert pprofile.floor_attribution(static, summary) == \
            rprofile.floor_attribution(static, summary)
    assert pprofile.floor_attribution(None, {})["ops_executed"] is None
    assert np.isclose(pprofile.floor_attribution(
        40, summary)["gap_us_per_op"], 3.5)
