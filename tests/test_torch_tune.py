"""Port vs reference: the online tune controller (tune/controller.py).

- The reference's drifting-load script (tests/test_tune.py's
  acceptance path) runs in both packages on the same engine and the same
  scripted ``serve.latency_ms`` records and counter deltas: singles
  traffic through the real batcher shrinks the bucket cap, a latency
  drift tightens the deadline, a firing watchdog alert reverts both to
  baseline. The decision rows of ``metrics.jsonl`` (minus ``ts``), the
  ``tune.*`` counters and gauges, the ``tune.decide`` spans and the
  flight entries are equal, and no kernel is built after warmup.
- The relax and grow directions, the pin grammar, the taxonomy and the
  constants equal the reference's.
- With ``QFEDX_TUNE`` unset the engine has no tuner, no thread and no
  ``tune.*`` instrument; the batcher reads the controller's active cap
  per flush; a live ticker's decisions reconcile across the counter,
  the rows, the flight ring and the controller's totals.

n = 4, L = 1: every invariant here is shape-independent.
"""

import json
import threading
import time
import types

import jax
import numpy as np
import pytest
import torch

from qfedx_tpu import obs as robs
from qfedx_tpu import tune as rtune
from qfedx_tpu.models.vqc import make_vqc_classifier as ref_make
from qfedx_tpu.obs import flight as rflight
from qfedx_tpu.obs import server as rserver
from qfedx_tpu.obs import trace as rtrace
from qfedx_tpu.obs import watch as rwatch
from qfedx_tpu.run.metrics import ExperimentRun as RRun
from qfedx_tpu.serve import MicroBatcher as RBatcher
from qfedx_tpu.serve import ServeConfig as RServeConfig
from qfedx_tpu.serve import ServeEngine as REngine
from qfedx_tpu_torch import obs as pobs
from qfedx_tpu_torch import tune as ptune
from qfedx_tpu_torch.models.vqc import make_vqc_classifier, params_from_jax
from qfedx_tpu_torch.obs import flight as pflight
from qfedx_tpu_torch.obs import server as pserver
from qfedx_tpu_torch.obs import trace as ptrace
from qfedx_tpu_torch.obs import watch as pwatch
from qfedx_tpu_torch.ops import scan_body
from qfedx_tpu_torch.run.metrics import ExperimentRun as PRun
from qfedx_tpu_torch.run.metrics import validate_metrics_record
from qfedx_tpu_torch.serve import MicroBatcher, ServeConfig, ServeEngine

N = 4
_PINS = ("QFEDX_TRACE", "QFEDX_TUNE", "QFEDX_WATCH", "QFEDX_FLIGHT",
         "QFEDX_METRICS_PORT", "QFEDX_SERVE_SLO_MS", "QFEDX_TUNE_HI",
         "QFEDX_TUNE_LO", "QFEDX_TUNE_SHRINK", "QFEDX_TUNE_GROW",
         "QFEDX_FAULTS")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several workers on one CPU."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _reset():
    for obs, watch, server, flight, tune in (
            (pobs, pwatch, pserver, pflight, ptune),
            (robs, rwatch, rserver, rflight, rtune)):
        server.stop_server()
        watch.reset()
        flight.reset()
        tune.clear_event_sink()
        obs.reset()


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    for pin in _PINS:
        monkeypatch.delenv(pin, raising=False)
    monkeypatch.setenv("QFEDX_GATE_FORM", "dot")
    _reset()
    yield
    _reset()


def _ref_params(seed=0):
    model = ref_make(N, 1, 2)
    return model, jax.tree.map(np.asarray,
                               model.init(jax.random.PRNGKey(seed)))


def _cfg(pkg, buckets=(1, 2, 4), deadline_ms=20.0, max_queue=64,
         slo_ms=50.0):
    cls = RServeConfig if pkg == "ref" else ServeConfig
    return cls(buckets=buckets, deadline_ms=deadline_ms, max_queue=max_queue,
               slo_ms=slo_ms)


def _engine(pkg, **kw):
    rmodel, params = _ref_params()
    if pkg == "ref":
        return REngine(rmodel, params, (N,), config=_cfg(pkg, **kw))
    return ServeEngine(make_vqc_classifier(N, 1, 2, device="cpu"),
                       params_from_jax(params, device="cpu"), (N,),
                       config=_cfg(pkg, **kw), device="cpu")


def _rows(m, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (m, N)).astype(
        np.float32)


_REF = types.SimpleNamespace(
    obs=robs, tune=rtune, watch=rwatch, flight=rflight, server=rserver,
    Run=RRun, Batcher=RBatcher,
    builds=lambda: sum(v for k, v in robs.registry().counters.items()
                       if k.startswith("compile.")))
_PORT = types.SimpleNamespace(
    obs=pobs, tune=ptune, watch=pwatch, flight=pflight, server=pserver,
    Run=PRun, Batcher=MicroBatcher, builds=lambda: scan_body.build_count)


def _drifting_load(P, engine, monkeypatch, root):
    """The reference's acceptance script, with the second burst of
    traffic scripted as counter deltas (one full flush of two), so both
    packages read the same window at every tick."""
    monkeypatch.setenv("QFEDX_TRACE", "1")
    monkeypatch.setenv("QFEDX_TUNE", "60")  # enabled; ticker dormant here
    monkeypatch.setenv("QFEDX_FLIGHT", "on")
    # Park the watchdog's p95 rule far above the drift: the one alert in
    # play is the injected trainer.loss.
    monkeypatch.setenv("QFEDX_SERVE_SLO_MS", "100000")
    P.obs.reset()
    decisions, per_tick = [], []
    with P.Run(root, name="tunerun") as run:
        engine.warmup()
        ctl = engine.tuner
        assert isinstance(ctl, P.tune.TuneController)
        builds_at_warmup = P.builds()

        def tick():
            got = ctl.decide_once()
            decisions.extend(got)
            per_tick.append([d["decision"] for d in got])
            return got

        try:
            tick()  # a counter baseline, never a decision
            # singles: mean occupancy 1.0 <= 0.25 * 4 -> shrink 4 -> 2
            with P.Batcher(engine) as b:
                for r in _rows(6):
                    b.submit(r).result(timeout=30)
            assert ctl.max_bucket == 4
            tick()
            # latency drift: window p95 >= 0.8 * SLO -> deadline 20 -> 10
            for _ in range(P.tune.MIN_WINDOW_COUNT + 4):
                P.obs.histogram("serve.latency_ms", 100.0)
            tick()
            P.obs.counter("serve.requests_served", 2.0)
            P.obs.counter("serve.batches", 1.0)
            # a firing alert: revert-to-baseline is the only legal move
            monkeypatch.setenv("QFEDX_WATCH", "1")
            P.obs.gauge("fed.loss", float("nan"))
            alerts = [a["rule"] for a in P.watch.evaluate_once()]
            tick()
            tick()  # still firing: hold still at baseline
            backoff = P.obs.registry().gauges["tune.alert_backoff"]
            P.obs.gauge("fed.loss", 0.4)
            P.watch.evaluate_once()
            tick()  # recovered: calm window + baseline = no decision
            with P.Batcher(engine) as b:
                b.submit(_rows(1)[0]).result(timeout=30)
            builds_after = P.builds()
        finally:
            ctl.stop()
        reg = P.obs.registry()
        out = {
            "per_tick": per_tick,
            "alerts": alerts,
            "backoff_while_firing": backoff,
            "totals": dict(ctl.totals),
            "active": (ctl.deadline_ms, ctl.max_bucket),
            "counters": {k: v for k, v in reg.counters.items()
                         if k.startswith("tune.")},
            "gauges": {k: v for k, v in reg.gauges.items()
                       if k.startswith("tune.")},
            "spans": [s.meta["decision"] for s in reg.spans
                      if s.name == "tune.decide"],
            "flight": [{k: v for k, v in e.items() if k != "t"}
                       for e in P.flight.events() if e["kind"] == "tune"],
            "builds": (builds_at_warmup, builds_after),
            "prometheus": sorted(
                ln for ln in P.server.render_prometheus().splitlines()
                if ln.startswith("qfedx_tune_")
                and "decide_seconds" not in ln),  # span walls differ
            "returned": [{k: v for k, v in d.items()} for d in decisions],
        }
    rows = [json.loads(line) for line in
            (run.dir / "metrics.jsonl").read_text().splitlines()]
    out["rows"] = [{k: v for k, v in r.items() if k != "ts"}
                   for r in rows if r.get("event") == "tune"]
    for r in rows:
        if r.get("event") == "tune":
            validate_metrics_record(r)
    return out


def test_drifting_load_matches_reference(monkeypatch, tmp_path):
    ref = _drifting_load(_REF, _engine("ref"), monkeypatch, tmp_path / "r")
    _reset()
    port = _drifting_load(_PORT, _engine("port"), monkeypatch,
                          tmp_path / "p")
    assert port["per_tick"] == ref["per_tick"] == [
        [], ["buckets.shrink"], ["deadline.tighten"], ["revert.alert"], [],
        []]
    assert port["rows"] == ref["rows"]
    assert [(r["decision"], r["field"], r["from"], r["to"], r["revert"])
            for r in port["rows"]] == [
        ("buckets.shrink", "max_bucket", 4, 2, False),
        ("deadline.tighten", "deadline_ms", 20.0, 10.0, False),
        ("revert.alert", "deadline_ms,max_bucket", "10,2", "20,4", True)]
    assert port["returned"] == ref["returned"]
    for key in ("alerts", "backoff_while_firing", "totals", "active",
                "counters", "gauges", "spans", "flight", "prometheus"):
        assert port[key] == ref[key], key
    assert port["totals"] == {"decisions": 3, "reverts": 1}
    assert port["counters"] == {"tune.decisions": 3.0, "tune.reverts": 1.0}
    assert port["gauges"] == {"tune.alert_backoff": 0.0,
                              "tune.active_deadline_ms": 20.0,
                              "tune.active_max_bucket": 4.0}
    assert len(port["flight"]) == 3 and port["backoff_while_firing"] == 1.0
    for line in ("qfedx_tune_decisions 3.0", "qfedx_tune_reverts 1.0",
                 "qfedx_tune_active_deadline_ms 20.0",
                 "qfedx_tune_active_max_bucket 4.0"):
        assert line in port["prometheus"]
    # Zero builds after warmup, in both packages.
    assert port["builds"][0] == port["builds"][1]
    assert ref["builds"][0] == ref["builds"][1]


def _relax_and_grow(P, engine):
    ctl = P.tune.TuneController(engine)
    ticks = [ctl.decide_once()]  # counter baseline tick
    ctl.deadline_ms = 5.0
    ctl.max_bucket = 2
    for _ in range(P.tune.MIN_WINDOW_COUNT):
        P.obs.histogram("serve.latency_ms", 1.0)  # p95 << 0.3 * SLO
    P.obs.counter("serve.requests_served", 4.0)  # occupancy 2.0 >= 0.9*2
    P.obs.counter("serve.batches", 2.0)
    ticks.append(ctl.decide_once())
    for _ in range(2):
        for _ in range(P.tune.MIN_WINDOW_COUNT):
            P.obs.histogram("serve.latency_ms", 1.0)
        ticks.append(ctl.decide_once())
    return ticks, dict(ctl.totals), (ctl.deadline_ms, ctl.max_bucket)


def test_relax_and_grow_match_reference(monkeypatch):
    monkeypatch.setenv("QFEDX_TUNE", "60")
    got = {}
    for name, P in (("ref", _REF), ("port", _PORT)):
        _reset()
        got[name] = _relax_and_grow(P, _engine(name))
    assert got["port"] == got["ref"]
    ticks, totals, active = got["port"]
    assert [[d["decision"] for d in t] for t in ticks] == [
        [], ["deadline.relax", "buckets.grow"], ["deadline.relax"], []]
    assert totals == {"decisions": 3, "reverts": 0}
    assert active == (20.0, 4)


def test_tighten_stops_at_the_floor(monkeypatch):
    """Three halvings reach baseline / DEADLINE_FLOOR_DIV; a fourth
    drift window decides nothing, in both packages."""
    monkeypatch.setenv("QFEDX_TUNE", "60")
    got = {}
    for name, P in (("ref", _REF), ("port", _PORT)):
        _reset()
        ctl = P.tune.TuneController(_engine(name))
        steps = []
        for _ in range(4):
            for _ in range(P.tune.MIN_WINDOW_COUNT):
                P.obs.histogram("serve.latency_ms", 45.0)
            steps.append([(d["decision"], d["to"])
                          for d in ctl.decide_once()])
        got[name] = steps
    assert got["port"] == got["ref"] == [
        [("deadline.tighten", 10.0)], [("deadline.tighten", 5.0)],
        [("deadline.tighten", 2.5)], []]


@pytest.mark.parametrize("value,want", [
    (None, 0.0), ("0", 0.0), ("off", 0.0), ("1", 1.0), ("on", 1.0),
    ("ON", 1.0), ("2.5", 2.5), ("0.25", 0.25)])
def test_pin_grammar_matches_reference(monkeypatch, value, want):
    if value is not None:
        monkeypatch.setenv("QFEDX_TUNE", value)
    assert ptune.interval_s() == rtune.interval_s() == want
    assert ptune.enabled() == rtune.enabled() == (want > 0)


@pytest.mark.parametrize("bad", ["fast", "-3", ""])
def test_pin_grammar_is_loud(monkeypatch, bad):
    monkeypatch.setenv("QFEDX_TUNE", bad)
    for tune in (ptune, rtune):
        with pytest.raises(ValueError, match="QFEDX_TUNE"):
            tune.interval_s()


def test_taxonomy_and_constants_match_reference():
    assert ptune.DECISION_IDS == rtune.DECISION_IDS
    assert ptune.decision_taxonomy() == rtune.decision_taxonomy()
    assert ptune.MIN_WINDOW_COUNT == rtune.MIN_WINDOW_COUNT == 16
    from qfedx_tpu.tune import controller as rctl
    from qfedx_tpu_torch.tune import controller as pctl

    assert pctl.DEADLINE_FLOOR_DIV == rctl.DEADLINE_FLOOR_DIV == 8
    with pytest.raises(ValueError, match="unknown tune decision"):
        pctl.TuneDecision("deadline.jitter", "x", "Y")


def _tuner_threads():
    return [t for t in threading.enumerate()
            if t.name == "qfedx-tune-controller"]


def test_default_off_is_static_serving():
    """QFEDX_TUNE unset: no controller, no thread, no tune.* instrument,
    and the batcher serves from its static config."""
    engine = _engine("port")
    engine.warmup()
    assert engine.tuner is None and ptune.maybe_controller(engine) is None
    assert _tuner_threads() == []
    with MicroBatcher(engine) as b:
        futs = [b.submit(r) for r in _rows(4)]
        for f in futs:
            f.result(timeout=30)
    assert b.stats["served"] == 4
    counters, gauges, histos, _ = pobs.registry().instruments()
    for group in (counters, gauges, histos):
        assert not any(k.startswith("tune.") for k in group)
    ctl = ptune.TuneController(engine)  # inert while the pin is off
    assert ctl.decide_once() == [] and not ctl.maybe_start()
    assert ctl.totals == {"decisions": 0, "reverts": 0}


@pytest.mark.parametrize("pins,want", [
    ({}, False), ({"QFEDX_TUNE": "60"}, True), ({"QFEDX_TUNE": "off"}, False),
    ({"QFEDX_TRACE": "1"}, True), ({"QFEDX_WATCH": "1"}, True)])
def test_metrics_enabled_under_tune_matches_reference(monkeypatch, pins,
                                                      want):
    for k, v in pins.items():
        monkeypatch.setenv(k, v)
    assert ptrace.metrics_enabled() == rtrace.metrics_enabled() == want
    pobs.counter("serve.batches")
    assert ("serve.batches" in pobs.registry().counters) == want


def test_batcher_reads_the_active_cap_per_flush(monkeypatch):
    """Cap 2 from the controller: two queued requests are a FULL bucket,
    not a wait for the baseline bucket of 4 under a long deadline."""
    monkeypatch.setenv("QFEDX_TUNE", "60")
    engine = _engine("port", deadline_ms=30_000.0)
    engine.warmup()
    engine.tuner.max_bucket = 2
    with MicroBatcher(engine) as b:
        futs = [b.submit(r) for r in _rows(2)]
        for f in futs:
            f.result(timeout=10)
    assert b.stats["full_flushes"] == 1 and b.stats["deadline_flushes"] == 0
    # The active deadline too: a single request under a 1 ms deadline.
    engine.tuner.deadline_ms = 1.0
    with MicroBatcher(engine) as b:
        b.submit(_rows(1)[0]).result(timeout=10)
    assert b.stats["deadline_flushes"] == 1
    engine.tuner.stop()


def test_live_ticker_reconciles(monkeypatch, tmp_path):
    """A live ticker under singles traffic: every decision names a warmed
    bucket, nothing is built after warmup, and the counter, the event
    rows, the flight entries and the controller's totals agree."""
    monkeypatch.setenv("QFEDX_TUNE", "0.02")
    # A ring larger than the run's events: no tune entry is evicted.
    monkeypatch.setenv("QFEDX_FLIGHT", "65536")
    engine = _engine("port", buckets=(1, 2, 4, 8), deadline_ms=2.0)
    with PRun(tmp_path, name="live") as run:
        engine.warmup()
        builds = scan_body.build_count
        assert len(_tuner_threads()) == 1
        try:
            with MicroBatcher(engine) as b:
                for r in _rows(60):
                    b.submit(r).result(timeout=30)
            deadline = time.monotonic() + 10
            while engine.tuner.totals["decisions"] < 1:
                assert time.monotonic() < deadline
                time.sleep(0.01)
        finally:
            engine.tuner.stop()
        assert _tuner_threads() == []
        totals = dict(engine.tuner.totals)
        assert scan_body.build_count == builds
        assert engine.tuner.max_bucket in engine.config.buckets
    rows = [json.loads(line) for line in
            (run.dir / "metrics.jsonl").read_text().splitlines()]
    tune_rows = [r for r in rows if r.get("event") == "tune"]
    assert totals["decisions"] >= 1
    assert len(tune_rows) == totals["decisions"] == pobs.registry(
    ).counters["tune.decisions"]
    assert len([e for e in pflight.events() if e["kind"] == "tune"]) == \
        totals["decisions"]
    for r in tune_rows:
        if r["field"] == "max_bucket":
            assert r["to"] in engine.config.buckets


def test_event_sink_clear_is_identity_matched():
    seen = []
    mine, other = seen.append, (lambda e: None)
    ptune.set_event_sink(mine)
    ptune.clear_event_sink(only_if=other)  # not ours: kept
    from qfedx_tpu_torch.tune import controller as pctl

    pctl._emit({"event": "tune"})
    ptune.clear_event_sink(only_if=mine)
    pctl._emit({"event": "tune"})
    assert seen == [{"event": "tune"}]

    def dying(event):
        raise RuntimeError("sink down")

    ptune.set_event_sink(dying)
    pctl._emit({"event": "tune"})  # swallowed: the ticker lives on


def test_tune_pin_no_longer_raises(monkeypatch, tmp_path):
    """QFEDX_TUNE runs a tracked run and restores a run directory."""
    from qfedx_tpu_torch.run.checkpoint import Checkpointer
    from qfedx_tpu_torch.run.config import ExperimentConfig, ModelConfig
    from qfedx_tpu_torch.run.metrics import _jsonable
    from qfedx_tpu_torch.serve.engine import engine_from_run_dir

    monkeypatch.setenv("QFEDX_TUNE", "on")
    with PRun(tmp_path, "tuned") as run:
        from qfedx_tpu_torch.tune import controller as pctl

        assert pctl._sink == run.metrics.log
    assert pctl._sink is None
    cfg = ExperimentConfig(model=ModelConfig(model="vqc", n_qubits=N,
                                             n_layers=1))
    (run.dir / "config.json").write_text(json.dumps(_jsonable(cfg)))
    model = make_vqc_classifier(N, 1, 3, device="cpu")
    Checkpointer(run.dir / "checkpoints", every=1).save(1, model.init(0))
    engine, info = engine_from_run_dir(run.dir, device="cpu")
    assert info["round"] == 1 and engine.tuner is None
    engine.warmup()
    assert isinstance(engine.tuner, ptune.TuneController)
    engine.tuner.stop()
