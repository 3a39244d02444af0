"""Port vs reference: the observability seams on whole runs.

- ``train --trace`` at n = 4 through both CLIs on the same synthetic
  data: the span names of ``trace.json``, ``summary.json``'s
  ``phase_breakdown`` keys, its counters and the rows' ``phases`` keys
  are equal (the reference's XLA compile counters and ``compile_s`` —
  the port builds nothing on the CPU — aside). θ traced equals θ
  untraced bit for bit, and the trainer's dispatch/fetch spans pair up.
- The streamed trainer under a small fault plan, traced, with the
  watchdog's event sink on each package's ``ExperimentRun``: the span
  names, the ``fed.*``, ``ingest.*`` and ``faults.injected.*`` counters
  and the alert rows of ``metrics.jsonl`` are equal.
- ``serve --trace`` writes ``serve_trace.json`` whose ``serve.compute``
  spans equal ``serve.batches``, each carrying its request ids; the
  CLI's p95 is within one histogram bucket of the exact quantile.
- A SIGTERM inside a tracked run with ``QFEDX_FLIGHT=on`` leaves
  ``flight.json`` (and, traced, ``trace.json`` and a partial summary)
  in the run directory.
"""

import functools
import json
import os
import signal

import jax
import numpy as np
import pytest
import torch

import _torch_ref_streams as streams
from qfedx_tpu import obs as robs
from qfedx_tpu.data.stream import ArrayRegistry as RArrayRegistry
from qfedx_tpu.fed.config import FedConfig as RFedConfig
from qfedx_tpu.fed.round import client_mesh
from qfedx_tpu.models.vqc import make_vqc_classifier as ref_make
from qfedx_tpu.obs import flight as rflight
from qfedx_tpu.obs import server as rserver
from qfedx_tpu.obs import watch as rwatch
from qfedx_tpu.ops import fuse as rfuse
from qfedx_tpu.run import cli as rcli
from qfedx_tpu.run import config as rconfig
from qfedx_tpu.run.metrics import ExperimentRun as RRun
from qfedx_tpu.run.metrics import validate_metrics_record
from qfedx_tpu.run.trainer import train_federated_streamed as ref_streamed
from qfedx_tpu.utils.faults import FaultPlan as RFaultPlan
from qfedx_tpu_torch import obs as pobs
from qfedx_tpu_torch.data.stream import ArrayRegistry
from qfedx_tpu_torch.fed.config import FedConfig
from qfedx_tpu_torch.models.vqc import make_vqc_classifier, params_from_jax
from qfedx_tpu_torch.obs import flight as pflight
from qfedx_tpu_torch.obs import server as pserver
from qfedx_tpu_torch.obs import watch as pwatch
from qfedx_tpu_torch.run import cli as pcli
from qfedx_tpu_torch.run import config as pconfig
from qfedx_tpu_torch.run.checkpoint import Checkpointer
from qfedx_tpu_torch.run.metrics import ExperimentRun
from qfedx_tpu_torch.run.trainer import (
    train_federated,
    train_federated_streamed,
)
from qfedx_tpu_torch.utils.faults import FaultPlan

N = 4
_PINS = ("QFEDX_TRACE", "QFEDX_TRACE_XLA", "QFEDX_FLIGHT", "QFEDX_WATCH",
         "QFEDX_METRICS_PORT", "QFEDX_PROFILE", "QFEDX_TUNE", "QFEDX_FAULTS",
         "QFEDX_WATCH_LOSS_MAX", "QFEDX_STALE", "QFEDX_HIER", "QFEDX_GUARDS",
         "QFEDX_STREAM")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several workers on one CPU."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _reset():
    for watch, server, obs, flight in ((pwatch, pserver, pobs, pflight),
                                       (rwatch, rserver, robs, rflight)):
        watch.reset()
        server.stop_server()
        obs.reset()
        flight.reset()


@pytest.fixture(autouse=True)
def form(monkeypatch):
    """The reference's program shape below n = 10; every obs pin unset
    (``--trace`` sets QFEDX_TRACE for the process: restored after)."""
    for pin in ("QFEDX_FUSE", "QFEDX_SCAN_LAYERS", "QFEDX_BATCHED"):
        monkeypatch.setenv(pin, "1")
    monkeypatch.setenv("QFEDX_PALLAS", "0")
    monkeypatch.setenv("QFEDX_GATE_FORM", "dot")
    monkeypatch.setenv("QFEDX_SLAB_LANES", "matmul")
    monkeypatch.setattr(rfuse, "_gather_ok", lambda: True)
    monkeypatch.setattr(rfuse, "_growmat_merge_ok", lambda: True)
    for pin in _PINS:
        monkeypatch.delenv(pin, raising=False)
    _reset()
    yield
    _reset()


@pytest.fixture()
def small_data(monkeypatch):
    """Both CLIs at one small synthetic set (the flags do not size it)."""
    for cli, cfg in ((pcli, pconfig), (rcli, rconfig)):
        monkeypatch.setattr(cli, "DataConfig", functools.partial(
            cfg.DataConfig, synthetic_train=192, synthetic_test=96))


def _argv(root, name, *extra):
    return ["train", "--model", "vqc", "--qubits", str(N), "--layers", "1",
            "--classes", "0,1", "--clients", "2", "--rounds", "2",
            "--local-epochs", "1", "--checkpoint-every", "1",
            "--rounds-per-call", "1", "--lr", "0.1", "--run-root",
            str(root), "--name", name, *extra]


def _span_names(path) -> set:
    return {e["name"] for e in json.loads(path.read_text())["traceEvents"]
            if e["ph"] == "X"}


def _counters(summary: dict) -> dict:
    return {k: v for k, v in summary.get("obs_counters", {}).items()
            if not k.startswith("compile.")}


def _theta(run_dir) -> list:
    with np.load(run_dir / "checkpoints" / "ckpt_000002.npz") as z:
        return [z[f"arr_{i}"] for i in range(len(z))]


def test_traced_cli_train_matches_reference(tmp_path, small_data,
                                            monkeypatch):
    args = rcli.build_parser().parse_args(_argv(tmp_path, "ref"))
    rcli.run_train(rcli.config_from_args(args), trace=True)
    _reset()
    pcli.main(_argv(tmp_path, "port", "--trace"), device="cpu")
    monkeypatch.delenv("QFEDX_TRACE")
    ref, port = tmp_path / "ref", tmp_path / "port"
    assert _span_names(port / "trace.json") == _span_names(ref / "trace.json")
    rsum, psum = (json.loads((d / "summary.json").read_text())
                  for d in (ref, port))
    assert set(psum["phase_breakdown"]) == set(rsum["phase_breakdown"])
    assert _counters(psum) == _counters(rsum)
    rows = {d: [json.loads(x) for x in (d / "metrics.jsonl").read_text()
                .splitlines()] for d in (ref, port)}
    for pr, rr in zip(rows[port], rows[ref]):
        validate_metrics_record(pr)
        assert set(pr["phases"]) == set(rr["phases"]) - {"compile_s"}
    ev = [e for e in json.loads((port / "trace.json").read_text())[
        "traceEvents"] if e["ph"] == "X"]
    dispatch = [e["args"]["round"] for e in ev if e["name"] ==
                "round.dispatch"]
    assert dispatch == [e["args"]["round"] for e in ev
                        if e["name"] == "round.fetch"] == [1, 2]
    # Tracing changes nothing: θ untraced is θ traced, bit for bit.
    _reset()
    pcli.main(_argv(tmp_path, "plain"), device="cpu")
    assert not (tmp_path / "plain" / "trace.json").exists()
    for a, b in zip(_theta(port), _theta(tmp_path / "plain")):
        assert np.array_equal(a, b)


def test_profiled_cli_train_writes_profile_summary(tmp_path, small_data,
                                                   monkeypatch):
    pcli.main(_argv(tmp_path, "prof", "--trace", "--profile",
                    "--rounds", "1"), device="cpu")
    monkeypatch.delenv("QFEDX_TRACE")
    run = tmp_path / "prof"
    summary = json.loads((run / "profile_summary.json").read_text())
    assert summary["ops_executed"] > 0 and summary["schema"] == 1
    assert "round.dispatch" in summary["spans"]
    assert not pobs.xla_annotations_enabled()  # the bridge is cleared
    trace = json.loads((run / "trace.json").read_text())["traceEvents"]
    assert any(e["pid"] == 1000 and e["ph"] == "X" for e in trace)
    rows = json.loads((run / "summary.json").read_text())["phase_breakdown"]
    assert 0 < rows["round.dispatch"]["utilization"] <= 1


# --- the streamed trainer under a fault plan ----------------------------------

RULES = [
    {"site": "client.compute", "kind": "drop", "clients": [3]},
    {"site": "client.compute", "kind": "nan", "clients": [5]},
    {"site": "registry.fetch", "rounds": [1], "waves": [0], "times": 1},
    {"site": "ingest.h2d", "rounds": [0], "waves": [1], "times": 1},
]


def test_traced_streamed_run_matches_reference(tmp_path, monkeypatch):
    n, clients, samples, wave, rounds, seed = 3, 8, 16, 4, 2, 2
    monkeypatch.setenv("QFEDX_TRACE", "1")
    monkeypatch.setenv("QFEDX_WATCH", "3600")  # evaluated below, not ticked
    monkeypatch.setenv("QFEDX_WATCH_LOSS_MAX", "0")
    cfg_kw = dict(local_epochs=1, batch_size=8, learning_rate=0.1,
                  optimizer="sgd", secure_agg=True, secure_agg_mode="ring")
    rcfg, cfg = RFedConfig(**cfg_kw), FedConfig(**cfg_kw)
    rng = np.random.default_rng(7)
    cx = rng.uniform(0, 1, (clients, samples, n)).astype(np.float32)
    data = (cx, (cx.mean(axis=2) > 0.5).astype(np.int32),
            np.ones((clients, samples), np.float32))
    tx = rng.uniform(0, 1, (32, n)).astype(np.float32)
    ty = (tx.mean(axis=1) > 0.5).astype(np.int32)
    rmodel = ref_make(n, 2, 2)
    init_key, rkb = jax.random.split(jax.random.PRNGKey(seed))
    init = jax.tree.map(np.asarray, rmodel.init(init_key))
    kw = dict(cohort_size=clients, wave_size=wave, num_rounds=rounds,
              seed=seed, eval_every=rounds)
    seen = {}
    for port in (True, False):
        obs, watch, run_cls = ((pobs, pwatch, ExperimentRun) if port
                               else (robs, rwatch, RRun))
        plan = (FaultPlan if port else RFaultPlan)(seed=0, rules=RULES)
        with run_cls(tmp_path, "port" if port else "ref") as run:

            def hook(r, m, run=run, watch=watch):
                run.on_round_end(r, m)
                watch.evaluate_once()

            if port:
                train_federated_streamed(
                    make_vqc_classifier(n, 2, 2, device="cpu"), cfg,
                    ArrayRegistry(*data), tx, ty, fault_plan=plan,
                    on_round_end=hook,
                    params=params_from_jax(init, device="cpu"),
                    perms_for_round=lambda r: streams.perms(
                        jax.random.fold_in(rkb, r), clients,
                        cfg.local_epochs, samples),
                    draws_for_round=lambda r: streams.round_streams(
                        jax.random.fold_in(rkb, r), init, rcfg, clients,
                        samples),
                    **kw)
            else:
                ref_streamed(rmodel, rcfg, RArrayRegistry(*data), tx, ty,
                             fault_plan=plan, on_round_end=hook,
                             mesh=client_mesh(num_devices=1), **kw)
            watch.evaluate_once()
        reg = obs.registry()
        rows = [json.loads(x) for x in
                (run.dir / "metrics.jsonl").read_text().splitlines()]
        seen[port] = (
            {s.name for s in reg.spans},
            {k: v for k, v in reg.counters.items()
             if k.split(".")[0] in ("fed", "ingest", "faults")},
            [{k: r[k] for k in ("event", "state", "rule", "threshold")}
             for r in rows if "event" in r],
            [r["value"] for r in rows if r.get("state") == "firing"],
            {g for g in reg.gauges if g.startswith("fed.")},
        )
        for r in rows:
            validate_metrics_record(r)
        watch.reset()
    (pspans, pcount, palerts, pvals, pgauges) = seen[True]
    (rspans, rcount, ralerts, rvals, rgauges) = seen[False]
    assert pspans == rspans
    assert {"round.dispatch", "round.fetch", "ingest.h2d"} <= pspans
    assert pcount == rcount
    assert pcount["faults.injected.registry.fetch"] == 1
    assert pcount["faults.injected.ingest.h2d"] == 1
    assert pcount["fed.dropped_clients"] == rounds
    assert pcount["fed.rejected_updates"] == rounds
    assert palerts == ralerts and palerts[0]["rule"] == "trainer.loss"
    np.testing.assert_allclose(pvals, rvals, rtol=1e-5, atol=1e-6)
    assert pgauges == rgauges


# --- serving ------------------------------------------------------------------


def _trained(tmp_path):
    pcli.main(_argv(tmp_path, "srv", "--rounds", "1"), device="cpu")
    return tmp_path / "srv"


def test_serve_trace_spans_equal_batches(tmp_path, small_data, monkeypatch):
    run = _trained(tmp_path)
    recorded = []

    class Recording(pobs.Histogram):
        __slots__ = ()

        def record(self, value):
            recorded.append(float(value))
            super().record(value)

    monkeypatch.setattr(pobs, "Histogram", Recording)
    rng = np.random.default_rng(0)
    lines = [json.dumps({"id": i, "features": v.tolist()})
             for i, v in enumerate(rng.uniform(0, 1, (40, N)))]
    lines.insert(5, "[1.0]")  # a 400 answered on its own
    (tmp_path / "in.jsonl").write_text("\n".join(lines) + "\n")
    summary = pcli.main(["serve", "--run-dir", str(run), "--input",
                         str(tmp_path / "in.jsonl"), "--output",
                         str(tmp_path / "out.jsonl"), "--buckets", "1,8",
                         "--deadline-ms", "2", "--trace"], device="cpu")
    monkeypatch.delenv("QFEDX_TRACE")
    ev = [e for e in json.loads((run / "serve_trace.json").read_text())[
        "traceEvents"] if e["ph"] == "X"]
    compute = [e for e in ev if e["name"] == "serve.compute"]
    assert len(compute) == summary["batches"] > 0
    assert sum(e["args"]["batch"] for e in compute) == summary["served"] == 40
    served = sorted(int(i) for e in compute
                    for i in e["args"]["reqs"].split(","))
    assert len(served) == 40
    assert sum(e["name"] == "serve.fetch" for e in ev) == len(compute)
    assert {"serve.warmup_all", "serve.warmup", "serve.queue",
            "serve.pad"} <= {e["name"] for e in ev}
    counters = [e for e in json.loads((run / "serve_trace.json").read_text())[
        "traceEvents"] if e["name"] == "counters"][0]["args"]
    assert counters["serve.batches"] == summary["batches"]
    assert counters["serve.requests_rejected"] == 1
    # The p95 the summary reports (rounded to µs): the lower edge of the
    # exact quantile's bucket — within one bucket, never above it.
    assert len(recorded) == 40
    for q, key in ((0.5, "p50_ms"), (0.95, "p95_ms")):
        exact = pobs.percentile(sorted(recorded), q)
        lo, hi = pobs.Histogram.bucket_bounds(exact)
        assert summary[key] == round(lo, 3) and lo <= exact < hi


def test_sigterm_leaves_flight_and_partial_trace(tmp_path, monkeypatch):
    monkeypatch.setenv("QFEDX_FLIGHT", "on")
    monkeypatch.setenv("QFEDX_TRACE", "1")
    model = make_vqc_classifier(N, 1, 2, device="cpu")
    rng = np.random.default_rng(1)
    cx = rng.uniform(0, 1, (2, 16, N)).astype(np.float32)
    cy = (cx.mean(axis=2) > 0.5).astype(np.int32)

    def term(r, m):
        run.on_round_end(r, m)
        if r == 1:
            os.kill(os.getpid(), signal.SIGTERM)

    with pytest.raises(KeyboardInterrupt):
        with ExperimentRun(tmp_path, "killed") as run:
            train_federated(model, FedConfig(batch_size=8), cx, cy,
                            np.ones((2, 16), np.float32), cx[0], cy[0],
                            num_rounds=5, on_round_end=term,
                            checkpointer=Checkpointer(run.dir / "ck",
                                                      every=1))
    doc = json.loads((run.dir / "flight.json").read_text())
    assert doc["reason"] == "KeyboardInterrupt"
    names = [(e["kind"], e["name"]) for e in doc["events"]]
    assert ("lifecycle", "run.start") in names and ("round", "r2") in names
    assert pflight.last_dump()["path"] == str(run.dir / "flight.json")
    partial = json.loads((run.dir / "summary.json").read_text())
    assert partial["partial"] and partial["crashed"] == "KeyboardInterrupt"
    assert "round.dispatch" in partial["phase_breakdown"]
    assert "round.dispatch" in _span_names(run.dir / "trace.json")

