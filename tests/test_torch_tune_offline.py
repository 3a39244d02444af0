"""Port vs reference: the offline tuner (tune/offline.py) and the
``tune`` → ``serve --tuned`` → ``train --tuned`` round trip.

- ``sweep_serve`` over a (bucket set × deadline) lattice with
  ``_measure_cell`` stubbed to the same scores in both packages: the
  cells, the winner (ties broken by the lower p95) and the
  ``best_config.json`` record are equal, minus ``provenance.ts`` and
  ``key.backend`` (the reference's JAX backend name, the port's torch
  device type); each cell's ``route_resolved`` is compared on the
  reference's keys (the port's adds the device and the engine).
- The unstubbed ``_measure_cell`` scores a warmed port cell by the
  reference's rule; ``load_best_config`` raises the reference's errors;
  ``_pin_overlay`` and ``apply_best_config`` leave the same environment
  in both packages (an operator-set pin is never overwritten).
- The CLI round trip on a trained n = 4 run: ``tune`` writes the sidecar,
  ``serve --tuned`` answers with the tuned buckets and logits within
  1e-6 of untuned serving, explicit flags win, and ``train --tuned``
  records ``tuned_from`` as the reference's parser does.
"""

import functools
import json
import os

import jax
import numpy as np
import pytest
import torch

from qfedx_tpu.models.vqc import make_vqc_classifier as ref_make
from qfedx_tpu.run import cli as rcli
from qfedx_tpu.tune import offline as roff
from qfedx_tpu_torch.models.vqc import make_vqc_classifier, params_from_jax
from qfedx_tpu_torch.run import cli as pcli
from qfedx_tpu_torch.run import config as pconfig
from qfedx_tpu_torch.serve import ServeConfig
from qfedx_tpu_torch.tune import offline as poff

N = 4
_SERVE_PINS = ("QFEDX_SERVE_BUCKETS", "QFEDX_SERVE_DEADLINE_MS",
               "QFEDX_SERVE_QUEUE", "QFEDX_SERVE_SLO_MS", "QFEDX_TUNE",
               "QFEDX_TRACE", "QFEDX_WATCH", "QFEDX_FLIGHT", "QFEDX_PIPELINE")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several workers on one CPU."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    """Every pin these tests write is unset before and restored after
    (``apply_best_config`` writes through utils/pins, not monkeypatch)."""
    for pin in _SERVE_PINS:
        monkeypatch.setenv(pin, "")
        monkeypatch.delenv(pin)
    monkeypatch.setenv("QFEDX_GATE_FORM", "dot")


def _stub_score(engine, requests, rate_fracs, seed):
    """A deterministic score of the cell's config: the (1, 4) sets tie on
    throughput at 5 ms, and the lower p95 wins."""
    cfg = engine.config
    cap, dl = cfg.buckets[-1], cfg.deadline_ms
    tput = {(2, 2.5): 120.0, (2, 5.0): 150.0, (4, 2.5): 180.0,
            (4, 5.0): 180.0}[cap, dl]
    p95 = round(10.0 + cap * dl / 3, 3)
    return {"throughput_at_slo": tput, "p50_ms": p95 / 2, "p95_ms": p95,
            "capacity_rps": 100.0 * cap,
            "rates": {f"load_{f:g}": {"offered_rps": f * 100.0 * cap,
                                      "shed": 0} for f in rate_fracs}}


_LATTICE = dict(slo_ms=50.0, bucket_sets=((1, 2), (1, 4)),
                deadlines_ms=(2.5, 5.0), requests=8, rate_fracs=(0.5, 0.8),
                seed=3)


def _sweeps(monkeypatch):
    monkeypatch.setattr(roff, "_measure_cell", _stub_score)
    monkeypatch.setattr(poff, "_measure_cell", _stub_score)
    rmodel = ref_make(N, 1, 2)
    params = jax.tree.map(np.asarray, rmodel.init(jax.random.PRNGKey(0)))
    ref = roff.sweep_serve(rmodel, params, (N,), **_LATTICE)
    port = poff.sweep_serve(make_vqc_classifier(N, 1, 2, device="cpu"),
                            params_from_jax(params, device="cpu"), (N,),
                            device="cpu", **_LATTICE)
    return ref, port


def _without_route(cells):
    return [{k: v for k, v in c.items() if k != "route_resolved"}
            for c in cells]


def _route_on_ref_keys(ref_cells, port_cells):
    for rc, pc in zip(ref_cells, port_cells):
        rr, pr = rc["route_resolved"], pc["route_resolved"]
        assert {k: pr[k] for k in rr} == rr
        assert pr["device"] == "cpu"


def _same_route(monkeypatch):
    """Both packages read one route from the pins (the reference's
    program shape, its scan route)."""
    from qfedx_tpu.ops import fuse as rfuse

    for pin in ("QFEDX_FUSE", "QFEDX_SCAN_LAYERS", "QFEDX_BATCHED"):
        monkeypatch.setenv(pin, "1")
    monkeypatch.setenv("QFEDX_PALLAS", "0")
    monkeypatch.setenv("QFEDX_SLAB_LANES", "matmul")
    monkeypatch.setattr(rfuse, "_gather_ok", lambda: True)
    monkeypatch.setattr(rfuse, "_growmat_merge_ok", lambda: True)


def test_sweep_matches_reference(monkeypatch):
    _same_route(monkeypatch)
    ref, port = _sweeps(monkeypatch)
    assert _without_route(port["cells"]) == _without_route(ref["cells"])
    _route_on_ref_keys(ref["cells"], port["cells"])
    assert [(c["buckets"], c["deadline_ms"]) for c in port["cells"]] == [
        ([1, 2], 2.5), ([1, 2], 5.0), ([1, 4], 2.5), ([1, 4], 5.0)]
    # The tie at 180 rps goes to the lower p95 (2.5 ms).
    assert (port["best"]["buckets"], port["best"]["deadline_ms"]) == (
        ref["best"]["buckets"], ref["best"]["deadline_ms"]) == ([1, 4], 2.5)
    assert port["key"]["backend"] == "cpu"
    assert {k: v for k, v in port["key"].items() if k != "backend"} == {
        k: v for k, v in ref["key"].items() if k != "backend"}


def test_record_matches_reference(monkeypatch, tmp_path):
    _same_route(monkeypatch)
    ref, port = _sweeps(monkeypatch)
    recs = {}
    for name, mod, sweep in (("ref", roff, ref), ("port", poff, port)):
        rec = mod.best_config_record(sweep, requests=8, source="qfedx tune")
        path = mod.write_best_config(tmp_path / f"{name}.json", rec)
        assert path.read_text().endswith("}\n")
        assert not (tmp_path / f"{name}.json.tmp").exists()
        disk = json.loads(path.read_text())
        assert isinstance(disk["provenance"].pop("ts"), float)
        disk["key"].pop("backend")
        disk["cells"] = _without_route(disk["cells"])
        recs[name] = disk
    assert recs["port"] == recs["ref"]
    assert recs["port"]["pins"] == {"QFEDX_SERVE_BUCKETS": "1,4",
                                    "QFEDX_SERVE_DEADLINE_MS": "2.5"}
    assert recs["port"]["score"] == {"metric": "throughput_at_slo",
                                     "throughput_at_slo": 180.0,
                                     "p50_ms": 6.6665, "p95_ms": 13.333}


def test_every_cell_missing_the_slo_scores_zero(monkeypatch):
    """No cell meets the SLO: the winner's throughput_at_slo is 0.0 and
    its p95 None, in both packages."""
    def miss(engine, requests, rate_fracs, seed):
        return {"throughput_at_slo": 0.0, "p50_ms": None, "p95_ms": None,
                "capacity_rps": 1.0, "rates": {}}

    monkeypatch.setattr(roff, "_measure_cell", miss)
    monkeypatch.setattr(poff, "_measure_cell", miss)
    rmodel = ref_make(N, 1, 2)
    params = jax.tree.map(np.asarray, rmodel.init(jax.random.PRNGKey(0)))
    lat = dict(_LATTICE, bucket_sets=((1, 2),), deadlines_ms=(5.0,))
    ref = roff.sweep_serve(rmodel, params, (N,), **lat)
    port = poff.sweep_serve(make_vqc_classifier(N, 1, 2, device="cpu"),
                            params_from_jax(params, device="cpu"), (N,),
                            device="cpu", **lat)
    for s in (ref, port):
        assert s["best"]["throughput_at_slo"] == 0.0
        assert s["best"]["p95_ms"] is None


def test_measure_cell_scores_a_warm_port_cell():
    """The unstubbed score on the CPU: capacity from the warm max-bucket
    batch, one row per offered-load fraction, the SLO rule applied."""
    model = make_vqc_classifier(N, 1, 2, device="cpu")
    from qfedx_tpu_torch.serve import ServeEngine

    engine = ServeEngine(model, model.init(0), (N,), config=ServeConfig(
        buckets=(1, 4), deadline_ms=2.0, slo_ms=1e4), device="cpu")
    engine.warmup()
    score = poff._measure_cell(engine, 12, (0.5,), 0)
    assert set(score) == {"throughput_at_slo", "p50_ms", "p95_ms",
                          "capacity_rps", "rates"}
    row = score["rates"]["load_0.5"]
    assert row["shed"] == 0 and row["p95_ms"] <= 1e4
    assert score["throughput_at_slo"] == row["completed_rps"] > 0
    assert score["capacity_rps"] > 0


def test_load_best_config_errors_match_reference(tmp_path):
    side = tmp_path / "best_config.json"
    for text, match in ((json.dumps({"schema": 99, "pins": {}}), "schema"),
                        (json.dumps({"schema": 1}), "pins"),
                        (json.dumps({"schema": 1, "pins": []}), "pins")):
        side.write_text(text)
        for mod in (roff, poff):
            with pytest.raises(ValueError, match=match):
                mod.load_best_config(side)
            with pytest.raises(ValueError, match=match):
                mod.load_best_config(tmp_path)  # a directory holding it
    with pytest.raises(FileNotFoundError):
        poff.load_best_config(tmp_path / "absent.json")


def _env(names):
    return {n: os.environ.get(n) for n in names}


def test_apply_best_config_skips_operator_pins_as_reference(tmp_path,
                                                            monkeypatch):
    record = {"schema": 1, "pins": {"QFEDX_SERVE_BUCKETS": "1,2",
                                    "QFEDX_SERVE_DEADLINE_MS": "2.5",
                                    "QFEDX_PIPELINE": "2"}}
    (tmp_path / "best_config.json").write_text(json.dumps(record))
    names = tuple(record["pins"])
    results, envs = {}, {}
    for name, mod in (("ref", roff), ("port", poff)):
        for pin in names:
            monkeypatch.delenv(pin, raising=False)
        monkeypatch.setenv("QFEDX_SERVE_DEADLINE_MS", "33")
        got = mod.apply_best_config(tmp_path)
        results[name] = {k: got[k] for k in ("applied", "skipped")}
        envs[name] = _env(names)
    assert results["port"] == results["ref"] == {
        "applied": {"QFEDX_SERVE_BUCKETS": "1,2", "QFEDX_PIPELINE": "2"},
        "skipped": {"QFEDX_SERVE_DEADLINE_MS": "33"}}
    assert envs["port"] == envs["ref"]
    cfg = ServeConfig.resolve()
    assert cfg.buckets == (1, 2) and cfg.deadline_ms == 33.0


def test_pin_overlay_restores_as_reference(monkeypatch):
    names = ("QFEDX_SCAN_LAYERS", "QFEDX_PIPELINE")
    monkeypatch.setenv("QFEDX_SCAN_LAYERS", "1")
    monkeypatch.delenv("QFEDX_PIPELINE", raising=False)
    before = _env(names)
    for mod in (roff, poff):
        with mod._pin_overlay({"QFEDX_SCAN_LAYERS": "0",
                               "QFEDX_PIPELINE": 3}):
            assert _env(names) == {"QFEDX_SCAN_LAYERS": "0",
                                   "QFEDX_PIPELINE": "3"}
        assert _env(names) == before
        with pytest.raises(RuntimeError):
            with mod._pin_overlay({"QFEDX_PIPELINE": "1"}):
                raise RuntimeError("a cell failed")
        assert _env(names) == before


# --- the CLI round trip ---------------------------------------------------------


@pytest.fixture()
def small_data(monkeypatch):
    monkeypatch.setattr(pcli, "DataConfig", functools.partial(
        pconfig.DataConfig, synthetic_train=192, synthetic_test=96))


def _train_argv(root, name, *extra):
    return ["train", "--model", "vqc", "--qubits", str(N), "--layers", "1",
            "--classes", "0,1", "--clients", "2", "--rounds", "1",
            "--local-epochs", "1", "--checkpoint-every", "1",
            "--rounds-per-call", "1", "--lr", "0.1", "--run-root",
            str(root), "--name", name, *extra]


def _serve(run_dir, tmp_path, tag, *extra):
    x = np.random.default_rng(5).uniform(0, 1, (9, N)).astype(np.float32)
    req = tmp_path / f"req-{tag}.jsonl"
    req.write_text("".join(json.dumps({"id": i, "features": v.tolist()})
                           + "\n" for i, v in enumerate(x)))
    out = tmp_path / f"resp-{tag}.jsonl"
    summary = pcli.main(["serve", "--run-dir", str(run_dir), "--input",
                         str(req), "--output", str(out), *extra],
                        device="cpu")
    logits = np.array([json.loads(line)["logits"]
                       for line in out.read_text().splitlines()])
    return summary, logits


def test_cli_tune_serve_tuned_train_tuned(tmp_path, small_data, capsys):
    pcli.main(_train_argv(tmp_path, "base"), device="cpu")
    run = tmp_path / "base"
    record = pcli.main(["tune", "--run-dir", str(run), "--buckets",
                        "1,2;1,4", "--deadlines", "5", "--requests", "8",
                        "--slo-ms", "1000"], device="cpu")
    side = run / "best_config.json"
    assert record["path"] == str(side) and side.exists()
    disk = poff.load_best_config(run)
    assert disk["key"] == {"model": "vqc4q1l-angle", "feature_shape": [N],
                           "backend": "cpu", "slo_ms": 1000.0}
    assert len(disk["cells"]) == 2
    assert disk["provenance"]["source"] == "qfedx tune"
    tuned_buckets = tuple(int(b) for b in
                          disk["pins"]["QFEDX_SERVE_BUCKETS"].split(","))
    assert tuned_buckets in ((1, 2), (1, 4))
    assert disk["pins"]["QFEDX_SERVE_DEADLINE_MS"] == "5"
    assert "tuned" in capsys.readouterr().out

    _, untuned = _serve(run, tmp_path, "untuned")
    summary, tuned = _serve(run, tmp_path, "tuned", "--tuned")
    assert summary["served"] == 9
    np.testing.assert_allclose(tuned, untuned, atol=1e-6, rtol=0)
    assert ServeConfig.resolve().buckets == tuned_buckets
    # An explicit flag wins over the sidecar.
    pcli.main(["serve", "--run-dir", str(run), "--tuned", str(side),
               "--buckets", "1,3", "--input", str(tmp_path / "req-tuned"
                                                  ".jsonl"),
               "--output", str(tmp_path / "resp-flag.jsonl")], device="cpu")
    err = capsys.readouterr().err
    assert "warm buckets: 1 (" in err and ", 3 (" in err

    for pin in ("QFEDX_SERVE_BUCKETS", "QFEDX_SERVE_DEADLINE_MS"):
        os.environ.pop(pin, None)
    pcli.main(_train_argv(tmp_path, "tuned", "--tuned", str(side)),
              device="cpu")
    cfg = json.loads((tmp_path / "tuned" / "config.json").read_text())
    assert cfg["tuned_from"] == str(side)
    assert os.environ["QFEDX_SERVE_BUCKETS"] == disk["pins"][
        "QFEDX_SERVE_BUCKETS"]
    # Serving pins only: the rounds equal the untuned run's.
    rows = {n: [json.loads(line) for line in (
        tmp_path / n / "metrics.jsonl").read_text().splitlines()]
        for n in ("base", "tuned")}
    assert [r["loss"] for r in rows["tuned"]] == [
        r["loss"] for r in rows["base"]]
    want = rcli.config_from_args(rcli.build_parser().parse_args(
        _train_argv(tmp_path, "tuned", "--tuned", str(side))))
    got = pcli.config_from_args(pcli.build_parser().parse_args(
        _train_argv(tmp_path, "tuned", "--tuned", str(side))))
    assert got.tuned_from == want.tuned_from == str(side)
