"""Port vs reference: the sweep harness (run/sweep.py).

- All three presets, and every cell's ``_config_from_cell`` at two
  seeds, equal the reference's.
- ``_aggregate`` and ``_markdown_table`` (minus its environment line) on
  the same runs equal the reference's, the 3→5 seed rule included.
- The quick preset's ``q4-iid`` cell trains through ``_run_cell`` in
  both packages, the port from the reference's init with its shuffles
  injected (tests/_torch_ref_streams.py): the final accuracy within one
  evaluation sample, the same ``comm_mb_per_round``.
- ``run_sweep(cells=[…], seeds=1)`` writes ``results.json``,
  ``results.md`` and the plots; a cell with ``sv_size > 1`` raises the
  trainer's mesh ValueError before any cell trains when the slots are
  too few for one sv group, and trains over enough slots
  (``devices=``).
"""

import dataclasses
import functools
import json

import jax
import numpy as np
import pytest
import torch

import _torch_ref_streams as streams
from qfedx_tpu.fed.round import client_mesh
from qfedx_tpu.ops import fuse as rfuse
from qfedx_tpu.run import config as rconfig
from qfedx_tpu.run import sweep as rsweep
from qfedx_tpu.run import trainer as rtrainer
from qfedx_tpu_torch.models.vqc import params_from_jax
from qfedx_tpu_torch.run import config as pconfig
from qfedx_tpu_torch.run import sweep as psweep
from qfedx_tpu_torch.run import trainer as ptrainer

PRESETS = ("quick", "roadmap", "baseline")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several workers on one CPU."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("preset", PRESETS)
def test_preset_cells_match_reference(preset):
    assert psweep.preset_cells(preset) == rsweep.preset_cells(preset)


def test_unknown_preset_raises():
    with pytest.raises(ValueError, match="unknown preset"):
        psweep.preset_cells("nope")


@pytest.mark.parametrize("preset", PRESETS)
def test_config_from_cell_matches_reference(preset):
    for cell in rsweep.preset_cells(preset):
        for seed in (42, 44):
            got = dataclasses.asdict(psweep._config_from_cell(cell, seed))
            want = dataclasses.asdict(rsweep._config_from_cell(cell, seed))
            assert got == want, cell["name"]


def _runs(accs, eps=None, seed=0):
    rng = np.random.default_rng(seed)
    return [{"accuracy": a, "auc": float(rng.uniform(0.5, 1)),
             "epsilon": eps, "wall_s": float(rng.uniform(1, 2)),
             "round_s": float(rng.uniform(0.1, 0.2)),
             "comm_mb_per_round": 0.0032} for a in accs]


def test_aggregate_and_table_match_reference():
    cells = rsweep.preset_cells("quick") + [{"name": "no-auc"}]
    runs = {"q4-iid": _runs([0.8, 0.9, 0.85]),
            "q4-dp": _runs([0.5, 0.7, 0.9, 0.6, 0.55], eps=3.5, seed=1),
            "no-auc": [dict(r, auc=None, round_s=None)
                       for r in _runs([0.6], seed=2)]}
    got = {k: psweep._aggregate(v) for k, v in runs.items()}
    want = {k: rsweep._aggregate(v) for k, v in runs.items()}
    assert got == want
    assert got["q4-dp"]["n_seeds"] == 5 and "auc_mean" not in got["no-auc"]
    p_md = psweep._markdown_table(cells, got, "cpu").splitlines()
    r_md = rsweep._markdown_table(cells, want).splitlines()
    assert p_md[0].startswith("Environment: `cpu1`")
    assert p_md[1:] == r_md[1:]


def test_env_tag():
    assert psweep._env_tag("cpu") == "cpu1"


def _same_form(mp):
    for pin in ("QFEDX_FUSE", "QFEDX_SCAN_LAYERS", "QFEDX_BATCHED"):
        mp.setenv(pin, "1")
    mp.setenv("QFEDX_PALLAS", "0")
    mp.setenv("QFEDX_GATE_FORM", "dot")
    mp.setenv("QFEDX_SLAB_LANES", "matmul")
    mp.setattr(rfuse, "_gather_ok", lambda: True)
    mp.setattr(rfuse, "_growmat_merge_ok", lambda: True)


def test_quick_cell_trains_as_reference(monkeypatch):
    """q4-iid (n = 4, L = 2, 4 clients, 4 Adam rounds) through each
    package's ``_run_cell``; the port from the reference's init and
    shuffles. Accuracy within one evaluation sample."""
    _same_form(monkeypatch)
    cell = rsweep.preset_cells("quick")[0]
    assert cell["name"] == "q4-iid"
    seed = 42
    cfg = rsweep._config_from_cell(cell, seed)
    data = rconfig.build_data(cfg)
    clients, samples = data["cx"].shape[:2]
    init_key, base = jax.random.split(jax.random.PRNGKey(seed))
    model = rconfig.build_model(cfg, data["num_classes"])
    init = jax.tree.map(np.asarray, model.init(init_key))
    perms = [torch.as_tensor(np.asarray(streams.perms(
        jax.random.fold_in(base, r), clients, cfg.fed.local_epochs,
        samples)), dtype=torch.int64) for r in range(cfg.num_rounds)]
    monkeypatch.setattr(rtrainer, "train_federated", functools.partial(
        rtrainer.train_federated, mesh=client_mesh(num_devices=1)))
    want = rsweep._run_cell(cell, seed)
    monkeypatch.setattr(ptrainer, "train_federated", functools.partial(
        ptrainer.train_federated, params=params_from_jax(init, device="cpu"),
        perms_for_round=lambda r: perms[r]))
    got = psweep._run_cell(cell, seed, device="cpu")
    n_test = len(data["test"][1])
    assert abs(got["accuracy"] - want["accuracy"]) <= 1.0 / n_test
    assert got["comm_mb_per_round"] == want["comm_mb_per_round"]
    assert got["epsilon"] is None and want["epsilon"] is None
    assert got["auc"] is None and want["auc"] is None  # three classes


def test_run_sweep_end_to_end(tmp_path, monkeypatch):
    """One small cell, one seed: the files the CLI's sweep writes."""
    monkeypatch.setattr(pconfig, "DataConfig", functools.partial(
        pconfig.DataConfig, synthetic_test=128))
    cells = [psweep._cell("tiny", qubits=4, clients=2, rounds=2,
                          synthetic_train=256, layers=1),
             psweep._cell("tiny-dp", qubits=4, clients=2, rounds=2,
                          synthetic_train=256, layers=1, dp_sigma=1.0,
                          dp_clip=1.0)]
    result = psweep.run_sweep(preset="quick", seeds=1, root=tmp_path,
                              cells=cells, device="cpu")
    out = tmp_path / "sweep-quick"
    assert result["dir"] == str(out)
    data = json.loads((out / "results.json").read_text())
    assert data["env"] == "cpu1" and data["seeds"] == 1
    assert set(data["aggregates"]) == {"tiny", "tiny-dp"}
    assert all(len(v) in (1, 5) for v in data["runs"].values())
    assert data["aggregates"]["tiny-dp"]["epsilon_mean"] > 0
    md = (out / "results.md").read_text()
    assert "| tiny |" in md and "| tiny-dp |" in md
    assert (out / "accuracy_vs_epsilon.png").exists()


@pytest.mark.parametrize("preset", ["baseline", None])
def test_sharded_cells_raise_before_training(tmp_path, monkeypatch, preset):
    """On the CPU's one slot a sharded cell (the baseline's c5-svqc, sv
    4) raises the trainer's mesh ValueError before any cell trains."""
    trained = []
    monkeypatch.setattr(psweep, "_run_cell",
                        lambda *a, **k: trained.append(a))
    cells = None if preset else [psweep._cell("ok", qubits=4),
                                 psweep._cell("sv2", qubits=8, sv_size=2)]
    k = 4 if preset else 2
    with pytest.raises(ValueError, match=f"model needs sv groups of {k} "
                       "devices; only 1 available"):
        psweep.run_sweep(preset=preset or "quick", seeds=1, root=tmp_path,
                         cells=cells, device="cpu")
    assert trained == []


def test_baseline_preset_reaches_c5_svqc_given_slots(tmp_path, monkeypatch):
    """Over eight slots the baseline grid passes its check, and every
    cell, c5-svqc too, reaches ``_run_cell`` with the slots."""
    seen = []
    monkeypatch.setattr(psweep, "_run_cell", lambda cell, seed, **k: (
        seen.append((cell["name"], k["devices"])) or {
            "accuracy": 0.5, "auc": None, "epsilon": None, "wall_s": 1.0,
            "round_s": 0.1, "comm_mb_per_round": 0.0}))
    monkeypatch.setattr(psweep, "_plots", lambda *a: None)
    psweep.run_sweep(preset="baseline", seeds=1, root=tmp_path,
                     device="cpu", devices=["cpu"] * 8)
    assert ("c5-svqc", ["cpu"] * 8) in seen
    assert len(seen) == len(psweep.preset_cells("baseline"))


def test_sharded_cell_trains_given_slots(tmp_path):
    """A cut-down sharded cell (n = 4 over sv groups of 2, 2 clients, one
    round) trains through ``_run_cell`` over four CPU slots, to the dense
    twin's accuracy within 1/64 (same init, data and shuffles: the
    sharded model is the dense one on another engine)."""
    cell = psweep._cell("sv2", qubits=4, clients=2, sv_size=2, rounds=1,
                        classes=(0, 1), optimizer="sgd")
    got = psweep._run_cell(cell, 42, device="cpu", devices=["cpu"] * 4)
    want = psweep._run_cell(dict(cell, sv_size=1), 42, device="cpu")
    assert abs(got["accuracy"] - want["accuracy"]) <= 1 / 64
    assert got["comm_mb_per_round"] == want["comm_mb_per_round"]


def test_cli_sweep_reaches_run_sweep(monkeypatch):
    from qfedx_tpu_torch.run import cli as pcli

    seen = {}
    monkeypatch.setattr(psweep, "run_sweep",
                        lambda **kw: seen.update(kw) or {"ok": True})
    assert pcli.main(["sweep", "--preset", "quick", "--seeds", "2",
                      "--run-root", "x"], device="cpu") == {"ok": True}
    assert seen == {"preset": "quick", "seeds": 2, "root": "x",
                    "device": "cpu"}
