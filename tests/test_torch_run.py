"""Port vs reference: the runner (run/config, run/metrics, run/checkpoint,
fed/evaluate, run/trainer, run/cli and serve.engine_from_run_dir).

- config: the same argv gives equal ``_jsonable`` dicts in both
  packages, and a ``config.json`` of either restores in the other;
- evaluator: at n=10 with the reference's weights, accuracy equal and
  AUC within 1e-6, with and without ``max_batches``;
- checkpoints: the same file format both ways (leaf for leaf, bit
  equal), the last-good fallback, ``keep`` GC and ``save_async``;
- trainer: at n=10, L=2, 2 clients, 2 SGD-momentum rounds from the
  reference's init with its per-round shuffles injected: per-round loss
  within 1e-5, accuracy equal, final θ within 1e-5 (the SGD round
  tolerance of tests/test_torch_fed.py); the in-chunk evaluation gives
  the same rows; a resumed run equals the uninterrupted one exactly;
- CLI: train rows that the reference's schema check accepts, serve's
  ordered responses with a 400, and every unported flag raising.

The reference runs with the TPU program shape forced and its
``lax.scan`` route (QFEDX_PALLAS=0, exact against its interpreted kernel,
tests/test_pallas.py) to keep its compiles short, on a one-device mesh;
the port runs its kernel route on the CPU (the kernel's plain version).
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qfedx_tpu.fed.config import FedConfig as RFedConfig
from qfedx_tpu.fed.evaluate import make_evaluator as ref_make_evaluator
from qfedx_tpu.fed.round import TRAIN_KEY_SALT, client_mesh
from qfedx_tpu.models.vqc import make_vqc_classifier as ref_make
from qfedx_tpu.ops import fuse as rfuse
from qfedx_tpu.run import checkpoint as rckpt
from qfedx_tpu.run import cli as rcli
from qfedx_tpu.run import config as rconfig
from qfedx_tpu.run import metrics as rmetrics
from qfedx_tpu.run.trainer import train_federated as ref_train
from qfedx_tpu_torch.fed.config import FedConfig
from qfedx_tpu_torch.fed.evaluate import make_evaluator
from qfedx_tpu_torch.models.vqc import make_vqc_classifier, params_from_jax
from qfedx_tpu_torch.run import checkpoint as pckpt
from qfedx_tpu_torch.run import cli as pcli
from qfedx_tpu_torch.run import config as pconfig
from qfedx_tpu_torch.run import metrics as pmetrics
from qfedx_tpu_torch.run.trainer import train_federated
from qfedx_tpu_torch.utils import trees


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these small tensors: the suite runs
    several workers on one CPU, where torch's default pool per worker
    oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


N, L, C, S, BATCH = 10, 2, 2, 8, 4
SGD_ATOL = 1e-5


@pytest.fixture(autouse=True)
def tpu_form(monkeypatch):
    for pin in ("QFEDX_FUSE", "QFEDX_SCAN_LAYERS", "QFEDX_BATCHED"):
        monkeypatch.setenv(pin, "1")
    monkeypatch.setenv("QFEDX_PALLAS", "0")  # the reference's scan route
    monkeypatch.setenv("QFEDX_GATE_FORM", "flip")
    monkeypatch.setenv("QFEDX_SLAB_LANES", "matmul")
    monkeypatch.setattr(rfuse, "_gather_ok", lambda: True)
    monkeypatch.setattr(rfuse, "_growmat_merge_ok", lambda: True)


def _port_pallas(monkeypatch):
    """The port's kernel route (its pins are read when the model runs)."""
    monkeypatch.setenv("QFEDX_PALLAS", "1")


# --- config ------------------------------------------------------------------

_ARGVS = [
    ["train"],
    ["train", "--model", "vqc", "--qubits", "12", "--layers", "3",
     "--classes", "0,1", "--clients", "4", "--rounds", "3",
     "--local-epochs", "1", "--checkpoint-every", "1", "--run-root", "x",
     "--name", "smoke"],
    ["train", "--classes", "all", "--partition", "dirichlet", "--alpha",
     "0.2", "--optimizer", "adam", "--algorithm", "fedprox", "--prox-mu",
     "0.1", "--dp-clip", "1.5", "--dp-mode", "example", "--scan-layers",
     "off", "--rounds-per-call", "4", "--eval-batches", "2", "--sv-size",
     "2", "--aggregator", "clip_mean", "--clip-bound", "3"],
]


@pytest.mark.parametrize("argv", _ARGVS)
def test_config_from_args_matches_reference(argv):
    ref = rcli.config_from_args(rcli.build_parser().parse_args(argv))
    port = pcli.config_from_args(pcli.build_parser().parse_args(argv))
    assert rmetrics._jsonable(ref) == pmetrics._jsonable(port)


@pytest.mark.parametrize("argv", _ARGVS)
def test_config_json_restores_across_packages(argv):
    ref = rcli.config_from_args(rcli.build_parser().parse_args(argv))
    port = pcli.config_from_args(pcli.build_parser().parse_args(argv))
    ref_json = json.loads(json.dumps(rmetrics._jsonable(ref)))
    port_json = json.loads(json.dumps(pmetrics._jsonable(port)))
    assert pconfig.experiment_config_from_dict(ref_json) == port
    assert rconfig.experiment_config_from_dict(port_json) == ref


# --- evaluator ---------------------------------------------------------------


def _ref_params(model, key=0):
    p = model.init(jax.random.PRNGKey(key))
    return jax.tree.map(np.asarray, p)


@pytest.mark.parametrize("n_samples,max_batches", [(40, None), (40, 2),
                                                   (7, None)])
def test_evaluator_matches_reference(monkeypatch, n_samples, max_batches):
    rng = np.random.default_rng(n_samples)
    x = rng.uniform(0, 1, (n_samples, N)).astype(np.float32)
    y = rng.integers(0, 2, n_samples).astype(np.int32)
    rmodel = ref_make(N, L, 2, init_scale=1.0)
    rp = _ref_params(rmodel)
    want = ref_make_evaluator(rmodel, batch_size=16,
                              max_batches=max_batches)(rp, x, y)
    _port_pallas(monkeypatch)
    pmodel = make_vqc_classifier(N, L, 2, device="cpu")
    got = make_evaluator(pmodel, batch_size=16, max_batches=max_batches)(
        params_from_jax(rp, device="cpu"), x, y)
    assert set(got) == set(want) == {"accuracy", "n", "auc"}
    assert got["n"] == want["n"]
    assert got["accuracy"] == want["accuracy"]
    assert abs(got["auc"] - want["auc"]) <= 1e-6


def test_binary_auc_matches_reference():
    from qfedx_tpu.fed.evaluate import binary_auc as rauc
    from qfedx_tpu_torch.fed.evaluate import binary_auc as pauc

    rng = np.random.default_rng(3)
    y = rng.integers(0, 2, 50)
    s = np.round(rng.normal(size=50), 1)  # ties on purpose
    assert pauc(y, s) == rauc(y, s)
    assert np.isnan(pauc(np.ones(4), s[:4]))


# --- checkpoints -------------------------------------------------------------


def _port_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "ansatz": {"rx": torch.as_tensor(rng.normal(size=(L, N)),
                                         dtype=torch.float32),
                   "rz": torch.as_tensor(rng.normal(size=(L, N)),
                                         dtype=torch.float32)},
        "readout": {"bias": torch.as_tensor(rng.normal(size=2),
                                            dtype=torch.float32),
                    "scale": torch.as_tensor(rng.normal(size=2),
                                             dtype=torch.float32)},
    }


def _jax_tree(tree):
    return jax.tree.map(lambda t: jnp.asarray(t.numpy()), tree,
                        is_leaf=lambda t: isinstance(t, torch.Tensor))


def test_port_checkpoint_restores_in_reference(tmp_path):
    tree = _port_tree(1)
    pckpt.Checkpointer(tmp_path, every=1).save(4, tree)
    got = rckpt.Checkpointer(tmp_path, every=1).restore(4, _jax_tree(
        _port_tree(2)))
    for a, b in zip(jax.tree.leaves(got), trees.tree_leaves(tree)):
        assert np.asarray(a).tobytes() == b.numpy().tobytes()
    assert json.loads((tmp_path / "ckpt_000004.json").read_text()) == {
        "round": 4, "n_leaves": 4}


def test_reference_checkpoint_restores_in_port(tmp_path):
    tree = _jax_tree(_port_tree(3))
    rckpt.Checkpointer(tmp_path, every=1).save(2, tree)
    template = _port_tree(4)
    got, r = pckpt.Checkpointer(tmp_path, every=1).restore_latest(template)
    assert r == 2
    for a, b in zip(trees.tree_leaves(got), jax.tree.leaves(tree)):
        assert a.dtype == torch.float32
        assert a.numpy().tobytes() == np.asarray(b).tobytes()


def test_corrupt_checkpoint_falls_back_to_last_good(tmp_path):
    ck = pckpt.Checkpointer(tmp_path, every=1, keep=2)
    for r in (1, 2, 3):
        ck.save(r, _port_tree(r))
    # keep=2: round 1 is gone with all three of its files.
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        f"ckpt_00000{r}.{e}" for r in (2, 3) for e in ("json", "npz",
                                                       "sha256")]
    data = bytearray((tmp_path / "ckpt_000003.npz").read_bytes())
    data[len(data) // 2] ^= 0xFF
    (tmp_path / "ckpt_000003.npz").write_bytes(bytes(data))
    with pytest.warns(RuntimeWarning, match="skipping corrupt"):
        got, r = ck.restore_latest(_port_tree(0))
    assert r == 2
    assert torch.equal(got["ansatz"]["rx"], _port_tree(2)["ansatz"]["rx"])
    with pytest.raises(pckpt.CheckpointIntegrityError, match="sha256"):
        ck.restore(3, _port_tree(0))
    with pytest.raises(ValueError, match="leaves"):
        ck.restore(2, {"ansatz": _port_tree(0)["ansatz"]})


def test_save_async_is_on_disk_after_wait(tmp_path):
    ck = pckpt.Checkpointer(tmp_path, every=2)
    assert ck.maybe_save_async(1, _port_tree(1)) is False
    assert ck.maybe_save_async(2, _port_tree(2)) is True
    ck.save_async(3, _port_tree(3))
    assert ck.wait() is None
    got = ck.restore(3, _port_tree(0))
    assert torch.equal(got["readout"]["scale"],
                       _port_tree(3)["readout"]["scale"])
    assert ck._thread is None  # the writer is retired


class _Unwritable:
    def __array__(self, *args, **kwargs):
        raise OSError("disk gone")


def test_async_write_error_surfaces_at_wait(tmp_path):
    ck = pckpt.Checkpointer(tmp_path, every=1)
    ck.save_async(1, {"bad": _Unwritable()})
    with pytest.raises(pckpt.CheckpointWriteError, match="3 attempt"):
        ck.wait()
    assert not list(tmp_path.glob("*.npz"))


# --- trainer -----------------------------------------------------------------


def _fed_data(seed=0):
    rng = np.random.default_rng(seed)
    cx = rng.uniform(0, 1, (C, S, N)).astype(np.float32)
    cy = rng.integers(0, 2, (C, S)).astype(np.int32)
    cm = np.ones((C, S), np.float32)
    tx = rng.uniform(0, 1, (20, N)).astype(np.float32)
    ty = rng.integers(0, 2, 20).astype(np.int32)
    return cx, cy, cm, tx, ty


def _ref_perms(round_key):
    """The (C, E, S) shuffles the reference's folded local update draws
    from ``round_key`` (fed/round.py → fed/client.py)."""
    train_key = jax.random.fold_in(round_key, TRAIN_KEY_SALT)
    out = []
    for cid in range(C):
        ekey = jax.random.split(jax.random.fold_in(train_key, cid), 1)[0]
        out.append([np.asarray(jax.random.permutation(
            jax.random.split(ekey)[0], S))])
    return torch.as_tensor(np.asarray(out), dtype=torch.int64)


_CFG = dict(local_epochs=1, batch_size=BATCH, learning_rate=0.1,
            momentum=0.9, optimizer="sgd")
SEED = 5


@pytest.fixture(scope="module")
def reference_run():
    """The reference trainer's rows and θ after 2 rounds (run once)."""
    mp = pytest.MonkeyPatch()
    try:
        for pin in ("QFEDX_FUSE", "QFEDX_SCAN_LAYERS", "QFEDX_BATCHED"):
            mp.setenv(pin, "1")
        mp.setenv("QFEDX_PALLAS", "0")
        mp.setenv("QFEDX_GATE_FORM", "flip")
        mp.setenv("QFEDX_SLAB_LANES", "matmul")
        mp.setattr(rfuse, "_gather_ok", lambda: True)
        mp.setattr(rfuse, "_growmat_merge_ok", lambda: True)
        model = ref_make(N, L, 2)
        rows = []
        res = ref_train(
            model, RFedConfig(**_CFG), *_fed_data(), num_rounds=2, seed=SEED,
            mesh=client_mesh(num_devices=1), rounds_per_call=1,
            on_round_end=lambda r, m: rows.append(dict(m)),
        )
        init_key, base = jax.random.split(jax.random.PRNGKey(SEED))
        init = jax.tree.map(np.asarray, model.init(init_key))
        perms = [_ref_perms(jax.random.fold_in(base, r)) for r in range(2)]
        return {"rows": rows, "params": jax.tree.map(np.asarray, res.params),
                "accuracies": res.accuracies, "init": init, "perms": perms}
    finally:
        mp.undo()


def _port_train(reference_run, **kw):
    rows = []
    model = make_vqc_classifier(N, L, 2, device="cpu")
    res = train_federated(
        model, FedConfig(**_CFG), *_fed_data(), num_rounds=kw.pop(
            "num_rounds", 2), seed=SEED,
        on_round_end=lambda r, m: rows.append(dict(m)),
        params=params_from_jax(reference_run["init"], device="cpu"),
        perms_for_round=lambda r: reference_run["perms"][r], **kw,
    )
    return res, rows


def test_trainer_matches_reference(monkeypatch, reference_run):
    _port_pallas(monkeypatch)
    res, rows = _port_train(reference_run, rounds_per_call=1)
    want = reference_run["rows"]
    assert [r["round"] for r in rows] == [r["round"] for r in want] == [1, 2]
    for got, ref in zip(rows, want):
        assert abs(got["loss"] - ref["loss"]) <= SGD_ATOL
        assert got["accuracy"] == ref["accuracy"]
        assert got["n"] == ref["n"]
        assert abs(got["auc"] - ref["auc"]) <= 1e-6
        for k in ("rejected_updates", "chunk_rounds"):
            assert got[k] == ref[k]
        assert set(got) == set(ref)
    assert res.accuracies == reference_run["accuracies"]
    for a, b in zip(trees.tree_leaves(res.params),
                    jax.tree.leaves(reference_run["params"])):
        np.testing.assert_allclose(a.numpy(), b, atol=SGD_ATOL, rtol=0)
    assert res.comm_mb_per_round == 2 * 4 * (2 * L * N + 4) / 1e6


def test_in_chunk_evaluation_gives_the_same_rows(monkeypatch, reference_run):
    _port_pallas(monkeypatch)
    _, one = _port_train(reference_run, rounds_per_call=1)
    res, two = _port_train(reference_run, rounds_per_call=2)
    for a, b in zip(one, two):
        assert b["chunk_rounds"] == 2 and b["eval_n"] == 20
        assert a["loss"] == b["loss"]
        assert a["rejected_updates"] == b["rejected_updates"]
        # The in-chunk accuracy is an f32 mean of the same hits.
        assert abs(a["accuracy"] - b["accuracy"]) <= 1e-6
    assert res.accuracies[0] == reference_run["accuracies"][0]


def test_resume_equals_the_uninterrupted_run(monkeypatch, tmp_path):
    _port_pallas(monkeypatch)
    cx, cy, cm, tx, ty = _fed_data(1)
    cfg = FedConfig(**_CFG)

    def run(num_rounds, directory):
        rows = []
        res = train_federated(
            make_vqc_classifier(N, L, 2, device="cpu"), cfg, cx, cy, cm, tx,
            ty, num_rounds=num_rounds, seed=3,
            checkpointer=pckpt.Checkpointer(directory, every=1),
            on_round_end=lambda r, m: rows.append(m),
        )
        return res, rows

    whole, whole_rows = run(3, tmp_path / "a")
    run(1, tmp_path / "b")
    resumed, rows = run(3, tmp_path / "b")
    assert [r["round"] for r in rows] == [2, 3]
    assert [r["loss"] for r in rows] == [r["loss"] for r in whole_rows[1:]]
    for a, b in zip(trees.tree_leaves(resumed.params),
                    trees.tree_leaves(whole.params)):
        assert torch.equal(a, b)
    assert sorted(p.name for p in (tmp_path / "a").glob("*.npz")) == [
        "ckpt_000001.npz", "ckpt_000002.npz", "ckpt_000003.npz"]


def test_trainer_crash_drains_the_writer(monkeypatch, tmp_path):
    _port_pallas(monkeypatch)
    ck = pckpt.Checkpointer(tmp_path, every=1)

    def boom(r, m):
        if r == 1:
            raise KeyError("hook failed")

    with pytest.raises(KeyError, match="hook failed"):
        train_federated(
            make_vqc_classifier(N, L, 2, device="cpu"), FedConfig(**_CFG),
            *_fed_data(), num_rounds=3, checkpointer=ck, on_round_end=boom,
        )
    assert ck._thread is None
    assert (tmp_path / "ckpt_000001.npz").exists()


# --- CLI ---------------------------------------------------------------------


@pytest.fixture()
def small_data(monkeypatch):
    """The CLI at a small synthetic set (the flags do not size it)."""
    monkeypatch.setattr(pcli, "DataConfig", functools.partial(
        pconfig.DataConfig, synthetic_train=256, synthetic_test=128))


def _train_argv(root, *extra):
    return ["train", "--model", "vqc", "--qubits", str(N), "--layers",
            str(L), "--classes", "0,1", "--clients", "2", "--rounds", "2",
            "--local-epochs", "1", "--checkpoint-every", "1",
            "--lr", "0.1", "--run-root", str(root), "--name", "cli", *extra]


def test_cli_train_then_serve(monkeypatch, tmp_path, small_data, capsys):
    _port_pallas(monkeypatch)
    summary = pcli.main(_train_argv(tmp_path), device="cpu")
    run = tmp_path / "cli"
    rows = [json.loads(line) for line in
            (run / "metrics.jsonl").read_text().splitlines()]
    assert [r["round"] for r in rows] == [1, 2]
    for r in rows:
        rmetrics.validate_metrics_record(r)
        assert r["schema"] == 1 and np.isfinite(r["loss"])
    saved = json.loads((run / "summary.json").read_text())
    assert saved["final_accuracy"] == summary["final_accuracy"]
    assert saved["rounds"] == 2 and saved["final_epsilon"] is None
    cfg = rconfig.experiment_config_from_dict(
        json.loads((run / "config.json").read_text()))
    assert cfg.model.n_qubits == N and cfg.data.classes == (0, 1)
    ck = rckpt.Checkpointer(run / "checkpoints", every=1)
    for r in (1, 2):
        ck.verify(r)

    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (5, N)).astype(np.float32)
    lines = [json.dumps({"id": f"q{i}", "features": v.tolist()})
             for i, v in enumerate(x)]
    lines.insert(2, "{not json")
    lines.append(json.dumps([0.5] * (N - 1)))  # wrong shape
    (tmp_path / "in.jsonl").write_text("\n".join(lines) + "\n")
    out = tmp_path / "out.jsonl"
    served = pcli.main(["serve", "--run-dir", str(run), "--input",
                        str(tmp_path / "in.jsonl"), "--output", str(out),
                        "--buckets", "1,8"], device="cpu")
    resp = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["id"] for r in resp] == ["q0", "q1", 2, "q2", "q3", "q4", 6]
    assert [r.get("code") for r in resp] == [None, None, 400, None, None,
                                             None, 400]
    assert served["served"] == 5 and served["responses"] == 7
    model = make_vqc_classifier(N, L, 2, device="cpu")
    params, r = pckpt.Checkpointer(run / "checkpoints").restore_latest(
        model.init(0))
    assert r == 2
    with torch.no_grad():
        want = model.apply(params, x).numpy()
    got = np.array([q["logits"] for q in resp if "logits" in q])
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def test_run_train_takes_prebuilt_data(monkeypatch, tmp_path, small_data):
    """``run_train(data=)`` trains on what ``build_data`` gave the same
    config, without building it again, to the CLI run's rows."""
    _port_pallas(monkeypatch)
    pcli.main(_train_argv(tmp_path), device="cpu")
    args = pcli.build_parser().parse_args(_train_argv(tmp_path)[:-2]
                                          + ["--name", "prebuilt"])
    cfg = pcli.config_from_args(args)
    data = pcli.build_data(cfg)

    def no_build(_cfg):
        raise AssertionError("build_data called with data given")

    monkeypatch.setattr(pcli, "build_data", no_build)
    pcli.run_train(cfg, device="cpu", data=data)
    rows = {name: [json.loads(line) for line in (
        tmp_path / name / "metrics.jsonl").read_text().splitlines()]
        for name in ("cli", "prebuilt")}
    assert [(r["round"], r["loss"], r["accuracy"]) for r in rows["cli"]] == [
        (r["round"], r["loss"], r["accuracy"]) for r in rows["prebuilt"]]


@pytest.mark.parametrize("extra", [
    ["--plots"], ["--profile"], ["--trace"], ["--tuned", "x.json"],
    ["--sv-size", "4"],
    ["--sv-size", "2"],
])
def test_cli_unported_paths_raise(tmp_path, small_data, extra):
    with pytest.raises(NotImplementedError):
        pcli.main(_train_argv(tmp_path, *extra), device="cpu")


@pytest.mark.parametrize("argv", [
    ["inspect", "runs/x"], ["lint"], ["demo"], ["sweep"],
    ["bench", "history"], ["tune", "--run-dir", "x"],
])
def test_cli_unported_subcommands_raise(argv):
    with pytest.raises(NotImplementedError, match="not ported"):
        pcli.main(argv, device="cpu")


@pytest.mark.parametrize("argv", [
    ["serve", "--run-dir", "x", "--bogus"], ["train", "--bogus"],
])
def test_cli_unknown_flags_are_usage_errors(argv):
    with pytest.raises(SystemExit) as exc:
        pcli.main(argv, device="cpu")
    assert exc.value.code == 2


@pytest.mark.parametrize("model,encoding", [
    ("vqc", "angle"), ("vqc", "amplitude"), ("cnn", "angle"),
])
def test_feature_shape_for(model, encoding):
    from qfedx_tpu.serve.engine import feature_shape_for as ref_shape
    from qfedx_tpu_torch.serve.engine import feature_shape_for

    def cfg(mod):
        return mod.ExperimentConfig(model=mod.ModelConfig(
            model=model, n_qubits=N, encoding=encoding))

    assert feature_shape_for(cfg(pconfig)) == ref_shape(cfg(rconfig))


def test_build_model_scan_layers_ledger_restores_the_pin(monkeypatch):
    monkeypatch.delenv("QFEDX_SCAN_LAYERS", raising=False)
    monkeypatch.setattr(pconfig, "_SCAN_ENV_SAVED", [])
    mk = lambda s: pconfig.ExperimentConfig(  # noqa: E731
        model=pconfig.ModelConfig(n_qubits=N, scan_layers=s))
    pconfig.build_model(mk(False), 2, device="cpu")
    import os

    assert os.environ["QFEDX_SCAN_LAYERS"] == "0"
    pconfig.build_model(mk(None), 2, device="cpu")
    assert "QFEDX_SCAN_LAYERS" not in os.environ
