"""The 2-D mesh: clients axis × sharded-statevector axis, port vs
reference (``tests/test_fed_sharded.py``'s cases).

The port's (2, 4) mesh puts eight slots on the CPU; the reference's is
its 8-device virtual CPU mesh. n = 5 (2 global qubits, 3 local). Each
case holds the port's sharded model against the reference's program on
the same seeded numpy inputs and against the port's dense model:

- ``host_apply`` = the dense apply = the reference's ``host_apply``
  (1e-4, the reference's bound), angle and amplitude encodings, and
  under the analytic readout channels;
- one SGD round on the (2, 4) mesh = the port's dense one-slot round =
  the reference's 2-D round, its shuffles injected (1e-5 θ, 1e-5 loss);
- trajectories sample for sample: the reference's draws
  (``tests/_torch_ref_streams.py``) through the port's sharded and dense
  ``apply_train`` — no branch choice differs, logits 1e-5 apart, and
  within 1e-4 of the reference's dense ``apply_train``;
- finite shots: the sharded and dense ``apply_train`` on the same
  uniforms (1e-6);
- the CLI's ``--sv-size 4`` run over ``devices=["cpu"] * 8`` against
  the reference CLI's over its eight virtual devices (its init and
  shuffles injected): rows and final θ;
- the mesh's ValueErrors, with the reference's messages.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ref_streams as streams
from qfedx_tpu.fed import round as rround
from qfedx_tpu.fed.config import FedConfig as RFedConfig
from qfedx_tpu.models import vqc_sharded as rvs
from qfedx_tpu.models.vqc import make_vqc_classifier as ref_make
from qfedx_tpu.noise.channels import NoiseModel as RNoiseModel
from qfedx_tpu_torch.fed.config import FedConfig
from qfedx_tpu_torch.fed.round import (
    RoundDraws,
    make_fed_round,
    shard_client_data,
)
from qfedx_tpu_torch.models.api import params_from_jax
from qfedx_tpu_torch.models.vqc import make_vqc_classifier
from qfedx_tpu_torch.models.vqc_sharded import (
    fed_mesh_2d,
    host_apply,
    make_sharded_vqc_classifier,
)
from qfedx_tpu_torch.noise import channels as pch
from qfedx_tpu_torch.noise.trajectory import record_branches
from qfedx_tpu_torch.parallel.sharded import sv_group
from qfedx_tpu_torch.utils import trees

N = 5  # 2 global (sv = 4), 3 local
SLOTS = ["cpu"] * 8


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def dot_form(monkeypatch):
    # The reference's XLA:CPU gate form below n = 10 (its dense tests').
    monkeypatch.setenv("QFEDX_GATE_FORM", "dot")


@pytest.fixture(scope="module")
def mesh2d():
    return fed_mesh_2d(num_client_devices=2, sv_size=4, devices=SLOTS)


@pytest.fixture(scope="module")
def ref_mesh2d():
    return rvs.fed_mesh_2d(num_client_devices=2, sv_size=4)


def _port(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree), device="cpu")


def _models(**kw):
    rnm = kw.pop("noise", None)
    pnm = None if rnm is None else pch.NoiseModel(**dataclasses.asdict(rnm))
    return (ref_make(N, noise_model=rnm, **kw),
            make_vqc_classifier(N, device="cpu", noise_model=pnm, **kw),
            make_sharded_vqc_classifier(N, sv_size=4, device="cpu",
                                        noise_model=pnm, **kw))


@pytest.mark.parametrize("encoding", ["angle", "amplitude"])
def test_sharded_apply_matches_dense(mesh2d, ref_mesh2d, encoding):
    rdense, dense, sharded = _models(n_layers=2, num_classes=2,
                                     encoding=encoding)
    rparams = rdense.init(jax.random.PRNGKey(1))
    params = _port(rparams)
    rng = np.random.default_rng(3)
    if encoding == "angle":
        x = rng.uniform(0, 1, (6, N)).astype(np.float32)
    else:
        x = rng.normal(size=(5, 1 << N)).astype(np.float32)
        x[2] = 0.0  # the uniform-superposition fallback row
    got = host_apply(sharded, mesh2d)(params, x).numpy()
    np.testing.assert_allclose(got, dense.apply(params, x).detach().numpy(),
                               atol=1e-4)
    np.testing.assert_allclose(got, np.asarray(rdense.apply(rparams, x)),
                               atol=1e-4)
    if encoding == "angle":
        rsharded = rvs.make_sharded_vqc_classifier(N, sv_size=4, n_layers=2,
                                                   num_classes=2)
        want = np.asarray(rvs.host_apply(rsharded, ref_mesh2d)(
            rparams, jnp.asarray(x)))
        np.testing.assert_allclose(got, want, atol=1e-4)
    assert sharded.name == rvs.make_sharded_vqc_classifier(
        N, sv_size=4, n_layers=2, num_classes=2, encoding=encoding).name
    assert sharded.apply_clients is None and sharded.sv_size == 4


def test_fed_round_2d_matches_dense_1d(mesh2d, ref_mesh2d):
    """One SGD round on the (2, 4) mesh ≡ the port's dense one-slot round
    ≡ the reference's 2-D round (same params, data, shuffles)."""
    rdense, dense, sharded = _models(n_layers=2, num_classes=2)
    clients, samples = 4, 8
    kw = dict(local_epochs=1, batch_size=4, learning_rate=0.1, momentum=0.0,
              optimizer="sgd")
    rng = np.random.default_rng(1)
    cx = rng.uniform(0, 1, (clients, samples, N)).astype(np.float32)
    cy = rng.integers(0, 2, (clients, samples)).astype(np.int32)
    cm = np.ones((clients, samples), dtype=np.float32)
    rparams = rdense.init(jax.random.PRNGKey(7))
    params = _port(rparams)
    rkey = jax.random.PRNGKey(9)
    perms = streams.perms(rkey, clients, 1, samples)

    p2d, s2d = make_fed_round(sharded, FedConfig(**kw), clients,
                              mesh=mesh2d)(
        params, *shard_client_data(mesh2d, cx, cy, cm), perms=perms,
        draws=RoundDraws(0, 0))
    p1d, s1d = make_fed_round(dense, FedConfig(**kw), clients)(
        params, *(torch.as_tensor(a) for a in (cx, cy, cm)), perms=perms,
        draws=RoundDraws(0, 0))
    rsharded = rvs.make_sharded_vqc_classifier(N, sv_size=4, n_layers=2,
                                               num_classes=2)
    rround_fn = rround.make_fed_round(rsharded, RFedConfig(**kw),
                                      ref_mesh2d, num_clients=clients)
    rp, rs = rround_fn(rparams, *rround.shard_client_data(
        ref_mesh2d, cx, cy, jnp.asarray(cm)), rkey)
    for a, b, c in zip(trees.tree_leaves(p2d), trees.tree_leaves(p1d),
                       jax.tree.leaves(rp)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)
        np.testing.assert_allclose(a.numpy(), np.asarray(c), atol=1e-5)
    assert abs(float(s2d.mean_loss) - float(s1d.mean_loss)) <= 1e-5
    assert abs(float(s2d.mean_loss) - float(rs.mean_loss)) <= 1e-5
    assert float(s2d.num_participants) == clients


def test_sharded_readout_noise_matches_dense(mesh2d):
    """The analytic readout channels act on ⟨Z⟩ after the sum over the
    slots: sharded eval under noise ≡ the dense eval ≡ the reference's."""
    nm = RNoiseModel(depolarizing_p=0.2, amp_damping_gamma=0.1,
                     readout_e01=0.05, readout_e10=0.05)
    rdense, dense, sharded = _models(n_layers=2, num_classes=2, noise=nm)
    rparams = rdense.init(jax.random.PRNGKey(2))
    params = _port(rparams)
    x = np.random.default_rng(4).uniform(0, 1, (4, N)).astype(np.float32)
    got = host_apply(sharded, mesh2d)(params, x).numpy()
    np.testing.assert_allclose(got, dense.apply(params, x).detach().numpy(),
                               atol=1e-4)
    np.testing.assert_allclose(got, np.asarray(rdense.apply(rparams, x)),
                               atol=1e-4)


def test_sharded_trajectory_noise_matches_dense_sample_for_sample(mesh2d):
    """Circuit-level Kraus trajectories on the reference's draws: the
    Born weights summed over the slots pick the dense engine's branch
    every time (no choice differs), the logits agree with the port's
    dense trajectories (1e-5) and the reference's dense ``apply_train``
    on the same key (1e-4)."""
    nm = RNoiseModel(depolarizing_p=0.15, amp_damping_gamma=0.1,
                     circuit_level=True)
    rdense, dense, sharded = _models(n_layers=2, num_classes=2, noise=nm)
    assert [d.stream for d in sharded.train_draws] == [
        d.stream for d in dense.train_draws] == ["branch_gumbel"]
    rparams = rdense.init(jax.random.PRNGKey(5))
    params = _port(rparams)
    x = np.random.default_rng(6).uniform(0, 1, (4, N)).astype(np.float32)
    key = jax.random.PRNGKey(77)
    branches = tuple(int(k.re.shape[0]) for k in nm.kraus_channels())
    draws = {"branch_gumbel": torch.tensor(streams.branch_gumbel(
        streams.sample_keys(key, 4), 2, branches, N))}
    with torch.no_grad(), record_branches() as shard_log, sv_group(
            mesh2d.client_groups()[0]):
        got = sharded.apply_train(params, x, draws).numpy()
    with torch.no_grad(), record_branches() as dense_log:
        want = dense.apply_train(params, x, draws).numpy()
    assert len(shard_log) == len(dense_log) == 2 * 2 * N
    assert sum(int((a != b).sum())
               for a, b in zip(shard_log, dense_log)) == 0
    np.testing.assert_allclose(got, want, atol=1e-5)
    ref = np.asarray(jax.jit(rdense.apply_train)(rparams, jnp.asarray(x),
                                                 key))
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_sharded_shots_train_matches_dense(mesh2d):
    """Finite-shot training noise: the same uniforms give the same counts
    on the sharded and dense paths; evaluation stays deterministic."""
    nm = RNoiseModel(shots=128)
    rdense, dense, sharded = _models(n_layers=1, num_classes=2, noise=nm)
    params = _port(rdense.init(jax.random.PRNGKey(8)))
    x = np.random.default_rng(9).uniform(0, 1, (4, N)).astype(np.float32)
    u = torch.as_tensor(np.random.default_rng(21).uniform(0, 1, (4, 2)))
    with sv_group(mesh2d.client_groups()[1]):
        got = sharded.apply_train(params, x, {"shot_uniform": u})
    want = dense.apply_train(params, x, {"shot_uniform": u})
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               atol=1e-6)
    fwd = host_apply(sharded, mesh2d)
    np.testing.assert_array_equal(fwd(params, x).numpy(),
                                  fwd(params, x).numpy())


def test_cli_sv_size_trains_end_to_end(tmp_path, monkeypatch):
    """``train --model vqc --qubits 8 --sv-size 4`` through each
    package's CLI at a 256/128-sample synthetic set, under SGD: the port
    over eight CPU slots (the trainer's default mesh, (2, 4)), the
    reference over its eight virtual devices, the port from the
    reference's init with the reference's shuffles injected. Both runs
    evaluate through ``host_apply`` between rounds. Per-round loss and
    final θ within 1e-5 (the SGD round's bound above), accuracy within
    one evaluation sample, the same run files."""
    import functools
    import json

    from qfedx_tpu.run import cli as rcli
    from qfedx_tpu.run import config as rconfig
    from qfedx_tpu.run import trainer as rtrainer
    from qfedx_tpu_torch.run import cli as pcli
    from qfedx_tpu_torch.run import config as pconfig
    from qfedx_tpu_torch.run import trainer as ptrainer

    for mod, dc in ((rcli, rconfig.DataConfig), (pcli, pconfig.DataConfig)):
        monkeypatch.setattr(mod, "DataConfig", functools.partial(
            dc, synthetic_train=256, synthetic_test=128))
    argv = [
        "train", "--model", "vqc", "--qubits", "8", "--sv-size", "4",
        "--layers", "1", "--classes", "0,1", "--clients", "4",
        "--rounds", "2", "--local-epochs", "1", "--batch-size", "8",
        "--lr", "0.1", "--optimizer", "sgd", "--name", "sv",
    ]
    rcfg = rcli.config_from_args(rcli.build_parser().parse_args(
        argv + ["--run-root", str(tmp_path / "ref")]))
    cfg = pcli.config_from_args(pcli.build_parser().parse_args(
        argv + ["--run-root", str(tmp_path / "port")]))
    assert cfg.model.sv_size == rcfg.model.sv_size == 4
    data = rconfig.build_data(rcfg)
    clients, samples = data["cx"].shape[:2]
    init_key, base = jax.random.split(jax.random.PRNGKey(rcfg.seed))
    init = jax.tree.map(np.asarray, rconfig.build_model(
        rcfg, data["num_classes"]).init(init_key))
    perms = [streams.perms(jax.random.fold_in(base, r), clients,
                           rcfg.fed.local_epochs, samples) for r in range(2)]
    final = {}

    def keep(fn, name, **inject):
        def run(*a, **kw):
            res = fn(*a, **kw, **inject)
            final[name] = [np.asarray(t) for t in (
                jax.tree.leaves(res.params) if name == "ref"
                else trees.tree_leaves(res.params))]
            return res
        return run

    monkeypatch.setattr(rtrainer, "train_federated",
                        keep(rtrainer.train_federated, "ref"))
    want = rcli.run_train(rcfg)
    monkeypatch.setattr(ptrainer, "train_federated", keep(
        ptrainer.train_federated, "port",
        params=params_from_jax(init, device="cpu"),
        perms_for_round=lambda r: perms[r]))
    got = pcli.run_train(cfg, device="cpu", devices=SLOTS)
    rows = {k: [json.loads(line) for line in (
        tmp_path / k / "sv" / "metrics.jsonl").read_text().splitlines()]
        for k in ("ref", "port")}
    assert [r["round"] for r in rows["port"]] == [1, 2]
    n_eval = rows["ref"][0]["n"]
    for a, b in zip(rows["port"], rows["ref"]):
        assert abs(a["loss"] - b["loss"]) <= 1e-5
        assert abs(a["accuracy"] - b["accuracy"]) <= 1.0 / n_eval + 1e-9
        assert a["n"] == b["n"] and a["chunk_rounds"] == b["chunk_rounds"]
    assert abs(got["final_accuracy"] - want["final_accuracy"]) <= (
        1.0 / n_eval + 1e-9)
    for a, b in zip(final["port"], final["ref"]):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
    for k in ("ref", "port"):
        assert (tmp_path / k / "sv" / "summary.json").exists()


def test_mesh_validation():
    for call, ref_call, match in [
        (lambda: make_sharded_vqc_classifier(6, sv_size=3, device="cpu"),
         lambda: rvs.make_sharded_vqc_classifier(6, sv_size=3),
         "power of two"),
        (lambda: make_sharded_vqc_classifier(3, sv_size=4, device="cpu"),
         lambda: rvs.make_sharded_vqc_classifier(3, sv_size=4),
         "local qubits"),
        (lambda: fed_mesh_2d(num_client_devices=4, sv_size=4,
                             devices=SLOTS),
         lambda: rvs.fed_mesh_2d(num_client_devices=4, sv_size=4),
         "devices"),
        (lambda: make_sharded_vqc_classifier(6, sv_size=2, device="cpu",
                                             encoding="reupload"),
         lambda: rvs.make_sharded_vqc_classifier(6, sv_size=2,
                                                 encoding="reupload"),
         "angle/amplitude"),
    ]:
        with pytest.raises(ValueError, match=match) as got:
            call()
        with pytest.raises(ValueError) as want:
            ref_call()
        assert str(got.value) == str(want.value)
    # Outside an sv group the bare apply raises; so do the evaluator and
    # the serving engine without host_apply (the reference's message).
    from qfedx_tpu_torch.fed.evaluate import make_evaluator
    from qfedx_tpu_torch.serve.engine import ServeEngine

    model = make_sharded_vqc_classifier(5, sv_size=4, device="cpu")
    with pytest.raises(ValueError, match="sv group"):
        model.apply(model.init(0), np.zeros((1, 5), np.float32))
    with pytest.raises(ValueError, match="host_apply"):
        make_evaluator(model)
    with pytest.raises(ValueError, match="host_apply"):
        ServeEngine(model, model.init(0), (5,), device="cpu")
