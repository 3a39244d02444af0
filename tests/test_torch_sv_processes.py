"""sv groups across processes (gloo) ≡ the same groups in one process,
and ≡ the reference's sharded model.

One spawn per world size (``tests/_torch_sv_worker.py``, 2 and 4 gloo
processes of one torch thread each) runs every case of that size: a
(1, 2) mesh on 2 processes, a (1, 4) mesh on 2 processes × 2 CPU slots
(global qubit 0 crosses the processes through ``batch_isend_irecv``,
qubit 1 stays inside each through ``.to()``), a (2, 2) mesh on 4
processes (both axes cross), and a (1, 4) mesh on 4 processes under
circuit-level trajectories, all at n = 10, L = 2 (2 global qubits at
most: the fused local path runs at 8 local qubits). Every rank's
forward logits, one step's gradient leaf by leaf (``rx``, ``rz``, the
readout's scale and bias: the readout is not multiplied by the group
size) and a flat SGD round's θ and loss (each group's update counted
once), and outside the noise case a trimmed_mean round's θ (each
group's client rows gathered once) and the trainer's θ, losses and
accuracies on its default mesh, are held against ``run_case`` over a
one-process mesh of the same slot count within 1e-6; under noise no
branch choice differs. Both spawns run while this process computes
the reference's side and its own. The (1, 2)
and (2, 2) forward and round are also held against the reference's
``make_sharded_vqc_classifier`` on its 8-device virtual mesh, within
``tests/test_torch_fed_sharded.py``'s bounds (1e-4 logits, 1e-5 θ and
loss). Two ranks naming one GPU raise the mesh's own error.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ref_streams as streams
import _torch_sv_worker as worker
from conftest import free_port

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_WORKER = os.path.join(_REPO, "tests", "_torch_sv_worker.py")
CASE_WORLD = {name: world for world, cases in worker.CASES.items()
              for name in cases}
ATOL = 1e-6
ROUND_KEY = 9


def _perms():
    return streams.perms(jax.random.PRNGKey(ROUND_KEY), worker.CLIENTS, 1,
                         worker.SAMPLES)


def _start(world: int, out) -> list:
    np.save(out / "perms.npy", _perms().numpy())
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("QFEDX_") and k != "XLA_FLAGS"}
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    port = free_port()
    return [subprocess.Popen(
        [sys.executable, _WORKER, f"localhost:{port}", str(world), str(pid),
         str(out)], env=env, cwd=_REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for pid in range(world)]


def _finish(procs: list) -> None:
    logs = [p.communicate(timeout=240)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log[-4000:]}"


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """``spawned(world)``: the directory of the one spawn of ``world``
    processes. Both spawns start together on first use and run while
    this process computes its own side."""
    dirs = {w: tmp_path_factory.mktemp(f"sv{w}") for w in worker.CASES}
    procs = {w: _start(w, d) for w, d in dirs.items()}
    done = set()

    def get(world: int):
        if world not in done:
            _finish(procs[world])
            done.add(world)
        return dirs[world]

    try:
        yield get
    finally:
        for ps in procs.values():
            for p in ps:
                if p.poll() is None:
                    p.kill()


@pytest.fixture(scope="module")
def one_process():
    """``one_process(case)``: ``run_case`` over a one-process mesh of the
    case's slot count, on one torch thread, made on first use."""
    from qfedx_tpu_torch.parallel.mesh import fed_mesh

    done = {}

    def get(name: str) -> dict:
        if name not in done:
            slots, sv = worker.case_slots(name)
            devices = ["cpu"] * (CASE_WORLD[name] * slots)
            before = torch.get_num_threads()
            torch.set_num_threads(1)
            try:
                done[name] = worker.run_case(
                    name, fed_mesh(sv_size=sv, devices=devices), _perms(),
                    devices)
            finally:
                torch.set_num_threads(before)
        return done[name]

    return get


def _ranks(spawned, name):
    world = CASE_WORLD[name]
    out = spawned(world)
    return [np.load(out / f"{name}.{r}.npz") for r in range(world)]


def _hold(spawned, one_process, name, prefix):
    want = one_process(name)  # before waiting on the spawn
    keys = [k for k in want if k.startswith(prefix)]
    assert keys
    for r, got in enumerate(_ranks(spawned, name)):
        assert sorted(got.files) == sorted(want)
        for k in keys:
            np.testing.assert_allclose(got[k], want[k], atol=ATOL, rtol=0,
                                       err_msg=f"rank {r} {k}")
    return want


@pytest.mark.parametrize("name,clients", [("sv2", 1), ("sv2x2", 2)])
def test_matches_reference_sharded_model(name, clients, spawned):
    """The reference's sharded model on its (clients, 2) mesh of virtual
    devices, from the port's init, with its round key's shuffles
    injected into the port's round: logits 1e-4, round θ and loss
    1e-5."""
    from qfedx_tpu.fed import round as rround
    from qfedx_tpu.fed.config import FedConfig as RFedConfig
    from qfedx_tpu.models import vqc_sharded as rvs

    model = rvs.make_sharded_vqc_classifier(
        worker.N, sv_size=2, n_layers=worker.LAYERS, num_classes=2)
    mesh = rvs.fed_mesh_2d(num_client_devices=clients, sv_size=2)
    from qfedx_tpu_torch.models.vqc_sharded import (
        make_sharded_vqc_classifier,
    )

    params = make_sharded_vqc_classifier(
        worker.N, 2, worker.LAYERS, 2, init_scale=0.5, device="cpu").init(5)
    rparams = {g: {k: jnp.asarray(v.numpy()) for k, v in params[g].items()}
               for g in params}
    cx, cy, cm, tx, _, _ = worker.data()
    logits = np.asarray(rvs.host_apply(model, mesh)(rparams,
                                                    jnp.asarray(tx[:6])))
    cfg = RFedConfig(local_epochs=1, batch_size=worker.BATCH,
                     learning_rate=0.1, momentum=0.0, optimizer="sgd")
    rp, rs = rround.make_fed_round(model, cfg, mesh,
                                   num_clients=worker.CLIENTS)(
        rparams, *rround.shard_client_data(mesh, cx, cy.astype(np.int32),
                                           jnp.asarray(cm)),
        jax.random.PRNGKey(ROUND_KEY))
    # The spawns run meanwhile; read them after the reference compiled.
    got = _ranks(spawned, name)[0]
    np.testing.assert_allclose(got["logits"], logits, atol=1e-4, rtol=0)
    for g in sorted(rp):
        for k in sorted(rp[g]):
            np.testing.assert_allclose(got[f"sgd.{g}.{k}"],
                                       np.asarray(rp[g][k]), atol=1e-5,
                                       rtol=0, err_msg=f"{g}.{k}")
    assert abs(float(got["sgd.mean_loss"]) - float(rs.mean_loss)) <= 1e-5


CASES = list(CASE_WORLD)
NOISELESS = [c for c in CASES if c != "noise"]


@pytest.mark.parametrize("name", CASES)
def test_forward_matches_one_process(name, spawned, one_process):
    want = _hold(spawned, one_process, name, "logits")
    assert np.all(np.isfinite(want["logits"]))


@pytest.mark.parametrize("name", CASES)
def test_gradients_match_one_process_leaf_by_leaf(name, spawned,
                                                  one_process):
    """Every leaf: the circuit's angles (the sum of the processes'
    partials) and the readout (applied after the sum: exact on every
    rank, not multiplied by the group size)."""
    want = _hold(spawned, one_process, name, "grad.")
    assert sorted(k for k in want if k.startswith("grad.")) == [
        "grad.ansatz.rx", "grad.ansatz.rz", "grad.readout.bias",
        "grad.readout.scale"]
    for k in ("grad.ansatz.rx", "grad.readout.scale"):
        assert np.abs(want[k]).max() > 1e-4, k
    _hold(spawned, one_process, name, "train_logits")


@pytest.mark.parametrize("name", CASES)
def test_sgd_round_matches_one_process(name, spawned, one_process):
    """Each group's update enters the world's sum once, from its lead."""
    want = _hold(spawned, one_process, name, "sgd.")
    assert np.isfinite(want["sgd.mean_loss"])
    assert float(want["sgd.num_participants"]) == worker.CLIENTS


@pytest.mark.parametrize("name", NOISELESS)
def test_trimmed_round_matches_one_process(name, spawned, one_process):
    """Each group's client rows are gathered once."""
    _hold(spawned, one_process, name, "trimmed.")


@pytest.mark.parametrize("name", NOISELESS)
def test_trainer_default_mesh_matches_one_process(name, spawned,
                                                  one_process):
    want = _hold(spawned, one_process, name, "trainer.")
    assert len(want["trainer.losses"]) == 2


def test_noise_no_branch_choice_differs(spawned, one_process):
    """The Born weights come from one all-reduce every member uses: the
    four processes pick the one-process run's branch every time."""
    want = one_process("noise")
    choices = want["branches"].size
    assert choices == 6 * worker.LAYERS * 2 * worker.N
    for got in _ranks(spawned, "noise"):
        assert int((got["branches"] != want["branches"]).sum()) == 0


def test_two_ranks_on_one_gpu_refused(spawned):
    """Both ranks of the pair name cuda:0 of one host: the mesh's own
    error, on every rank, before any NCCL call could fail or hang."""
    out = spawned(2)
    for r in range(2):
        said = (out / f"duplicate.{r}.txt").read_text()
        assert "ranks 0 and 1 both hold cuda:0" in said
        assert "one process per GPU" in said
