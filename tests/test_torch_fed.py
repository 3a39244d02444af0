"""Port vs reference: the federated round (qfedx_tpu_torch/fed/).

The reference's ``make_fed_round`` runs on a one-device client mesh
with guards on (its default program) and the client fold on; the port's
``make_fed_round`` runs the same folded round on the CPU, where the
scan-body kernel's Function (``ScanBodyFn``) takes its plain sweeps.
Same weights, same seeded numpy data, and the per-client shuffles the
reference drew from its key stream — recomputed here with jax as
``fed/client.py`` derives them — injected into the port as ``perms``.
Sizes: n=10 (the narrowest width that reaches the kernel), L=2, C=2
clients of S=8 samples, batch 4, E=1.

The reference runs its ``lax.scan`` route (QFEDX_PALLAS=0), which is
exact against its interpreted kernel (tests/test_pallas.py), to keep
its compile short; the port runs its kernel route (QFEDX_PALLAS=1).

Tolerances: θ and ``mean_loss`` within 1e-5 under SGD (momentum 0.9,
and FedProx), ``total_weight`` exactly. Under Adam the last layer's
``rz`` leaf is left out: the HEA's final RZ phases commute with the CNOT
ring and with Z, so their gradient is zero analytically and both
packages see only rounding noise there, which Adam's m/√v turns into
steps of about ±lr — those steps cannot agree between two programs. Every
other leaf agrees within 1e-4, and so do the trained models' logits on a
held-out batch. Adam is scale-invariant, so a step's error is lr times
the gradient's RELATIVE error; gradient components of ~1e-6 carry f32
relative errors of ~1e-3 in either package. The Adam test therefore
starts from the model's own init (not the widened one the SGD tests
use) on data where the reference's kernel-on and kernel-off routes also
agree within 1e-4, which it asserts — on other data the reference
differs from itself by more than that on such leaves, while the logits
still agree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from qfedx_tpu.fed.config import FedConfig as RFedConfig
from qfedx_tpu.fed.round import (
    TRAIN_KEY_SALT,
    client_mesh,
    make_fed_round as ref_make_round,
    shard_client_data,
)
from qfedx_tpu.models.vqc import make_vqc_classifier as ref_make
from qfedx_tpu.ops import fuse as rfuse
from qfedx_tpu_torch.fed import client as pclient
from qfedx_tpu_torch.fed.config import FedConfig
from qfedx_tpu_torch.fed.round import make_fed_round
from qfedx_tpu_torch.models.vqc import make_vqc_classifier, params_from_jax
from qfedx_tpu_torch.ops import scan_body
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


N, L, C, S, BATCH, E = 10, 2, 2, 8, 4, 1
SGD_ATOL = 1e-5
ADAM_ATOL = 1e-4


@pytest.fixture(autouse=True)
def tpu_form(monkeypatch):
    for pin in ("QFEDX_FUSE", "QFEDX_SCAN_LAYERS", "QFEDX_PALLAS",
                "QFEDX_BATCHED"):
        monkeypatch.setenv(pin, "1")
    monkeypatch.setenv("QFEDX_GATE_FORM", "flip")
    monkeypatch.setenv("QFEDX_SLAB_LANES", "matmul")
    monkeypatch.setattr(rfuse, "_gather_ok", lambda: True)
    monkeypatch.setattr(rfuse, "_growmat_merge_ok", lambda: True)


def _data(seed=0, nan_client=None):
    rng = np.random.default_rng(seed)
    cx = rng.uniform(0, 1, (C, S, N)).astype(np.float32)
    cy = rng.integers(0, 2, (C, S)).astype(np.int32)
    cm = np.ones((C, S), np.float32)
    if nan_client is not None:
        cx[nan_client] = np.nan
    return cx, cy, cm


def _ref_params(model, scale=10.0):
    p = model.init(jax.random.PRNGKey(0))
    # By default widen the near-identity init so the circuit is far from
    # trivial.
    return {
        "ansatz": {k: np.asarray(v) * scale for k, v in p["ansatz"].items()},
        "readout": {k: np.asarray(v) for k, v in p["readout"].items()},
    }


def _ref_perms(round_key, epochs=E):
    """The (C, E, S) permutations the reference's folded local update
    draws for ``round_key`` (fed/round.py → fed/client.py)."""
    train_key = jax.random.fold_in(round_key, TRAIN_KEY_SALT)
    out = []
    for cid in range(C):
        ekeys = jax.random.split(jax.random.fold_in(train_key, cid), epochs)
        out.append([
            np.asarray(jax.random.permutation(jax.random.split(k)[0], S))
            for k in ekeys
        ])
    return torch.as_tensor(np.asarray(out), dtype=torch.int64)


def _run_ref(cfg_kwargs, rounds, monkeypatch, data, survivors=None,
             scale=10.0, pallas="0"):
    """θ and stats after each of ``rounds`` reference rounds."""
    monkeypatch.setenv("QFEDX_PALLAS", pallas)
    model = ref_make(N, L, 2)
    params = _ref_params(model, scale)
    cfg = RFedConfig(local_epochs=E, batch_size=BATCH, **cfg_kwargs)
    mesh = client_mesh(num_devices=1)
    rf = ref_make_round(model, cfg, mesh, num_clients=C)
    cx, cy, cm = shard_client_data(mesh, *(jnp.asarray(a) for a in data))
    out, perms = [], []
    for r in range(rounds):
        key = jax.random.PRNGKey(100 + r)
        params, stats = rf(params, cx, cy, cm, key, survivors)
        out.append((jax.tree.map(np.asarray, params), stats))
        perms.append(_ref_perms(key))
    monkeypatch.setenv("QFEDX_PALLAS", "1")
    return model, out, perms


def _run_port(cfg_kwargs, perms, data, survivors=None, scale=10.0):
    model = make_vqc_classifier(N, L, 2, device="cpu")
    params = params_from_jax(_ref_params(ref_make(N, L, 2), scale),
                             device="cpu")
    cfg = FedConfig(local_epochs=E, batch_size=BATCH, **cfg_kwargs)
    rf = make_fed_round(model, cfg, num_clients=C)
    cx, cy, cm = (torch.as_tensor(a) for a in data)
    out = []
    for p in perms:
        params, stats = rf(params, cx, cy, cm, perms=p, survivors=survivors)
        out.append((params, stats))
    return model, out


def _leaves(tree):
    return {f"{g}/{k}": v for g in sorted(tree) for k, v in
            sorted(tree[g].items())}


def _check_round(got, want, atol, skip=()):
    (gp, gs), (wp, ws) = got, want
    for name, w in _leaves(wp).items():
        if name in skip:
            continue
        g = _leaves(gp)[name]
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol,
                                   rtol=0, err_msg=name)
    np.testing.assert_allclose(float(gs.mean_loss), float(ws.mean_loss),
                               atol=atol, rtol=0)
    assert float(gs.total_weight) == float(ws.total_weight)
    for field in ("num_participants", "rejected_updates", "dropped_clients",
                  "applied"):
        assert float(getattr(gs, field)) == float(getattr(ws, field)), field


@pytest.mark.parametrize(
    "cfg_kwargs",
    [dict(learning_rate=0.1, momentum=0.9),
     dict(learning_rate=0.1, momentum=0.9, algorithm="fedprox",
          prox_mu=0.5)],
    ids=["sgd-momentum", "fedprox"],
)
def test_sgd_rounds_match_reference(cfg_kwargs, monkeypatch):
    """One round, then a second from the first's θ: θ, mean_loss and
    the counts after each equal the reference's."""
    data = _data()
    _, want, perms = _run_ref(cfg_kwargs, 2, monkeypatch, data)
    _, got = _run_port(cfg_kwargs, perms, data)
    for g, w in zip(got, want):
        _check_round(g, w, SGD_ATOL)


def test_adam_rounds_match_reference(monkeypatch):
    """Adam: every leaf a Z readout can see (all but the last layer's
    rz, see the module docstring) within 1e-4 after each of two rounds,
    and the trained models' logits on a held-out batch within 1e-4."""
    cfg_kwargs = dict(optimizer="adam", learning_rate=0.1)
    data = _data(seed=2)
    rmodel, want, perms = _run_ref(cfg_kwargs, 2, monkeypatch, data,
                                   scale=1.0)
    pmodel, got = _run_port(cfg_kwargs, perms, data, scale=1.0)
    # The reference's interpreted-kernel route agrees with its lax.scan
    # route on these leaves at this data (the premise of the tolerance).
    _, kernel_route, _ = _run_ref(cfg_kwargs, 2, monkeypatch, data,
                                  scale=1.0, pallas="1")
    for k, w in zip(kernel_route, want):
        as_torch = jax.tree.map(lambda a: torch.as_tensor(np.array(a)), k[0])
        _check_round((as_torch, k[1]), w, ADAM_ATOL, skip=("ansatz/rz",))
    for g, w in zip(got, want):
        _check_round(g, w, ADAM_ATOL, skip=("ansatz/rz",))
        np.testing.assert_allclose(
            g[0]["ansatz"]["rz"][:-1].numpy(),
            np.asarray(w[0]["ansatz"]["rz"])[:-1], atol=ADAM_ATOL, rtol=0,
        )
    held = np.random.default_rng(9).uniform(0, 1, (4, N)).astype(np.float32)
    monkeypatch.setenv("QFEDX_PALLAS", "0")
    want_logits = np.asarray(jax.jit(rmodel.apply)(want[-1][0], held))
    monkeypatch.setenv("QFEDX_PALLAS", "1")
    with torch.no_grad():
        got_logits = pmodel.apply(got[-1][0], held)
    np.testing.assert_allclose(got_logits.numpy(), want_logits,
                               atol=ADAM_ATOL, rtol=0)


def test_quarantine_matches_reference(monkeypatch):
    """A client whose features are NaN: its Δθ is zeroed, its weight is
    0 and rejected_updates is 1, as the reference shows on the same
    input; the round is the other client's."""
    cfg_kwargs = dict(learning_rate=0.1, momentum=0.9)
    data = _data(nan_client=1)
    _, want, perms = _run_ref(cfg_kwargs, 1, monkeypatch, data)
    _, got = _run_port(cfg_kwargs, perms, data)
    _check_round(got[0], want[0], SGD_ATOL)
    stats = got[0][1]
    assert float(stats.rejected_updates) == 1.0
    assert float(stats.num_participants) == 1.0
    assert float(stats.total_weight) == float(S)


def test_survivors_round_matches_reference(monkeypatch):
    """survivors = [1, 0]: client 1 is dropped (dropped_clients 1) and
    the round is the survivor-only round, as in the reference."""
    cfg_kwargs = dict(learning_rate=0.1, momentum=0.9)
    data = _data()
    surv = np.array([1.0, 0.0], np.float32)
    _, want, perms = _run_ref(cfg_kwargs, 1, monkeypatch, data,
                              survivors=jnp.asarray(surv))
    _, got = _run_port(cfg_kwargs, perms, data, survivors=surv)
    _check_round(got[0], want[0], SGD_ATOL)
    assert float(got[0][1].dropped_clients) == 1.0


def test_one_local_step_launches_b_then_c(monkeypatch):
    """One local step (S = batch, E = 1) calls the kernel wrapper twice:
    once with boundaries in the forward (Launch B) and once on the
    adjoint spec in the backward (Launch C); never plain Launch A. On the
    CPU both take the plain sweeps and count no launches."""
    calls = []
    real = scan_body.scan_body

    def spy(packed, spec, xs, with_boundaries=False, adjoint=False):
        calls.append((with_boundaries, adjoint, spec.tb))
        return real(packed, spec, xs, with_boundaries, adjoint)

    monkeypatch.setattr(scan_body, "scan_body", spy)
    model = make_vqc_classifier(N, L, 2, init_scale=1.0, device="cpu")
    cfg = FedConfig(local_epochs=1, batch_size=BATCH, learning_rate=0.1)
    local = pclient.make_local_update_clients(model, cfg)
    cx, cy, cm = (torch.as_tensor(a[:, :BATCH]) for a in _data())
    before = scan_body.launch_count
    delta, ns, loss = local(model.init(0), cx, cy, cm,
                            generator=torch.Generator().manual_seed(0))
    assert calls == [(True, False, C * BATCH), (True, True, C * BATCH)]
    assert scan_body.launch_count == before
    assert tuple(delta["ansatz"]["rx"].shape) == (C, L, N)
    assert torch.equal(ns, torch.full((C,), float(BATCH)))
    assert torch.isfinite(loss).all()


@pytest.mark.parametrize(
    "kwargs", [dict(optimizer="adam", learning_rate=0.05),
               dict(momentum=0.9, learning_rate=0.1),
               dict(momentum=0.0, learning_rate=0.1)],
    ids=["adam", "sgd-momentum", "sgd"],
)
def test_optimizer_matches_optax(kwargs):
    """The functional update rules ≡ optax.adam / optax.sgd over three
    steps of the same gradients (per-client (C, …) leaves)."""
    rng = np.random.default_rng(4)
    params = {"a": {"w": rng.normal(size=(C, 3)).astype(np.float32)}}
    grads = [{"a": {"w": rng.normal(size=(C, 3)).astype(np.float32)}}
             for _ in range(3)]
    cfg = FedConfig(**kwargs)
    tx = (optax.adam(cfg.learning_rate) if cfg.optimizer == "adam"
          else optax.sgd(cfg.learning_rate, momentum=cfg.momentum or None))
    want, state = jax.tree.map(jnp.asarray, params), None
    state = tx.init(want)
    opt = pclient.make_optimizer(cfg)
    got = {"a": {"w": torch.as_tensor(params["a"]["w"])}}
    pstate = opt.init(got)
    for g in grads:
        upd, state = tx.update(jax.tree.map(jnp.asarray, g), state, want)
        want = optax.apply_updates(want, upd)
        pupd, pstate = opt.update({"a": {"w": torch.as_tensor(g["a"]["w"])}},
                                  pstate)
        got = {"a": {"w": got["a"]["w"] + pupd["a"]["w"]}}
        np.testing.assert_allclose(got["a"]["w"].numpy(),
                                   np.asarray(want["a"]["w"]), atol=1e-6,
                                   rtol=0)


def test_min_participation_makes_the_round_the_identity():
    """Fewer surviving participants than min_participation × C: θ passes
    through unchanged and stats.applied is 0."""
    model = make_vqc_classifier(N, L, 2, init_scale=1.0, device="cpu")
    params = model.init(1)
    cfg = FedConfig(local_epochs=1, batch_size=BATCH, learning_rate=0.1,
                    min_participation=0.75)
    rf = make_fed_round(model, cfg, num_clients=C)
    cx, cy, cm = (torch.as_tensor(a) for a in _data())
    new, stats = rf(params, cx, cy, cm,
                    generator=torch.Generator().manual_seed(0),
                    survivors=np.array([1.0, 0.0], np.float32))
    assert float(stats.applied) == 0.0
    assert float(stats.num_participants) == 1.0
    for g in params:
        for k in params[g]:
            assert torch.equal(new[g][k], params[g][k])


def test_mesh_refuses_two_ranks_on_one_gpu():
    """The gathered slots of a mesh: two ranks naming one GPU of one host
    raise the mesh's own error; one process repeating its GPU, the same
    index on two hosts and CPU slots everywhere pass (a group across
    processes runs: tests/test_torch_sv_processes.py)."""
    from qfedx_tpu_torch.parallel.mesh import check_distinct_gpus

    check_distinct_gpus([("a", [("cuda", 0), ("cuda", 0)]),
                         ("a", [("cuda", 1)]), ("b", [("cuda", 0)]),
                         ("b", [("cpu", None)]), ("b", [("cpu", None)])])
    with pytest.raises(ValueError, match="ranks 0 and 2 both hold cuda:1"):
        check_distinct_gpus([("a", [("cuda", 1)]), ("a", [("cuda", 0)]),
                             ("a", [("cuda", 1)])])


def test_tree_helpers_match_reference():
    from qfedx_tpu.utils import trees as rtrees

    rng = np.random.default_rng(8)
    a = {"x": {"p": rng.normal(size=(2, 3)).astype(np.float32)},
         "y": {"q": rng.normal(size=(4,)).astype(np.float32),
               "b": rng.normal(size=(1,)).astype(np.float32)}}
    b = jax.tree.map(lambda v: v * 0.5 + 1.0, a)
    ta, tb = (jax.tree.map(torch.as_tensor, t) for t in (a, b))
    ja, jb = (jax.tree.map(jnp.asarray, t) for t in (a, b))
    assert [tuple(v.shape) for v in trees.tree_leaves(ta)] == [
        v.shape for v in jax.tree.leaves(a)]
    for got, want in (
        (trees.tree_add(ta, tb), rtrees.tree_add(ja, jb)),
        (trees.tree_sub(ta, tb), rtrees.tree_sub(ja, jb)),
        (trees.tree_scale(ta, 3.0), rtrees.tree_scale(ja, 3.0)),
    ):
        for g, w in zip(trees.tree_leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                       rtol=0)
    np.testing.assert_allclose(float(trees.global_norm_sq(ta)),
                               float(rtrees.global_norm_sq(ja)), rtol=1e-6)
    np.testing.assert_allclose(float(trees.global_norm(ta)),
                               float(rtrees.global_norm(ja)), rtol=1e-6)
