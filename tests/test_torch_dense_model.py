"""Port vs reference: the per-layer fusion pass, the dense ansatz and
model routes, and the runner at the reference CLI's defaults (n = 8).

- fusion pass: ``fuse_ops`` emits the reference's kinds, qubits and
  coefficients on the HEA layer trace (plus a diagonal tail) at n = 7,
  10 and 12, shared and per client, and ``apply_fused`` (dense) and
  ``apply_fused_b`` (batched) equal ``apply_ops_unfused`` within 2e-6
  (tests/test_fuse.py's bound);
- model: ``apply`` and ``apply_clients`` at n = 4 and 8 (the vmap route,
  distinct per-client angles) give the reference's logits and loss
  gradients within 2e-5; the dense route at n = 10 (QFEDX_BATCHED=0)
  equals the batched route within 1e-5; ``remat`` equals no remat;
  ``--layers 1`` and ``--scan-layers off`` at n = 10 match the
  reference with the TPU program shape forced (as tests/test_torch_run.py
  forces it);
- trainer: ``train_federated`` at n = 8, L = 2, 2 clients, 2 SGD rounds
  from the reference's init with its shuffles injected: loss and θ
  within 1e-5, accuracy equal;
- CLI: train at the defaults (no ``--qubits``) then serve; checkpoints
  of an 8-qubit run cross both ways.

Below n = 10 both packages take the "dot" gate form here (the reference's
XLA:CPU form; the port's "flip" default is held against it in
tests/test_torch_dense.py).
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qfedx_tpu.circuits import ansatz as ransatz
from qfedx_tpu.fed.config import FedConfig as RFedConfig
from qfedx_tpu.fed.round import TRAIN_KEY_SALT, client_mesh
from qfedx_tpu.models.vqc import make_vqc_classifier as ref_make
from qfedx_tpu.ops import fuse as rfuse
from qfedx_tpu.ops import gates as rgates
from qfedx_tpu.ops.cpx import CArray as RCArray
from qfedx_tpu.run import checkpoint as rckpt
from qfedx_tpu.run import metrics as rmetrics
from qfedx_tpu.run.trainer import train_federated as ref_train
from qfedx_tpu_torch.circuits import ansatz
from qfedx_tpu_torch.fed.client import _cross_entropy
from qfedx_tpu_torch.fed.config import FedConfig
from qfedx_tpu_torch.models.vqc import make_vqc_classifier, params_from_jax
from qfedx_tpu_torch.ops import fuse, gates
from qfedx_tpu_torch.ops.cpx import CArray
from qfedx_tpu_torch.run import checkpoint as pckpt
from qfedx_tpu_torch.run import cli as pcli
from qfedx_tpu_torch.run import config as pconfig
from qfedx_tpu_torch.run.trainer import train_federated
from qfedx_tpu_torch.serve.engine import ServeEngine
from qfedx_tpu_torch.utils import trees

FUSE_ATOL = 2e-6
ATOL = 2e-5
SGD_ATOL = 1e-5


def _tpu_form(mp, pallas="1"):
    """The reference's TPU program shape on the CPU (and the port's card
    routes): fused, scanned, batched, flip gates, matmul lanes."""
    for pin in ("QFEDX_FUSE", "QFEDX_SCAN_LAYERS", "QFEDX_BATCHED"):
        mp.setenv(pin, "1")
    mp.setenv("QFEDX_PALLAS", pallas)
    mp.setenv("QFEDX_GATE_FORM", "flip")
    mp.setenv("QFEDX_SLAB_LANES", "matmul")
    mp.setattr(rfuse, "_gather_ok", lambda: True)
    mp.setattr(rfuse, "_growmat_merge_ok", lambda: True)


@pytest.fixture
def tpu_form(monkeypatch):
    _tpu_form(monkeypatch)


@pytest.fixture
def dot_form(monkeypatch):
    monkeypatch.setenv("QFEDX_GATE_FORM", "dot")


# --- the fusion pass ---------------------------------------------------------


def _np(c):
    def f(t):
        if t is None:
            return 0.0
        if isinstance(t, torch.Tensor):
            return t.detach().numpy().astype(np.float64)
        return np.asarray(t, dtype=np.float64)

    return f(c.re) + 1j * f(c.im)


def _trace(n, clients, seed):
    """The HEA layer trace (shared (n,) or per-client (C, n) angles) with
    a diagonal tail, in both packages."""
    rng = np.random.default_rng(seed)
    shape = (n,) if clients is None else (clients, n)
    rx, rz = (rng.uniform(-2, 2, shape).astype(np.float32) for _ in range(2))
    d1, d2 = (float(a) for a in rng.uniform(-2, 2, 2))
    port = ansatz.hea_layer_ops(n, torch.as_tensor(rx), torch.as_tensor(rz))
    if clients is None:
        ref = ransatz.hea_layer_ops(n, jnp.asarray(rx), jnp.asarray(rz))
    else:
        ref = ransatz._hea_layer_ops_cb(n, jnp.asarray(rx), jnp.asarray(rz))
    port += [fuse.Op("diag1", (n - 3,), gates.rz_diag(d1)),
             fuse.Op("diag2", (0, n - 2), gates.cphase_diag(d2)),
             fuse.Op("diag2", (1, 2), gates.CZ_DIAG)]
    ref += [rfuse.Op("diag1", (n - 3,), rgates.rz_diag(d1)),
            rfuse.Op("diag2", (0, n - 2), rgates.cphase_diag(d2)),
            rfuse.Op("diag2", (1, 2), rgates.CZ_DIAG)]
    return port, ref


def _dense_state(rng, lead, n):
    shape = tuple(lead) + (2,) * n
    x = rng.normal(size=shape) + 1j * rng.normal(size=shape)
    x /= np.linalg.norm(x.reshape(tuple(lead) + (-1,)), axis=-1).reshape(
        tuple(lead) + (1,) * n)
    return CArray(torch.as_tensor(x.real, dtype=torch.float32),
                  torch.as_tensor(x.imag, dtype=torch.float32))


@pytest.mark.parametrize("clients", [None, 2], ids=["shared", "clients"])
@pytest.mark.parametrize("n", [7, 10, 12])
def test_fuse_ops_matches_reference(tpu_form, n, clients):
    port_ops, ref_ops = _trace(n, clients, seed=n)
    got = fuse.fuse_ops(port_ops, n)
    want = rfuse.fuse_ops(ref_ops, n)
    assert [(op.kind, op.qubits) for op in got] == [
        (op.kind, op.qubits) for op in want]
    for g, w in zip(got, want):
        if g.coeffs is not None:
            np.testing.assert_allclose(_np(g.coeffs), _np(w.coeffs),
                                       atol=1e-6, rtol=0)


@pytest.mark.parametrize("clients", [None, 2], ids=["shared", "clients"])
@pytest.mark.parametrize("n", [7, 10, 12])
def test_fused_programs_equal_unfused(tpu_form, n, clients):
    """``apply_fused`` on a dense (C, B, 2, …, 2) state and, at the slab
    widths, ``apply_fused_b`` on the (C·B, 2^n) slab equal the unfused
    gate-by-gate trace; there ``apply_scan`` runs a dense state as its
    slab."""
    port_ops, _ = _trace(n, clients, seed=n + 1)
    fused = fuse.fuse_ops(port_ops, n)
    lead = (2, 3) if clients else (3,)
    state = _dense_state(np.random.default_rng(n), lead, n)
    want = fuse.apply_ops_unfused(state, port_ops, n)
    got = fuse.apply_fused(state, fused, n)
    np.testing.assert_allclose(_np(got), _np(want), atol=FUSE_ATOL, rtol=0)
    if n >= 10:
        flat = CArray(state.re.reshape(-1, 1 << n),
                      state.im.reshape(-1, 1 << n))
        got_b = fuse.apply_fused_b(flat, n, fused)
        np.testing.assert_allclose(_np(got_b).reshape(_np(want).shape),
                                   _np(want), atol=FUSE_ATOL, rtol=0)
        rng = np.random.default_rng(n + 2)
        shape = (2, n) if clients is None else (clients, 2, n)
        prog = ansatz._scan_program(n, {
            k: torch.as_tensor(rng.uniform(-2, 2, shape).astype(np.float32))
            for k in ("rx", "rz")})
        dense = fuse.apply_scan(state, n, prog)
        assert tuple(dense.re.shape) == tuple(state.re.shape)
        np.testing.assert_array_equal(
            _np(dense).reshape(-1, 1 << n),
            _np(fuse.apply_scan(flat, n, prog, batched=True)))


def test_fuse_never_reorders_overlapping_ops(tpu_form):
    """tests/test_fuse.py's trace that trips every flush path: fused ≡
    gate by gate, and the reference's kinds and qubits."""
    n = 10
    rng = np.random.default_rng(7)
    a = [float(v) for v in rng.uniform(-2, 2, 9)]

    def trace(f, g):
        return [
            f.Op("g1", (0,), g.rot_zx(a[0], a[1])),
            f.Op("diag1", (0,), g.rz_diag(a[2])),
            f.Op("g1", (0,), g.ry(a[3])),
            f.Op("g1", (0,), g.ry(a[4])),
            f.Op("g1", (n - 1,), g.rot_zx(a[5], a[6])),
            f.Op("diag1", (n - 1,), g.rz_diag(a[7])),
            f.Op("cnot", (n - 2, n - 1)),
            f.Op("cnot", (2, n - 1)),
            f.Op("diag2", (0, 2), g.cphase_diag(a[8])),
            f.Op("cnot", (0, 1)),
            f.Op("g2", (1, 2), g.CZ),
        ]

    ops = trace(fuse, gates)
    fused = fuse.fuse_ops(ops, n)
    assert [(o.kind, o.qubits) for o in fused] == [
        (o.kind, o.qubits) for o in rfuse.fuse_ops(trace(rfuse, rgates), n)]
    state = _dense_state(rng, (), n)
    np.testing.assert_allclose(
        _np(fuse.apply_fused(state, fused)),
        _np(fuse.apply_ops_unfused(state, ops)), atol=FUSE_ATOL, rtol=0)


# --- the model ---------------------------------------------------------------


def _ref_params(model, seed, scale=10.0):
    p = model.init(jax.random.PRNGKey(seed))
    return jax.tree.map(lambda v: np.asarray(v) * scale, p)


def _ref_client_params(p, clients, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda v: (v[None] + 0.3 * rng.normal(size=(clients,) + v.shape)
                   ).astype(np.float32), p)


def _grads_port(model, params, x, y, clients: bool):
    p = params_from_jax(params, device="cpu")
    leaves = [p[g][k].requires_grad_(True) for g in sorted(p)
              for k in sorted(p[g])]
    fn = model.apply_clients if clients else model.apply
    logits = fn(p, x)
    ce = _cross_entropy(logits, torch.as_tensor(y))
    loss = ce.mean(-1).sum() if clients else ce.mean()
    return logits.detach().numpy(), [g.numpy() for g in torch.autograd.grad(
        loss, leaves)]


def _grads_ref(model, params, x, y, clients: bool):
    def loss_fn(p):
        fn = jax.vmap(model.apply) if clients else model.apply
        logits = fn(p, x)
        ce = -jnp.take_along_axis(jax.nn.log_softmax(logits), y[..., None],
                                  axis=-1)[..., 0]
        return (ce.mean(-1).sum() if clients else ce.mean()), logits

    (_, logits), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    return np.asarray(logits), [np.asarray(v) for v in jax.tree.leaves(grads)]


@pytest.mark.parametrize("n", [4, 8])
def test_dense_model_matches_reference(dot_form, n):
    """``apply`` and ``apply_clients`` (3 clients, distinct angles and
    readouts) below the slab widths: logits and loss gradients within
    2e-5 of the reference's vmap route."""
    layers, k, clients = 2, 3, 3
    ref = ref_make(n, layers, k)
    model = make_vqc_classifier(n, layers, k, device="cpu")
    assert model.engine() == "vmap" and model.name == ref.name
    params = _ref_params(ref, seed=n)
    rng = np.random.default_rng(n)
    x = rng.uniform(0, 1, (5, n)).astype(np.float32)
    y = rng.integers(0, k, 5)
    for got, want in zip(_grads_port(model, params, x, y, False),
                         _grads_ref(ref, params, x, jnp.asarray(y), False)):
        for g, w in zip(got if isinstance(got, list) else [got],
                        want if isinstance(want, list) else [want]):
            np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)
    cparams = _ref_client_params(params, clients, seed=n + 1)
    xc = rng.uniform(0, 1, (clients, 4, n)).astype(np.float32)
    yc = rng.integers(0, k, (clients, 4))
    got = _grads_port(model, cparams, xc, yc, True)
    want = _grads_ref(ref, cparams, xc, jnp.asarray(yc), True)
    assert got[0].shape == (clients, 4, k)
    np.testing.assert_allclose(got[0], want[0], atol=ATOL, rtol=0)
    for g, w in zip(got[1], want[1]):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)


def _port_grads(model, params, x, y):
    return _grads_port(model, params, x, y, x.ndim == 3)


@pytest.mark.parametrize("clients", [False, True], ids=["apply",
                                                        "apply_clients"])
def test_dense_route_equals_batched_at_n10(monkeypatch, clients):
    """QFEDX_BATCHED=0 at n = 10: the dense state runs as its slab, so
    logits and gradients equal the batched route's within 1e-5."""
    monkeypatch.delenv("QFEDX_BATCHED", raising=False)
    n, layers = 10, 3
    model = make_vqc_classifier(n, layers, 2, device="cpu")
    params = jax.tree.map(
        lambda v: v.numpy() * 10.0, model.init(3))
    rng = np.random.default_rng(3)
    if clients:
        params = _ref_client_params(params, 2, seed=4)
        x = rng.uniform(0, 1, (2, 4, n)).astype(np.float32)
        y = rng.integers(0, 2, (2, 4))
    else:
        x = rng.uniform(0, 1, (4, n)).astype(np.float32)
        y = rng.integers(0, 2, 4)
    assert model.engine() == "batched"
    want = _port_grads(model, params, x, y)
    monkeypatch.setenv("QFEDX_BATCHED", "0")
    assert model.engine() == "vmap"
    got = _port_grads(model, params, x, y)
    for g, w in zip([got[0]] + got[1], [want[0]] + want[1]):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)


@pytest.mark.parametrize("n", [8, 10])
def test_remat_equals_no_remat(monkeypatch, n):
    """``remat`` checkpoints each layer on the per-layer route: the same
    logits and gradients as that route without checkpoints."""
    monkeypatch.setenv("QFEDX_SCAN_LAYERS", "0")
    monkeypatch.setenv("QFEDX_BATCHED", "0")
    plain = make_vqc_classifier(n, 2, 2, device="cpu")
    remat = make_vqc_classifier(n, 2, 2, remat=True, device="cpu")
    assert remat.engine() == "vmap"
    params = jax.tree.map(lambda v: v.numpy() * 10.0, plain.init(n))
    rng = np.random.default_rng(n)
    params = _ref_client_params(params, 2, seed=n)
    x = rng.uniform(0, 1, (2, 4, n)).astype(np.float32)
    y = rng.integers(0, 2, (2, 4))
    want = _port_grads(plain, params, x, y)
    got = _port_grads(remat, params, x, y)
    for g, w in zip([got[0]] + got[1], [want[0]] + want[1]):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("route", ["layers1", "scan-off"])
def test_per_layer_route_matches_reference_at_n10(monkeypatch, route):
    """``--layers 1`` and ``--scan-layers off`` at n = 10 run the
    per-layer ``fuse_ops`` route on the batched and folded engines:
    logits and gradients of ``apply`` and ``apply_clients`` within 2e-5
    of the reference's (TPU program shape forced)."""
    _tpu_form(monkeypatch)
    n, layers = 10, 1 if route == "layers1" else 2
    if route == "scan-off":
        monkeypatch.setenv("QFEDX_SCAN_LAYERS", "0")
    ref = ref_make(n, layers, 2)
    model = make_vqc_classifier(n, layers, 2, device="cpu")
    params = _ref_params(ref, seed=layers)
    rng = np.random.default_rng(layers)
    x = rng.uniform(0, 1, (4, n)).astype(np.float32)
    y = rng.integers(0, 2, 4)
    cparams = _ref_client_params(params, 2, seed=5)
    xc = rng.uniform(0, 1, (2, 4, n)).astype(np.float32)
    yc = rng.integers(0, 2, (2, 4))
    for p, xx, yy, cl in ((params, x, y, False), (cparams, xc, yc, True)):
        got = _grads_port(model, p, xx, yy, cl)

        def loss_fn(q, cl=cl, xx=xx, yy=yy):
            logits = (ref.apply_clients if cl else ref.apply)(q, xx)
            ce = -jnp.take_along_axis(jax.nn.log_softmax(logits),
                                      jnp.asarray(yy)[..., None],
                                      axis=-1)[..., 0]
            return (ce.mean(-1).sum() if cl else ce.mean()), logits

        (_, logits), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(p)
        np.testing.assert_allclose(got[0], np.asarray(logits), atol=ATOL,
                                   rtol=0)
        for g, w in zip(got[1], jax.tree.leaves(grads)):
            np.testing.assert_allclose(g, np.asarray(w), atol=ATOL, rtol=0)


def test_build_model_runs_every_width_and_remat():
    for n, remat, engine in ((8, False, "vmap"), (4, True, "vmap"),
                             (12, True, "vmap"), (12, False, "batched")):
        cfg = pconfig.ExperimentConfig(model=pconfig.ModelConfig(
            n_qubits=n, remat=remat))
        model = pconfig.build_model(cfg, 2, device="cpu")
        assert model.engine() == engine, (n, remat)


def test_serve_warmup_reports_the_engine():
    for n, engine in ((8, "vmap"), (10, "batched")):
        model = make_vqc_classifier(n, 2, 2, device="cpu")
        warm = ServeEngine(model, model.init(0), (n,),
                           device="cpu").warmup()
        assert warm["route_resolved"]["engine"] == engine
        assert warm["kernel_builds"] == 0


# --- trainer, CLI and checkpoints at n = 8 -------------------------------------

N8, L8, C8, S8, B8 = 8, 2, 2, 8, 4
_CFG = dict(local_epochs=1, batch_size=B8, learning_rate=0.1,
            momentum=0.9, optimizer="sgd")
SEED = 5


def _fed_data(seed=0):
    rng = np.random.default_rng(seed)
    cx = rng.uniform(0, 1, (C8, S8, N8)).astype(np.float32)
    cy = rng.integers(0, 2, (C8, S8)).astype(np.int32)
    cm = np.ones((C8, S8), np.float32)
    tx = rng.uniform(0, 1, (20, N8)).astype(np.float32)
    ty = rng.integers(0, 2, 20).astype(np.int32)
    return cx, cy, cm, tx, ty


def _ref_perms(round_key):
    train_key = jax.random.fold_in(round_key, TRAIN_KEY_SALT)
    out = []
    for cid in range(C8):
        ekey = jax.random.split(jax.random.fold_in(train_key, cid), 1)[0]
        out.append([np.asarray(jax.random.permutation(
            jax.random.split(ekey)[0], S8))])
    return torch.as_tensor(np.asarray(out), dtype=torch.int64)


def test_trainer_matches_reference_at_n8(monkeypatch):
    """2 SGD-momentum rounds at n = 8, L = 2, 2 clients from the
    reference's init with its shuffles injected: per-round loss and final
    θ within 1e-5, accuracy equal; two rounds per call give the same
    rows."""
    monkeypatch.setenv("QFEDX_GATE_FORM", "dot")
    rmodel = ref_make(N8, L8, 2)
    rows = []
    res = ref_train(rmodel, RFedConfig(**_CFG), *_fed_data(), num_rounds=2,
                    seed=SEED, mesh=client_mesh(num_devices=1),
                    rounds_per_call=1,
                    on_round_end=lambda r, m: rows.append(dict(m)))
    init_key, base = jax.random.split(jax.random.PRNGKey(SEED))
    init = jax.tree.map(np.asarray, rmodel.init(init_key))
    perms = [_ref_perms(jax.random.fold_in(base, r)) for r in range(2)]
    def port(rounds_per_call):
        out = []
        res = train_federated(
            make_vqc_classifier(N8, L8, 2, device="cpu"), FedConfig(**_CFG),
            *_fed_data(), num_rounds=2, seed=SEED,
            rounds_per_call=rounds_per_call,
            on_round_end=lambda r, m: out.append(dict(m)),
            params=params_from_jax(init, device="cpu"),
            perms_for_round=lambda r: perms[r])
        return res, out

    got, got_rows = port(1)
    # The in-chunk evaluation (two rounds per call) gives the same rows.
    _, chunked = port(2)
    for a, b in zip(got_rows, chunked):
        assert b["chunk_rounds"] == 2 and a["loss"] == b["loss"]
        assert abs(a["accuracy"] - b["accuracy"]) <= 1e-6
    assert [r["round"] for r in got_rows] == [r["round"] for r in rows]
    for g, w in zip(got_rows, rows):
        assert abs(g["loss"] - w["loss"]) <= SGD_ATOL
        assert g["accuracy"] == w["accuracy"] and g["n"] == w["n"]
    assert got.accuracies == res.accuracies
    for a, b in zip(trees.tree_leaves(got.params),
                    jax.tree.leaves(jax.tree.map(np.asarray, res.params))):
        np.testing.assert_allclose(a.numpy(), b, atol=SGD_ATOL, rtol=0)


@pytest.fixture()
def small_data(monkeypatch):
    monkeypatch.setattr(pcli, "DataConfig", functools.partial(
        pconfig.DataConfig, synthetic_train=256, synthetic_test=128))


def test_cli_train_then_serve_at_the_defaults(tmp_path, small_data):
    """``train`` with no ``--qubits`` (n = 8, L = 2, classes 0,1,2), then
    ``serve --run-dir``: schema-valid rows, the reference reads the run's
    config, ordered responses with a 400, logits of the restored
    checkpoint within 2e-5."""
    summary = pcli.main(["train", "--model", "vqc", "--clients", "2",
                         "--rounds", "2", "--local-epochs", "1",
                         "--checkpoint-every", "1", "--run-root",
                         str(tmp_path), "--name", "d8"], device="cpu")
    run = tmp_path / "d8"
    rows = [json.loads(line) for line in
            (run / "metrics.jsonl").read_text().splitlines()]
    assert [r["round"] for r in rows] == [1, 2]
    for r in rows:
        rmetrics.validate_metrics_record(r)
    assert summary["rounds"] == 2
    cfg = json.loads((run / "config.json").read_text())
    assert cfg["model"]["n_qubits"] == 8 and cfg["model"]["n_layers"] == 2
    x = np.random.default_rng(0).uniform(0, 1, (5, 8)).astype(np.float32)
    lines = [json.dumps({"id": f"q{i}", "features": v.tolist()})
             for i, v in enumerate(x)]
    lines.insert(1, "{bad")
    (tmp_path / "in.jsonl").write_text("\n".join(lines) + "\n")
    out = tmp_path / "out.jsonl"
    pcli.main(["serve", "--run-dir", str(run), "--input",
               str(tmp_path / "in.jsonl"), "--output", str(out)],
              device="cpu")
    resp = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["id"] for r in resp] == ["q0", 1, "q1", "q2", "q3", "q4"]
    assert [r.get("code") for r in resp] == [None, 400] + [None] * 4
    model = make_vqc_classifier(8, 2, 3, device="cpu")
    params, r = pckpt.Checkpointer(run / "checkpoints").restore_latest(
        model.init(0))
    assert r == 2
    with torch.no_grad():
        want = model.apply(params, x).numpy()
    got = np.array([q["logits"] for q in resp if "logits" in q])
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_checkpoints_cross_both_ways_at_n8(tmp_path, dot_form):
    """An 8-qubit reference checkpoint restores in the port and the
    port's in the reference, leaf for leaf, and both packages' forwards
    of the restored weights agree within 2e-5."""
    rmodel = ref_make(8, 2, 3)
    model = make_vqc_classifier(8, 2, 3, device="cpu")
    rparams = jax.tree.map(jnp.asarray, _ref_params(rmodel, 1, 1.0))
    rckpt.Checkpointer(tmp_path / "r", every=1).save(3, rparams)
    got, r = pckpt.Checkpointer(tmp_path / "r").restore_latest(model.init(0))
    assert r == 3
    for a, b in zip(trees.tree_leaves(got), jax.tree.leaves(rparams)):
        assert a.numpy().tobytes() == np.asarray(b).tobytes()
    pparams = model.init(7)
    pckpt.Checkpointer(tmp_path / "p", every=1).save(2, pparams)
    back = rckpt.Checkpointer(tmp_path / "p", every=1).restore(2, rparams)
    for a, b in zip(jax.tree.leaves(back), trees.tree_leaves(pparams)):
        assert np.asarray(a).tobytes() == b.numpy().tobytes()
    x = np.random.default_rng(2).uniform(0, 1, (4, 8)).astype(np.float32)
    with torch.no_grad():
        port_logits = model.apply(pparams, x).numpy()
    np.testing.assert_allclose(port_logits, np.asarray(rmodel.apply(back, x)),
                               atol=ATOL, rtol=0)
