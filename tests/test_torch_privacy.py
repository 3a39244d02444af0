"""Port vs reference: differential privacy and SPSA (fed/accountant.py,
fed/privacy.py, the per-example DP and SPSA routes of fed/client.py, the
DP branches of fed/round.py and the trainer's accountant).

- the RDP accountant: ε and the RDP vector equal the reference's bit
  for bit over a grid of q, σ, steps and δ; a bad δ raises in both;
- ``clip_by_global_norm`` and ``privatize`` with the reference's noise
  injected, within 1e-6;
- per-example DP gradients against the reference's
  ``_make_dp_example_grad`` with its noise injected, within 2e-5, at
  n = 4 (the dense engine) and n = 10 (the slab, the kernel's plain
  version on the CPU), folded and one client at a time;
- SPSA's estimate with the reference's Rademacher Δ injected: loss and
  gradients within 2e-5;
- client-mode DP, example-mode DP and SPSA rounds against the
  reference's ``make_fed_round`` with every draw injected (shuffles,
  noise, Δ), within 1e-5;
- the trainer: rows with ``epsilon`` equal to the reference trainer's
  (and example mode's ``epsilon_accounting``), loss and θ within 1e-5; a
  resumed run charges the rounds its checkpoint covers.

The reference runs its ``lax.scan`` route (QFEDX_PALLAS=0, exact against
its interpreted kernel) and, below n = 10, its "dot" gate form (its
XLA:CPU form); the port runs its card routes. The reference's random
draws are recomputed with jax (``tests/_torch_ref_streams.py``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import _torch_ref_streams as streams
from qfedx_tpu.fed import accountant as racc
from qfedx_tpu.fed import client as rclient
from qfedx_tpu.fed import privacy as rprivacy
from qfedx_tpu.fed.config import DPConfig as RDPConfig
from qfedx_tpu.fed.config import FedConfig as RFedConfig
from qfedx_tpu.fed.round import (
    client_mesh,
    make_fed_round as ref_make_round,
    shard_client_data,
)
from qfedx_tpu.models.vqc import make_vqc_classifier as ref_make
from qfedx_tpu.ops import fuse as rfuse
from qfedx_tpu.run.trainer import train_federated as ref_train
from qfedx_tpu.utils import trees as rtrees
from qfedx_tpu_torch.fed import accountant as pacc
from qfedx_tpu_torch.fed import client as pclient
from qfedx_tpu_torch.fed import privacy as pprivacy
from qfedx_tpu_torch.fed.config import DPConfig, FedConfig
from qfedx_tpu_torch.fed.round import RoundDraws, make_fed_round
from qfedx_tpu_torch.models.vqc import make_vqc_classifier, params_from_jax
from qfedx_tpu_torch.run import checkpoint as pckpt
from qfedx_tpu_torch.run.trainer import train_federated
from qfedx_tpu_torch.utils import trees

PRIV_ATOL = 1e-6
GRAD_ATOL = 2e-5
ROUND_ATOL = 1e-5
N, L, C, S, BATCH = 10, 2, 2, 8, 4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several workers on one CPU."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _tpu_form(mp, n=N):
    for pin in ("QFEDX_FUSE", "QFEDX_SCAN_LAYERS", "QFEDX_BATCHED",
                "QFEDX_PALLAS"):
        mp.setenv(pin, "1")
    mp.setenv("QFEDX_GATE_FORM", "dot" if n < 10 else "flip")
    mp.setenv("QFEDX_SLAB_LANES", "matmul")
    mp.setattr(rfuse, "_gather_ok", lambda: True)
    mp.setattr(rfuse, "_growmat_merge_ok", lambda: True)


@pytest.fixture(autouse=True)
def tpu_form(monkeypatch):
    _tpu_form(monkeypatch)


def _close(got, want, atol, what=""):
    for g, w in zip(trees.tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(
            g.detach().numpy() if isinstance(g, torch.Tensor) else g,
            np.asarray(w), atol=atol, rtol=0, err_msg=what)


def _torch_tree(tree):
    return jax.tree.map(lambda a: torch.as_tensor(np.array(a)), tree)


# --- the accountant ------------------------------------------------------------


@pytest.mark.parametrize("q", [1.0, 0.5, 0.1, 0.01, 0.0])
@pytest.mark.parametrize("sigma", [0.5, 1.4, 0.0])
def test_accountant_matches_reference_bit_for_bit(q, sigma):
    assert np.array_equal(pacc.DEFAULT_ORDERS, racc.DEFAULT_ORDERS)
    orders = np.array([2, 3, 7, 32, 128])
    got = pacc.rdp_subsampled_gaussian(q, sigma, orders)
    want = racc.rdp_subsampled_gaussian(q, sigma, orders)
    assert np.array_equal(got, want, equal_nan=True)
    mine, theirs = pacc.RDPAccountant(), racc.RDPAccountant()
    for steps in (1, 7, 300):
        mine.step(q, sigma, steps)
        theirs.step(q, sigma, steps)
        assert np.array_equal(mine.rdp, theirs.rdp, equal_nan=True)
        for delta in (1e-5, 1e-3, 0.5):
            a, b = mine.epsilon(delta), theirs.epsilon(delta)
            assert a == b or (np.isnan(a) and np.isnan(b)), (steps, delta)


@pytest.mark.parametrize("delta", [0.0, 1.0, -1e-3, 1.5])
def test_accountant_bad_delta_raises(delta):
    for mod in (pacc, racc):
        acc = mod.RDPAccountant()
        acc.step(0.5, 1.0)
        with pytest.raises(ValueError, match="delta"):
            acc.epsilon(delta)


# --- clip and noise ------------------------------------------------------------


def _delta_tree(scale, seed=0):
    rng = np.random.default_rng(seed)
    return {"ansatz": {"rx": rng.normal(size=(L, N)).astype(np.float32)
                       * scale,
                       "rz": rng.normal(size=(L, N)).astype(np.float32)
                       * scale},
            "readout": {"bias": rng.normal(size=(2,)).astype(np.float32),
                        "scale": rng.normal(size=(2,)).astype(np.float32)}}


@pytest.mark.parametrize("scale", [0.01, 3.0], ids=["under", "over"])
def test_privatize_matches_reference(scale):
    """One client's tree (lead 0) and a stack of three (lead 1, each
    clipped by its own norm), with the reference's noise injected."""
    dp = DPConfig(clip_norm=1.0, noise_multiplier=1.3)
    rdp = RDPConfig(clip_norm=1.0, noise_multiplier=1.3)
    deltas = [_delta_tree(scale * (1 + c), seed=c) for c in range(3)]
    keys = [jax.random.PRNGKey(10 + c) for c in range(3)]
    want_clip = [rprivacy.clip_by_global_norm(jax.tree.map(jnp.asarray, d),
                                              1.0) for d in deltas]
    want = [rprivacy.privatize(jax.tree.map(jnp.asarray, d), rdp, k)
            for d, k in zip(deltas, keys)]
    noise = [jax.tree.map(np.asarray, rtrees.tree_random_normal(k, d))
             for d, k in zip(deltas, keys)]
    for d, n_, wc, w in zip(deltas, noise, want_clip, want):
        _close(pprivacy.clip_by_global_norm(_torch_tree(d), 1.0), wc,
               PRIV_ATOL)
        _close(pprivacy.privatize(_torch_tree(d), dp, _torch_tree(n_)), w,
               PRIV_ATOL)
    stack = lambda ts: _torch_tree(jax.tree.map(  # noqa: E731
        lambda *a: np.stack(a), *ts))
    got = pprivacy.privatize(stack(deltas), dp, stack(noise), lead=1)
    for c in range(3):
        _close(trees.tree_map(lambda v: v[c], got), want[c], PRIV_ATOL)


# --- per-example DP and SPSA gradients ------------------------------------------


def _client_batch(n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (C, BATCH, n)).astype(np.float32)
    y = rng.integers(0, 2, (C, BATCH)).astype(np.int32)
    m = np.ones((C, BATCH), np.float32)
    m[1, -1] = 0.0  # a padded example contributes nothing
    return x, y, m


def _client_params(rmodel, n):
    """Per-client parameters (client 1 shifted) and the global ones."""
    p = rmodel.init(jax.random.PRNGKey(0))
    g = jax.tree.map(lambda v: np.asarray(v) * 8.0, p)
    shift = _delta_tree(0.05)
    if n != N:
        shift = jax.tree.map(lambda v: v[..., :n] if v.ndim == 2 else v,
                             shift)
    per = [g, jax.tree.map(lambda a, b: a + b, g, shift)]
    return per, g


def _fold(per):
    return _torch_tree(jax.tree.map(lambda *a: np.stack(a), *per))


_DP_EX = dict(clip_norm=0.5, noise_multiplier=1.1, mode="example")
_DP_EX_KW = dict(batch_size=BATCH, algorithm="fedprox", prox_mu=0.3)


@functools.lru_cache(maxsize=None)
def _ref_dp_example(n):
    """The reference's per-client (loss, g̃) at width n, run once for
    both routes, with the pins its CPU form needs."""
    mp = pytest.MonkeyPatch()
    try:
        _tpu_form(mp, n)
        mp.setenv("QFEDX_PALLAS", "0")
        rmodel = ref_make(n, L, 2)
        per, g = _client_params(rmodel, n)
        x, y, m = _client_batch(n)
        keys = [jax.random.PRNGKey(40 + c) for c in range(C)]
        rgrad = jax.jit(rclient._make_dp_example_grad(
            rmodel, RFedConfig(dp=RDPConfig(**_DP_EX), **_DP_EX_KW)))
        want = [jax.tree.map(np.asarray, rgrad(
            jax.tree.map(jnp.asarray, per[c]), g, x[c], y[c], m[c],
            keys[c])) for c in range(C)]
        noise = [streams.example_noise(k, g) for k in keys]
        return per, g, (x, y, m), noise, want
    finally:
        mp.undo()


@pytest.mark.parametrize("route", ["folded", "client"])
@pytest.mark.parametrize("n", [4, 10])
def test_dp_example_grad_matches_reference(monkeypatch, n, route):
    """Per-example clip, sum, one noise draw, ÷ B and the FedProx term:
    the loss and g̃ of each client within 2e-5 of the reference's."""
    _tpu_form(monkeypatch, n)
    cfg = FedConfig(dp=DPConfig(**_DP_EX), **_DP_EX_KW)
    per, g, (x, y, m), noise, want = _ref_dp_example(n)
    model = make_vqc_classifier(n, L, 2, device="cpu")
    gt = _torch_tree(g)
    grad = pclient._make_dp_example_grad(model, cfg, route == "folded")
    if route == "folded":
        loss, got = grad(_fold(per), gt, torch.as_tensor(x),
                         torch.as_tensor(y), torch.as_tensor(m),
                         _fold(noise))
        got = [(loss[c], trees.tree_map(lambda v: v[c], got))
               for c in range(C)]
    else:
        got = [grad(_torch_tree(per[c]), gt, torch.as_tensor(x[c]),
                    torch.as_tensor(y[c]), torch.as_tensor(m[c]),
                    _torch_tree(noise[c])) for c in range(C)]
    for (gl, gg), (wl, wg) in zip(got, want):
        assert abs(float(gl) - float(wl)) <= GRAD_ATOL
        _close(gg, wg, GRAD_ATOL)


def _ref_loss(rmodel, mu):
    def loss_fn(params, gp, xb, yb, mb, key):
        ce = optax.softmax_cross_entropy_with_integer_labels(
            rmodel.apply(params, xb), yb)
        loss = jnp.sum(ce * mb) / jnp.maximum(jnp.sum(mb), 1.0)
        return loss + 0.5 * mu * rtrees.global_norm_sq(
            rtrees.tree_sub(params, gp))
    return loss_fn


def _port_loss(model, mu, folded):
    def loss_fn(params, gp, xb, yb, mb):
        fwd = model.apply_clients if folded else model.apply
        ce = pclient._cross_entropy(fwd(params, xb), yb)
        loss = torch.sum(ce * mb, dim=-1) / torch.clamp(
            torch.sum(mb, dim=-1), min=1.0)
        prox = sum(torch.sum(torch.square(p - q),
                             dim=tuple(range(int(folded), p.ndim)))
                   for p, q in zip(trees.tree_leaves(params),
                                   trees.tree_leaves(gp)))
        return loss + 0.5 * mu * prox
    return loss_fn


@pytest.mark.parametrize("route", ["folded", "client"])
def test_spsa_grad_matches_reference(monkeypatch, route):
    """(L₊+L₋)/2 and (L₊−L₋)/(2c)·Δ with the reference's Δ."""
    mu, c_spsa = 0.2, 0.1
    rmodel = ref_make(N, L, 2)
    per, g = _client_params(rmodel, N)
    x, y, m = _client_batch(N, seed=3)
    keys = [jax.random.PRNGKey(60 + c) for c in range(C)]
    monkeypatch.setenv("QFEDX_PALLAS", "0")
    rgrad = rclient.make_spsa_grad(_ref_loss(rmodel, mu), c_spsa)
    want = [jax.jit(rgrad)(jax.tree.map(jnp.asarray, per[c]), g, x[c], y[c],
                           m[c], keys[c]) for c in range(C)]
    monkeypatch.setenv("QFEDX_PALLAS", "1")
    deltas = [streams.spsa_delta(k, g) for k in keys]
    model = make_vqc_classifier(N, L, 2, device="cpu")
    folded = route == "folded"
    grad = pclient.make_spsa_grad(_port_loss(model, mu, folded), c_spsa,
                                  folded)
    gt = _torch_tree(g)
    if folded:
        loss, got = grad(_fold(per), gt, torch.as_tensor(x),
                         torch.as_tensor(y), torch.as_tensor(m),
                         _fold(deltas))
        got = [(loss[c], trees.tree_map(lambda v: v[c], got))
               for c in range(C)]
    else:
        got = [grad(_torch_tree(per[c]), gt, torch.as_tensor(x[c]),
                    torch.as_tensor(y[c]), torch.as_tensor(m[c]),
                    _torch_tree(deltas[c])) for c in range(C)]
    for (gl, gg), (wl, wg) in zip(got, want):
        assert abs(float(gl) - float(wl)) <= GRAD_ATOL
        _close(gg, wg, GRAD_ATOL)


# --- rounds ---------------------------------------------------------------------


def _data(seed=0):
    rng = np.random.default_rng(seed)
    cx = rng.uniform(0, 1, (C, S, N)).astype(np.float32)
    cy = rng.integers(0, 2, (C, S)).astype(np.int32)
    cm = np.ones((C, S), np.float32)
    cm[1, -2:] = 0.0
    return cx, cy, cm


_ROUND_CFGS = {
    "dp-client": dict(learning_rate=0.1, momentum=0.9,
                      dp=("client", 0.5, 1.2)),
    "dp-example": dict(learning_rate=0.1, momentum=0.9,
                       dp=("example", 1.0, 1.4)),
    "spsa": dict(optimizer="spsa", learning_rate=0.1, momentum=0.9),
}


def _cfgs(kind, epochs=1):
    kw = dict(_ROUND_CFGS[kind], local_epochs=epochs, batch_size=BATCH)
    dp = kw.pop("dp", None)
    if dp is None:
        return RFedConfig(**kw), FedConfig(**kw)
    mode, clip, sigma = dp
    return (RFedConfig(dp=RDPConfig(clip_norm=clip, noise_multiplier=sigma,
                                    mode=mode), **kw),
            FedConfig(dp=DPConfig(clip_norm=clip, noise_multiplier=sigma,
                                  mode=mode), **kw))


def _check_round(got, want, atol=ROUND_ATOL, exact=("num_participants",
                                                    "applied")):
    (gp, gs), (wp, ws) = got, want
    _close(gp, wp, atol, "theta")
    assert abs(float(gs.mean_loss) - float(ws.mean_loss)) <= atol
    assert abs(float(gs.total_weight) - float(ws.total_weight)) <= 1e-6
    for field in exact:
        assert float(getattr(gs, field)) == float(getattr(ws, field)), field


@pytest.mark.parametrize("kind", sorted(_ROUND_CFGS))
def test_round_matches_reference(monkeypatch, kind):
    """Two rounds from the reference's θ with every draw injected:
    θ, mean_loss and the counts within 1e-5 (the reference runs SPSA and
    per-example DP on its vmap path, the port folded)."""
    rcfg, cfg = _cfgs(kind)
    data = _data()
    rmodel = ref_make(N, L, 2)
    params = jax.tree.map(lambda v: np.asarray(v) * 8.0,
                          rmodel.init(jax.random.PRNGKey(0)))
    mesh = client_mesh(num_devices=1)
    monkeypatch.setenv("QFEDX_PALLAS", "0")
    rf = ref_make_round(rmodel, rcfg, mesh, num_clients=C)
    rdata = shard_client_data(mesh, *(jnp.asarray(a) for a in data))
    want, rp, keys = [], params, []
    for r in range(2):
        key = jax.random.PRNGKey(200 + r)
        rp, st = rf(rp, *rdata, key)
        want.append((jax.tree.map(np.asarray, rp), st))
        keys.append(key)
    monkeypatch.setenv("QFEDX_PALLAS", "1")
    model = make_vqc_classifier(N, L, 2, device="cpu")
    prf = make_fed_round(model, cfg, num_clients=C)
    pp = params_from_jax(params, device="cpu")
    tdata = [torch.as_tensor(a) for a in data]
    for r, key in enumerate(keys):
        given = streams.round_streams(key, params, rcfg, C, S)
        pp, st = prf(pp, *tdata, perms=streams.perms(key, C, 1, S),
                     draws=RoundDraws(0, r, given))
        _check_round((pp, st), want[r])


# --- the trainer ------------------------------------------------------------------

SEED = 5


def _fed_data():
    cx, cy, cm = _data(1)
    rng = np.random.default_rng(2)
    return (cx, cy, cm, rng.uniform(0, 1, (20, N)).astype(np.float32),
            rng.integers(0, 2, 20).astype(np.int32))


@pytest.mark.parametrize("kind", ["dp-client", "dp-example"])
def test_trainer_epsilon_rows_match_reference(monkeypatch, kind):
    """Two rounds of each DP mode through both trainers (the port's from
    the reference's init, shuffles and noise): ``epsilon`` equal in every
    row, example mode's ``epsilon_accounting`` on the first, loss and θ
    within 1e-5, ``final`` ε in ``TrainResult.epsilons``."""
    rcfg, cfg = _cfgs(kind)
    monkeypatch.setenv("QFEDX_PALLAS", "0")
    rmodel = ref_make(N, L, 2)
    rows = []
    res = ref_train(rmodel, rcfg, *_fed_data(), num_rounds=2, seed=SEED,
                    mesh=client_mesh(num_devices=1), rounds_per_call=1,
                    on_round_end=lambda r, m: rows.append(dict(m)))
    init_key, base = jax.random.split(jax.random.PRNGKey(SEED))
    init = jax.tree.map(np.asarray, rmodel.init(init_key))
    keys = [jax.random.fold_in(base, r) for r in range(2)]
    given = [streams.round_streams(k, init, rcfg, C, S) for k in keys]
    perms = [streams.perms(k, C, 1, S) for k in keys]
    monkeypatch.setenv("QFEDX_PALLAS", "1")
    got_rows = []
    got = train_federated(
        make_vqc_classifier(N, L, 2, device="cpu"), cfg, *_fed_data(),
        num_rounds=2, seed=SEED,
        on_round_end=lambda r, m: got_rows.append(dict(m)),
        params=params_from_jax(init, device="cpu"),
        perms_for_round=lambda r: perms[r],
        draws_for_round=lambda r: given[r])
    assert [r["epsilon"] for r in got_rows] == [r["epsilon"] for r in rows]
    assert got.epsilons == res.epsilons == [r["epsilon"] for r in rows]
    for g, w in zip(got_rows, rows):
        assert set(g) == set(w)
        assert g.get("epsilon_accounting") == w.get("epsilon_accounting")
        assert abs(g["loss"] - w["loss"]) <= ROUND_ATOL
    assert ("epsilon_accounting" in got_rows[0]) == (kind == "dp-example")
    _close(got.params, res.params, ROUND_ATOL)


def test_resumed_run_charges_the_checkpointed_rounds(tmp_path):
    """A run resumed at round 1 reports the same ε per round (and the
    same θ) as the uninterrupted run."""
    _, cfg = _cfgs("dp-example")

    def run(num_rounds, directory):
        rows = []
        res = train_federated(
            make_vqc_classifier(N, L, 2, device="cpu"), cfg, *_fed_data(),
            num_rounds=num_rounds, seed=3,
            checkpointer=pckpt.Checkpointer(directory, every=1),
            on_round_end=lambda r, m: rows.append(m))
        return res, rows

    whole, whole_rows = run(2, tmp_path / "a")
    run(1, tmp_path / "b")
    resumed, rows = run(2, tmp_path / "b")
    assert [r["round"] for r in rows] == [2]
    assert [r["epsilon"] for r in rows] == [r["epsilon"]
                                            for r in whole_rows[1:]]
    assert rows[0]["epsilon_accounting"] == whole_rows[0][
        "epsilon_accounting"]
    for a, b in zip(trees.tree_leaves(resumed.params),
                    trees.tree_leaves(whole.params)):
        assert torch.equal(a, b)


# --- where per-example DP meets the kernel (n = 12) ---------------------------------


@pytest.mark.parametrize("clients,batch", [(2, 16), (4, 10)])
def test_per_example_groups_reach_the_kernel(monkeypatch, clients, batch):
    """The reference traces each example's forward at tb = 1 (vmapped
    over examples and clients): ``route_ok`` True, the kernel at any lot.
    The port runs the C·B examples as one-sample groups in forwards of at
    most 32 groups (``apply_groups``), each one ``route_ok`` accepts —
    above 32 groups one program would keep a stacked g1 and refuse."""
    from qfedx_tpu.fed import client as rclient_mod
    from qfedx_tpu.ops import pallas_body as rpb
    from qfedx_tpu_torch.ops import scan_body

    n, layers = 12, 3
    seen = []
    orig = rpb.route_ok
    monkeypatch.setattr(rpb, "route_ok", lambda s, n_, p, b: seen.append(
        ((s.re.shape[0] if b else 1), orig(s, n_, p, b))) or seen[-1][1])
    rmodel = ref_make(n, layers, 2)
    rcfg = RFedConfig(batch_size=batch, local_epochs=1,
                      dp=RDPConfig(mode="example"))
    lu = rclient_mod.make_local_update(rmodel, rcfg)
    jax.eval_shape(
        jax.vmap(lambda x, y, m, k: lu(rmodel.init(jax.random.PRNGKey(0)),
                                       x, y, m, k)),
        jnp.zeros((clients, batch, n)), jnp.zeros((clients, batch),
                                                  jnp.int32),
        jnp.ones((clients, batch)), jax.random.split(
            jax.random.PRNGKey(0), clients))
    assert seen and all(tb == 1 and ok for tb, ok in seen), seen

    got = []
    porig = scan_body.route_ok
    monkeypatch.setattr(scan_body, "route_ok", lambda s, n_, p, b: got.append(
        (s.re.shape[0], porig(s, n_, p, b))) or got[-1][1])
    # Record the route only: the kernel branch hands its state back.
    monkeypatch.setattr(scan_body, "apply_scan_pallas",
                        lambda state, n_, program, batched=False: state)
    model = make_vqc_classifier(n, layers, 2, device="cpu")
    groups = clients * batch
    leaves = trees.tree_map(
        lambda p: p[None].expand((groups,) + tuple(p.shape)),
        model.init(0))
    with torch.no_grad():
        logits = pclient.apply_groups(model, leaves, torch.zeros(groups, 1,
                                                                  n))
    assert tuple(logits.shape) == (groups, 1, 2)
    chunks = -(-groups // 32)
    assert got == [(min(32, groups - 32 * i), True) for i in range(chunks)]
    # One program of all the groups: refused above 32.
    got.clear()
    with torch.no_grad():
        model.apply_clients(leaves, torch.zeros(groups, 1, n))
    assert got == [(groups, groups <= 32)]
