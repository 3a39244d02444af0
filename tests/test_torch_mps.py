"""Port vs reference: the MPS classifier with its safe SVD, and the
quantum-kernel head (BASELINE.md config 5).

- ``safe_svd``'s backward against the reference's ``_safe_svd_bwd`` fed
  the same (U, S, Vh) and cotangents, within 1e-5 — square, rank-1
  deficient, tall and wide, and batched; finite where stock
  ``torch.linalg.svd``'s gradient is not;
- MPS ⟨Z⟩ exact at χ = 2^{n/2} against both packages' dense engines,
  and against the reference's MPS at L = 1, within 1e-5; the
  classifier's logits against ``make_mps_classifier`` at L = 1 within
  1e-4;
- ∂/∂θ: against the dense engines of both packages at L = 1 and 2 and
  against the reference's MPS at L = 1, within 2e-4. At L = 2 the
  reference's MPS misses its own dense engine, ⟨Z⟩ on some inputs and
  ∂/∂θ on most (its splits keep an arbitrary basis of the null space;
  ``ops/mps.py``): pinned here, with the port's independence of that
  basis (rotating it moves nothing);
- an MPS SGD round (one client at a time) against ``make_fed_round`` at
  L = 1 within 1e-4;
- ``kernel_matrix`` against the reference and ``kernel_matrix_dense``
  within 1e-6, the head's logits, a qkernel round folded and unfolded
  against the reference within 1e-6, ``init_landmarks_from_data``;
- ``build_model``'s ValueErrors as the reference raises them; the CLI
  trains and serves ``--model qkernel`` and ``--model mps``.
"""

import functools
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ref_streams as streams
from qfedx_tpu.circuits.encoders import angle_encode as r_angle_encode
from qfedx_tpu.fed.config import FedConfig as RFedConfig
from qfedx_tpu.fed.round import (
    client_mesh,
    make_fed_round as ref_make_round,
    shard_client_data,
)
from qfedx_tpu.models import kernel as rkernel
from qfedx_tpu.models.vqc_mps import _ry_mats as r_ry_mats
from qfedx_tpu.models.vqc_mps import make_mps_classifier as ref_mps
from qfedx_tpu.ops import gates as rgates
from qfedx_tpu.ops import mps as rmps
from qfedx_tpu.ops import statevector as rsv
from qfedx_tpu.ops.linalg import _safe_svd_bwd
from qfedx_tpu.run import config as rconfig
from qfedx_tpu_torch.circuits.encoders import angle_encode
from qfedx_tpu_torch.fed.config import FedConfig
from qfedx_tpu_torch.fed.round import make_fed_round
from qfedx_tpu_torch.models import kernel
from qfedx_tpu_torch.models.api import params_from_jax
from qfedx_tpu_torch.models.vqc_mps import _ry_mats, make_mps_classifier
from qfedx_tpu_torch.ops import gates, linalg, mps
from qfedx_tpu_torch.ops import statevector as sv
from qfedx_tpu_torch.run import cli as pcli
from qfedx_tpu_torch.run import config as pconfig
from qfedx_tpu_torch.utils import trees

SVD_ATOL = 1e-5
Z_ATOL = 1e-5
MPS_ATOL = 1e-4
# ∂/∂θ in f32 through L·(n−1) SVD backwards, O(1) entries; the
# reference's own bound against its dense engine is 2e-3.
GRAD_ATOL = 2e-4
KERNEL_ATOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several workers on one CPU."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _close(got, want, atol):
    for g, w in zip(trees.tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=atol,
                                   rtol=0)


# --- safe_svd ---------------------------------------------------------------


def _matrix(kind, rng):
    if kind == "square":
        return rng.normal(size=(5, 5))
    if kind == "rank1":
        a = rng.normal(size=(4, 1))
        return a @ a.T
    if kind == "tall":
        return rng.normal(size=(7, 3))
    return rng.normal(size=(3, 6))  # wide


@pytest.mark.parametrize("kind", ["square", "rank1", "tall", "wide"])
def test_safe_svd_backward_matches_reference(kind):
    """Both backward formulas on the SAME (U, S, Vh) and cotangents (the
    reference's forward), so the check does not depend on which SVD
    produced them."""
    rng = np.random.default_rng(len(kind))
    m = jnp.asarray(_matrix(kind, rng), jnp.float32)
    u, s, vh = (np.asarray(a) for a in jnp.linalg.svd(m,
                                                      full_matrices=False))
    cts = tuple(rng.normal(size=a.shape).astype(np.float32)
                for a in (u, s, vh))
    (want,) = _safe_svd_bwd(1e-10, (u, s, vh), tuple(map(jnp.asarray, cts)))
    got = linalg.safe_svd_bwd(*(torch.as_tensor(a) for a in (u, s, vh)),
                              *(torch.as_tensor(c) for c in cts))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=SVD_ATOL, rtol=0)


def test_safe_svd_backward_batches():
    rng = np.random.default_rng(11)
    ms = rng.normal(size=(3, 6, 6)).astype(np.float32)
    ms[1] = np.outer(ms[1, 0], ms[1, 1])  # a rank-deficient member
    parts = [np.asarray(a) for a in jnp.linalg.svd(jnp.asarray(ms),
                                                   full_matrices=False)]
    cts = [rng.normal(size=a.shape).astype(np.float32) for a in parts]
    got = linalg.safe_svd_bwd(*(torch.as_tensor(a) for a in parts + cts))
    for i in range(3):
        (want,) = _safe_svd_bwd(1e-10, tuple(a[i] for a in parts),
                                tuple(jnp.asarray(c[i]) for c in cts))
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want),
                                   atol=SVD_ATOL, rtol=0)


def test_safe_svd_finite_where_stock_svd_is_not():
    """A rank-1 matrix on a zero-padded bond (a product state through a
    CNOT): its zero singular values are exactly degenerate, so stock
    autograd divides 0 by 0; safe_svd stays finite."""
    a = torch.tensor([[1.0], [0.5], [0.0], [0.0]])
    w = torch.arange(16, dtype=torch.float32).reshape(4, 4) / 8.0

    def grad(svd):
        m = (a @ a.T).requires_grad_(True)
        u, s, vh = svd(m)
        loss = torch.sum(w * ((u * s[None, :]) @ vh)) + torch.sum(u[:, 1])
        return torch.autograd.grad(loss, m)[0]

    assert not torch.isfinite(grad(
        lambda m: torch.linalg.svd(m, full_matrices=False))).all()
    assert torch.isfinite(grad(linalg.safe_svd)).all()


def test_safe_svd_matches_stock_on_separated_spectrum():
    rng = np.random.default_rng(0)
    m = torch.tensor(0.2 * rng.normal(size=(6, 4)) + np.pad(
        np.diag([5.0, 3.0, 2.0, 1.0]), ((0, 2), (0, 0))), dtype=torch.float32)
    w = [torch.tensor(rng.normal(size=sh), dtype=torch.float32)
         for sh in ((6, 4), (4,), (4, 4))]

    def grad(svd):
        x = m.clone().requires_grad_(True)
        u, s, vh = svd(x)
        loss = (torch.sum(w[0] * u * u) + torch.sum(w[1] * s)
                + torch.sum(w[2] * vh * vh))
        return torch.autograd.grad(loss, x)[0]

    np.testing.assert_allclose(
        grad(linalg.safe_svd).numpy(),
        grad(lambda x: torch.linalg.svd(x, full_matrices=False)).numpy(),
        atol=1e-3)


def test_truncated_svd_pads_the_discarded_cotangents():
    m = torch.randn(2, 8, 8, requires_grad=True)
    u, s, vh = linalg.truncated_svd(m, 3)
    assert (u.shape, s.shape, vh.shape) == ((2, 8, 3), (2, 3), (2, 3, 8))
    g, = torch.autograd.grad(torch.sum((u * s[..., None, :]) @ vh), m)
    assert torch.isfinite(g).all()


# --- MPS against the dense engines -------------------------------------------


def _rng_case(n, layers, seed, batch=3, scale=0.8):
    rng = np.random.default_rng(seed)
    ry = rng.normal(scale=scale, size=(layers, n)).astype(np.float32)
    x = rng.uniform(0, 1, (batch, n)).astype(np.float32)
    w = rng.normal(size=n).astype(np.float32)
    return ry, x, w


def _port_mps_z(ry, x, chi):
    sites = mps.product_mps(_ry_mats(x * math.pi)[..., 0], chi)
    for layer in range(ry.shape[0]):
        sites = mps.apply_1q_all(sites, _ry_mats(ry[layer]))
        sites = mps.apply_cnot_chain(sites)
    return mps.expect_z_all(sites)


def _port_dense_z(ry, x):
    n = x.shape[-1]
    state = angle_encode(x)
    for layer in range(ry.shape[0]):
        for q in range(n):
            state = sv.apply_gate(state, gates.ry(ry[layer, q]), q, n)
        for q in range(n - 1):
            state = sv.apply_gate_2q(state, gates.CNOT, q, q + 1, n)
    return sv.expect_z_all(state, n)


def _ref_mps_z(ry, xi, chi):
    state = rmps.product_mps(r_ry_mats(xi * jnp.pi)[:, :, 0], chi)
    for layer in range(ry.shape[0]):
        state = rmps.apply_1q_all(state, r_ry_mats(ry[layer]))
        state = rmps.apply_cnot_chain(state)
    return rmps.expect_z_all(state)


def _ref_dense_z(ry, xi):
    state = r_angle_encode(xi)
    n_layers, n = ry.shape
    for layer in range(n_layers):
        for q in range(n):
            state = rsv.apply_gate(state, rgates.ry(ry[layer, q]), q)
        for q in range(n - 1):
            state = rsv.apply_gate_2q(state, rgates.CNOT, q, q + 1)
    return rsv.expect_z_all(state)


def _ref_z(fn, ry, x):
    """``fn(θ, x_i)`` for every sample, vmapped and jitted."""
    return np.asarray(jax.jit(jax.vmap(lambda xi: fn(jnp.asarray(ry), xi)))(
        jnp.asarray(x)))


def _port_grad(fn, ry, x, w):
    t = torch.tensor(ry, requires_grad=True)
    z = fn(t, torch.tensor(x))
    return torch.autograd.grad(torch.sum(z * torch.tensor(w)), t)[0].numpy()


def _ref_grad(fn, ry, x, w):
    """∂ Σ_samples w·fn(θ, x_i) / ∂θ, vmapped over the samples and
    jitted (eager JAX dispatches the unrolled circuit op by op)."""
    return np.asarray(jax.jit(jax.grad(lambda p: jnp.sum(
        w * jax.vmap(lambda xi: fn(p, xi))(jnp.asarray(x)))))(
            jnp.asarray(ry)))


@pytest.mark.parametrize("n,layers", [(4, 1), (4, 2), (6, 2), (7, 1)])
def test_mps_z_exact_at_full_bond_dim(n, layers):
    """Exact against both dense engines; against the reference's MPS at
    L = 1 (at L = 2 its result depends on its SVD's null basis:
    ``test_reference_mps_misses_dense_at_two_layers``)."""
    ry, x, _ = _rng_case(n, layers, seed=n + layers)
    chi = 2 ** (n // 2)
    got = _port_mps_z(torch.tensor(ry), torch.tensor(x), chi).numpy()
    if layers == 1:
        want = _ref_z(lambda p, xi: _ref_mps_z(p, xi, chi), ry, x)
        np.testing.assert_allclose(got, want, atol=Z_ATOL, rtol=0)
    dense = _port_dense_z(torch.tensor(ry), torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, dense, atol=Z_ATOL, rtol=0)
    np.testing.assert_allclose(got, _ref_z(_ref_dense_z, ry, x),
                               atol=Z_ATOL, rtol=0)


@pytest.mark.parametrize("n", [4, 5, 6])
def test_mps_logits_match_reference(n):
    rmodel = ref_mps(n, n_layers=1, num_classes=2, bond_dim=2 ** (n // 2))
    rparams = jax.tree.map(np.asarray, rmodel.init(jax.random.PRNGKey(n)))
    rparams["readout"]["bias"] = np.array([0.1, -0.2], np.float32)
    model = make_mps_classifier(n, 1, 2, 2 ** (n // 2), device="cpu")
    x = np.random.default_rng(n).uniform(0, 1, (5, n)).astype(np.float32)
    got = model.apply(params_from_jax(rparams, device="cpu"), x).numpy()
    want = np.asarray(jax.jit(rmodel.apply)(rparams, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=MPS_ATOL, rtol=0)


@pytest.mark.parametrize("n,layers", [(4, 1), (6, 1), (4, 2), (5, 2),
                                      (6, 2)])
def test_mps_gradients_match_dense(n, layers):
    """∂⟨Z⟩·w/∂θ at χ = 2^{n/2} equals both dense engines'; at L = 1 the
    reference's MPS too."""
    ry, x, w = _rng_case(n, layers, seed=10 * n + layers, batch=2)
    chi = 2 ** (n // 2)
    got = _port_grad(lambda p, xx: _port_mps_z(p, xx, chi), ry, x, w)
    np.testing.assert_allclose(got, _port_grad(_port_dense_z, ry, x, w),
                               atol=GRAD_ATOL, rtol=0)
    np.testing.assert_allclose(got, _ref_grad(_ref_dense_z, ry, x, w),
                               atol=GRAD_ATOL, rtol=0)
    if layers == 1:
        np.testing.assert_allclose(
            got, _ref_grad(lambda p, xi: _ref_mps_z(p, xi, chi), ry, x, w),
            atol=GRAD_ATOL, rtol=0)


def test_reference_mps_misses_dense_at_two_layers():
    """Why the port zeroes the split's null space: at L = 2 the
    reference's MPS misses its own dense engine even at χ = 2^{n/2} —
    ⟨Z⟩ on some inputs, ∂/∂θ on most — and the port's does not."""
    n, chi = 4, 4
    ry, x, _ = _rng_case(n, 2, seed=6)
    ref_z = _ref_z(lambda p, xi: _ref_mps_z(p, xi, chi), ry, x)
    dense_z = _ref_z(_ref_dense_z, ry, x)
    assert np.abs(ref_z - dense_z).max() > 1e-2
    port_z = _port_mps_z(torch.tensor(ry), torch.tensor(x), chi).numpy()
    np.testing.assert_allclose(port_z, dense_z, atol=Z_ATOL, rtol=0)
    n, chi = 5, 4
    ry, x, w = _rng_case(n, 2, seed=52, batch=2)
    dense = _ref_grad(_ref_dense_z, ry, x, w)
    ref = _ref_grad(lambda p, xi: _ref_mps_z(p, xi, chi), ry, x, w)
    port = _port_grad(lambda p, xx: _port_mps_z(p, xx, chi), ry, x, w)
    assert np.abs(ref - dense).max() > 1e-2
    np.testing.assert_allclose(port, dense, atol=GRAD_ATOL, rtol=0)


def _rotate_null_basis(monkeypatch, seed):
    """``torch.linalg.svd`` with the basis of its (numerically) zero
    singular subspace rotated at random: another valid SVD, as another
    routine (LAPACK, cuSOLVER) may return."""
    stock = torch.linalg.svd
    gen = torch.Generator().manual_seed(seed)

    def svd(m, full_matrices=False):
        u, s, vh = stock(m, full_matrices=False)
        k = s.shape[-1]
        null = s < 1e-5 * s[..., :1]
        mask = null[..., :, None] & null[..., None, :]
        q, r = torch.linalg.qr(torch.where(
            mask, torch.randn(m.shape[:-2] + (k, k), generator=gen),
            torch.eye(k)))
        q = q * torch.sign(torch.diagonal(r, dim1=-2, dim2=-1))[..., None, :]
        return u @ q, s, q.transpose(-1, -2) @ vh

    monkeypatch.setattr(torch.linalg, "svd", svd)


@pytest.mark.parametrize("n,chi", [(8, 16), (8, 4), (12, 8)])
def test_mps_does_not_depend_on_the_svd_null_basis(monkeypatch, n, chi):
    ry, x, w = _rng_case(n, 2, seed=n + chi, batch=4)
    fn = lambda p, xx: _port_mps_z(p, xx, chi)  # noqa: E731
    z0 = fn(torch.tensor(ry), torch.tensor(x)).numpy()
    g0 = _port_grad(fn, ry, x, w)
    _rotate_null_basis(monkeypatch, seed=n)
    z1 = fn(torch.tensor(ry), torch.tensor(x)).numpy()
    g1 = _port_grad(fn, ry, x, w)
    np.testing.assert_allclose(z1, z0, atol=Z_ATOL, rtol=0)
    np.testing.assert_allclose(g1, g0, atol=GRAD_ATOL, rtol=0)


def test_truncated_mps_is_sane_and_finite():
    """χ = 2 at n = 8: ⟨Z⟩ in [−1, 1], finite gradients at heavy
    truncation and at the small-angle init."""
    for scale in (0.8, 0.1):
        ry, x, w = _rng_case(8, 2, seed=4, scale=scale)
        fn = lambda p, xx: _port_mps_z(p, xx, 2)  # noqa: E731
        z = fn(torch.tensor(ry), torch.tensor(x)).numpy()
        assert np.all(np.isfinite(z)) and np.all(np.abs(z) <= 1 + 1e-5)
        assert np.all(np.isfinite(_port_grad(fn, ry, x, w)))


def test_mps_zero_state_and_norm():
    sites = mps.zero_mps(5, 4, batch=2)
    np.testing.assert_allclose(mps.norm_sq(sites).numpy(), 1.0)
    np.testing.assert_allclose(mps.expect_z_all(sites).numpy(), 1.0)
    flipped = mps.apply_1q(sites, 2, torch.tensor([[0.0, 1.0], [1.0, 0.0]]))
    np.testing.assert_allclose(mps.expect_z_all(flipped)[:, 2].numpy(), -1.0)


def test_mps_classifier_value_errors():
    with pytest.raises(ValueError, match="num_classes"):
        make_mps_classifier(2, num_classes=3, device="cpu")
    with pytest.raises(ValueError, match="bond_dim"):
        make_mps_classifier(4, bond_dim=1, device="cpu")


def _round_data(n, clients, samples, seed):
    rng = np.random.default_rng(seed)
    cx = rng.uniform(0, 1, (clients, samples, n)).astype(np.float32)
    cy = rng.integers(0, 2, (clients, samples)).astype(np.int32)
    cm = np.ones((clients, samples), np.float32)
    cm[-1, -1] = 0.0
    return cx, cy, cm


def _ref_round(rmodel, kw, rparams, data, key, clients):
    mesh = client_mesh(num_devices=1)
    rf = ref_make_round(rmodel, RFedConfig(**kw), mesh, num_clients=clients)
    out, st = rf(rparams, *shard_client_data(
        mesh, *(jnp.asarray(a) for a in data)), key)
    return jax.tree.map(np.asarray, out), st


def test_mps_round_matches_reference():
    n, clients, samples, batch = 4, 2, 8, 4
    kw = dict(local_epochs=1, batch_size=batch, learning_rate=0.1,
              momentum=0.9)
    rmodel = ref_mps(n, n_layers=1, num_classes=2, bond_dim=4)
    rparams = jax.tree.map(np.asarray, rmodel.init(jax.random.PRNGKey(2)))
    data = _round_data(n, clients, samples, 3)
    key = jax.random.PRNGKey(8)
    want, wst = _ref_round(rmodel, kw, rparams, data, key, clients)
    model = make_mps_classifier(n, 1, 2, 4, device="cpu")
    got, gst = make_fed_round(model, FedConfig(**kw), num_clients=clients)(
        params_from_jax(rparams, device="cpu"),
        *(torch.as_tensor(a) for a in data),
        perms=streams.perms(key, clients, 1, samples))
    _close(got, want, MPS_ATOL)
    assert abs(float(gst.mean_loss) - float(wst.mean_loss)) <= MPS_ATOL


# --- the quantum-kernel head ---------------------------------------------------


@pytest.mark.parametrize("basis", ["ry", "rx"])
def test_kernel_matrix_matches_reference_and_dense(basis):
    rng = np.random.default_rng(1)
    xs = rng.uniform(0, 1, (5, 6)).astype(np.float32)
    ys = rng.uniform(0, 1, (4, 6)).astype(np.float32)
    got = kernel.kernel_matrix(torch.tensor(xs), torch.tensor(ys), basis)
    want = np.asarray(rkernel.kernel_matrix(jnp.asarray(xs),
                                            jnp.asarray(ys), basis))
    np.testing.assert_allclose(got.numpy(), want, atol=KERNEL_ATOL, rtol=0)
    dense = kernel.kernel_matrix_dense(torch.tensor(xs), torch.tensor(ys),
                                       basis)
    np.testing.assert_allclose(got.numpy(), dense.numpy(),
                               atol=KERNEL_ATOL, rtol=0)
    rdense = np.asarray(rkernel.kernel_matrix_dense(jnp.asarray(xs),
                                                    jnp.asarray(ys), basis))
    np.testing.assert_allclose(dense.numpy(), rdense, atol=KERNEL_ATOL,
                               rtol=0)


def test_kernel_head_logits_match_reference():
    rmodel = rkernel.make_quantum_kernel_classifier(6, 5, 3)
    rparams = jax.tree.map(np.asarray, rmodel.init(jax.random.PRNGKey(4)))
    model = kernel.make_quantum_kernel_classifier(6, 5, 3, device="cpu")
    x = np.random.default_rng(2).uniform(0, 1, (7, 6)).astype(np.float32)
    pparams = params_from_jax(rparams, device="cpu")
    got = model.apply(pparams, x).numpy()
    want = np.asarray(rmodel.apply(rparams, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=KERNEL_ATOL, rtol=0)
    # The folded forward: two clients with their own parameters.
    cparams = trees.tree_map(lambda p: torch.stack([p, 2 * p]), pparams)
    both = model.apply_clients(cparams, np.stack([x, x]))
    np.testing.assert_allclose(both[0].numpy(), got, atol=KERNEL_ATOL)
    np.testing.assert_allclose(
        both[1].numpy(),
        model.apply(trees.tree_map(lambda p: 2 * p, pparams), x).numpy(),
        atol=KERNEL_ATOL)


def test_kernel_head_init_distributions():
    model = kernel.make_quantum_kernel_classifier(20, 16, 2,
                                                  landmark_scale=0.5,
                                                  device="cpu")
    p = model.init(0)
    assert p["landmarks"].shape == (16, 20) and p["w"].shape == (16, 2)
    assert 0.0 <= float(p["landmarks"].min()) and float(
        p["landmarks"].max()) < 0.5
    assert 0.05 < float(p["w"].std()) < 0.15
    assert torch.equal(p["b"], torch.zeros(2))


@pytest.mark.parametrize("fold", ["1", "0"], ids=["folded", "unfolded"])
@pytest.mark.parametrize("algorithm", ["fedavg", "fedprox"])
def test_kernel_round_matches_reference(monkeypatch, fold, algorithm):
    monkeypatch.setenv("QFEDX_FOLD_CLIENTS", fold)
    n, clients, samples, batch = 6, 3, 8, 4
    kw = dict(local_epochs=2, batch_size=batch, learning_rate=0.5,
              momentum=0.9, algorithm=algorithm,
              prox_mu=0.3 if algorithm == "fedprox" else 0.0)
    rmodel = rkernel.make_quantum_kernel_classifier(n, 4, 2)
    rparams = jax.tree.map(np.asarray, rmodel.init(jax.random.PRNGKey(6)))
    data = _round_data(n, clients, samples, 7)
    key = jax.random.PRNGKey(9)
    want, wst = _ref_round(rmodel, kw, rparams, data, key, clients)
    model = kernel.make_quantum_kernel_classifier(n, 4, 2, device="cpu")
    got, gst = make_fed_round(model, FedConfig(**kw), num_clients=clients)(
        params_from_jax(rparams, device="cpu"),
        *(torch.as_tensor(a) for a in data),
        perms=streams.perms(key, clients, 2, samples))
    _close(got, want, KERNEL_ATOL)
    assert abs(float(gst.mean_loss) - float(wst.mean_loss)) <= KERNEL_ATOL


def test_init_landmarks_from_data():
    model = kernel.make_quantum_kernel_classifier(4, 3, 2, device="cpu")
    p = model.init(0)
    x = np.random.default_rng(0).uniform(0, 1, (5, 4)).astype(np.float32)
    got = kernel.init_landmarks_from_data(p, x)
    np.testing.assert_array_equal(got["landmarks"].numpy(), x[:3])
    assert got["w"] is p["w"]
    with pytest.raises(ValueError) as mine:
        kernel.init_landmarks_from_data(p, x[:2])
    with pytest.raises(ValueError) as ref:
        rkernel.init_landmarks_from_data(
            jax.tree.map(lambda t: jnp.asarray(t.numpy()), p),
            jnp.asarray(x[:2]))
    assert str(mine.value) == str(ref.value)


# --- build_model and the CLI ---------------------------------------------------


@pytest.mark.parametrize("model,extra", [
    ("mps", {"encoding": "amplitude"}),
    ("mps", {"depolarizing_p": 0.1}),
    ("mps", {"sv_size": 2}),
    ("qkernel", {"shots": 100}),
])
def test_build_model_value_errors_match_reference(model, extra):
    def raised(cfg_mod, **kw):
        cfg = cfg_mod.ExperimentConfig(model=cfg_mod.ModelConfig(
            model=model, n_qubits=4, **extra))
        with pytest.raises(ValueError) as exc:
            cfg_mod.build_model(cfg, 2, **kw)
        return str(exc.value)

    mine = raised(pconfig, device="cpu")
    ref = raised(rconfig)
    assert mine.split(" (")[0].split(";")[0] == \
        ref.split(" (")[0].split(";")[0]


@pytest.fixture
def small_data(monkeypatch):
    monkeypatch.setattr(pcli, "DataConfig", functools.partial(
        pconfig.DataConfig, synthetic_train=256, synthetic_test=64))


@pytest.mark.parametrize("extra,n", [
    (["--model", "qkernel", "--qubits", "5", "--landmarks", "4"], 5),
    (["--model", "mps", "--qubits", "6", "--bond-dim", "4"], 6),
])
def test_cli_train_then_serve(tmp_path, small_data, extra, n):
    pcli.main(["train", *extra, "--classes", "0,1", "--clients", "2",
               "--rounds", "2", "--local-epochs", "1", "--checkpoint-every",
               "1", "--run-root", str(tmp_path), "--name", "run"],
              device="cpu")
    run = tmp_path / "run"
    x = np.random.default_rng(3).uniform(0, 1, (3, n)).astype(np.float32)
    (tmp_path / "in.jsonl").write_text("\n".join(
        json.dumps({"id": i, "features": v.tolist()})
        for i, v in enumerate(x)) + "\n")
    out = tmp_path / "out.jsonl"
    served = pcli.main(["serve", "--run-dir", str(run), "--input",
                        str(tmp_path / "in.jsonl"), "--output", str(out),
                        "--buckets", "1,4"], device="cpu")
    assert served["served"] == 3
    cfg = pconfig.experiment_config_from_dict(
        json.loads((run / "config.json").read_text()))
    model = pconfig.build_model(cfg, 2, device="cpu")
    from qfedx_tpu_torch.run.checkpoint import Checkpointer

    params, _ = Checkpointer(run / "checkpoints").restore_latest(
        model.init(0))
    want = model.apply(params, x).numpy()
    got = np.array([json.loads(line)["logits"]
                    for line in out.read_text().splitlines()])
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
