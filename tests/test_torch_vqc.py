"""Port vs reference: the served VQC classifier (qfedx_tpu_torch/models/vqc.py).

The reference's ``make_vqc_classifier(12, 3, 2)`` runs its batched
route with the TPU program shape forced (fused, scanned, Pallas
interpreted); the port's runs the same program with the scan-body
kernel's plain version on the CPU. Same weights (carried across by
``params_from_jax``), same features: logits within 2e-5 (the reference's
own QFEDX_PALLAS on/off bound).

The training hooks: the client-folded ``apply_clients`` (n=10, L=3, C=2
clients of 4 samples, per-client weights) gives the reference's logits,
and the gradients of the folded loss Σ_c mean-CE_c with respect to every
leaf equal the reference's ``jax.grad`` through its interpreted kernel
(the port's ``ScanBodyFn`` on the CPU), both within 2e-5; ``wrap_delta``
wraps angles bit for bit like the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from qfedx_tpu.models.vqc import make_vqc_classifier as ref_make
from qfedx_tpu.ops import fuse as rfuse
from qfedx_tpu_torch.fed.client import _cross_entropy
from qfedx_tpu_torch.models.vqc import make_vqc_classifier, params_from_jax

ATOL = 2e-5


@pytest.fixture(autouse=True)
def tpu_form(monkeypatch):
    for pin in ("QFEDX_FUSE", "QFEDX_SCAN_LAYERS", "QFEDX_PALLAS",
                "QFEDX_BATCHED"):
        monkeypatch.setenv(pin, "1")
    monkeypatch.setenv("QFEDX_GATE_FORM", "flip")
    monkeypatch.setenv("QFEDX_SLAB_LANES", "matmul")
    monkeypatch.setattr(rfuse, "_gather_ok", lambda: True)
    monkeypatch.setattr(rfuse, "_growmat_merge_ok", lambda: True)


def _ref_params(model, seed, scale):
    p = model.init(jax.random.PRNGKey(seed))
    # Widen the near-identity init so the circuit is far from trivial.
    return jax.tree.map(lambda a: np.asarray(a) * scale, p)


def _features(n, batch=4, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (batch, n)).astype(
        np.float32
    )


def test_logits_match_reference():
    n, layers = 12, 3
    ref = ref_make(n, layers, 2)
    params = _ref_params(ref, seed=n, scale=10.0)
    x = _features(n)
    want = np.asarray(jax.jit(ref.apply)(params, x))
    model = make_vqc_classifier(n, layers, 2, device="cpu")
    got = model.apply(params_from_jax(params, device="cpu"), x)
    assert model.name == ref.name
    assert got.dtype == torch.float32 and tuple(got.shape) == (4, 2)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("pins_off", [
    {"QFEDX_SCAN_LAYERS": "0"}, {"QFEDX_FUSE": "0"}, {"QFEDX_PALLAS": "0"},
], ids=["scan-off", "fuse-off", "kernel-off"])
def test_routes_agree(monkeypatch, pins_off):
    """Scan off (gate by gate), fuse off, and the kernel route refused
    (torch layer loop) compute the kernel route's logits."""
    model = make_vqc_classifier(10, 2, 2, init_scale=1.0, device="cpu")
    params = model.init(3)
    x = _features(10)
    want = model.apply(params, x).numpy()
    for pin, val in pins_off.items():
        monkeypatch.setenv(pin, val)
    np.testing.assert_allclose(model.apply(params, x).numpy(), want,
                               atol=1e-5, rtol=0)


def test_params_from_jax_keys_and_types():
    ref = ref_make(12, 3, 2)
    p = params_from_jax(jax.tree.map(np.asarray,
                                     ref.init(jax.random.PRNGKey(0))),
                        device="cpu")
    assert {k: sorted(v) for k, v in p.items()} == {
        "ansatz": ["rx", "rz"], "readout": ["bias", "scale"],
    }
    assert tuple(p["ansatz"]["rx"].shape) == (3, 12)
    assert all(t.dtype == torch.float32 for d in p.values()
               for t in d.values())


def test_init_seeding():
    model = make_vqc_classifier(12, 3, 2, device="cpu")
    a, b = model.init(7), model.init(np.random.default_rng(7))
    assert torch.equal(a["ansatz"]["rx"], b["ansatz"]["rx"])
    g = model.init(torch.Generator().manual_seed(7))
    assert tuple(g["ansatz"]["rz"].shape) == (3, 12)
    assert torch.equal(a["readout"]["scale"], torch.ones(2))


def test_unported_routes_raise(monkeypatch):
    """Amplitude encoding still raises; the dense route below n = 10 and
    the folded route off the scan (the per-layer ``fuse_ops`` pass) run
    and match the batched route."""
    with pytest.raises(NotImplementedError, match="amplitude"):
        make_vqc_classifier(12, 3, 2, encoding="amplitude", device="cpu")
    small = make_vqc_classifier(8, 2, 2, device="cpu")
    logits = small.apply(small.init(0), _features(8))
    assert small.engine() == "vmap" and tuple(logits.shape) == (4, 2)
    model = make_vqc_classifier(12, 3, 2, init_scale=1.0, device="cpu")
    # bf16 states are ported: the pin runs (f32 logits), it does not raise.
    monkeypatch.setenv("QFEDX_DTYPE", "bf16")
    logits = model.apply(model.init(0), _features(12))
    assert logits.dtype == torch.float32 and tuple(logits.shape) == (4, 2)
    assert torch.isfinite(logits).all()
    monkeypatch.delenv("QFEDX_DTYPE")
    cparams = _client_params(model.init(0), 2)
    x = _features(12, 8).reshape(2, 4, 12)
    want = model.apply_clients(cparams, x)
    dense_x = _features(12)
    want_dense = model.apply(model.init(0), dense_x)
    monkeypatch.setenv("QFEDX_SCAN_LAYERS", "0")
    np.testing.assert_allclose(model.apply_clients(cparams, x).numpy(),
                               want.numpy(), atol=1e-5, rtol=0)
    monkeypatch.setenv("QFEDX_BATCHED", "0")
    assert model.engine() == "vmap"
    np.testing.assert_allclose(model.apply(model.init(0), dense_x).numpy(),
                               want_dense.numpy(), atol=1e-5, rtol=0)


def test_device_less_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_vqc_classifier(12, 3, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_jax({"readout": {"bias": np.zeros(2)}})


# --- the training hooks -------------------------------------------------------

N_FOLD, L_FOLD, C_FOLD = 10, 3, 2


def _client_params(params, c):
    return {g: {k: v[None].repeat((c,) + (1,) * v.ndim) for k, v in d.items()}
            for g, d in params.items()}


def _ref_client_params(seed=5):
    """Per-client weights: the reference init widened, each client's
    angles and readout shifted apart."""
    ref = ref_make(N_FOLD, L_FOLD, 2)
    p = _ref_params(ref, seed=seed, scale=10.0)
    rng = np.random.default_rng(seed)
    return ref, jax.tree.map(
        lambda a: (a[None] + 0.3 * rng.normal(size=(C_FOLD,) + a.shape))
        .astype(np.float32), p,
    )


def _fold_batch(seed=6):
    x = _features(N_FOLD, C_FOLD * 4, seed).reshape(C_FOLD, 4, N_FOLD)
    y = np.random.default_rng(seed).integers(0, 2, (C_FOLD, 4))
    return x, y.astype(np.int32)


def test_apply_clients_matches_reference():
    ref, cparams = _ref_client_params()
    x, _ = _fold_batch()
    want = np.asarray(jax.jit(ref.apply_clients)(cparams, x))
    model = make_vqc_classifier(N_FOLD, L_FOLD, 2, device="cpu")
    got = model.apply_clients(params_from_jax(cparams, device="cpu"), x)
    assert tuple(got.shape) == (C_FOLD, 4, 2)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=ATOL, rtol=0)


def test_folded_loss_grads_match_reference():
    """∂(Σ_c mean-CE_c)/∂leaf for every leaf: the port's autograd
    (``ScanBodyFn``'s Launches B/C, plain on the CPU) ≡ the reference's
    ``jax.grad`` through its interpreted kernel."""
    ref, cparams = _ref_client_params()
    x, y = _fold_batch()

    def ref_loss(cp):
        ce = optax.softmax_cross_entropy_with_integer_labels(
            ref.apply_clients(cp, x), jnp.asarray(y))
        return jnp.sum(jnp.mean(ce, axis=1))

    want = jax.jit(jax.grad(ref_loss))(cparams)
    model = make_vqc_classifier(N_FOLD, L_FOLD, 2, device="cpu")
    leaves = {g: {k: v.requires_grad_(True) for k, v in d.items()}
              for g, d in params_from_jax(cparams, device="cpu").items()}
    ce = _cross_entropy(model.apply_clients(leaves, x), torch.as_tensor(y))
    ce.mean(dim=1).sum().backward()
    for g, d in leaves.items():
        for k, v in d.items():
            assert v.grad is not None, f"{g}/{k}"
            np.testing.assert_allclose(
                v.grad.numpy(), np.asarray(want[g][k]), atol=ATOL, rtol=0,
                err_msg=f"{g}/{k}",
            )


def test_wrap_delta_matches_reference_bitwise():
    from qfedx_tpu.models.vqc import wrap_angle as ref_wrap
    from qfedx_tpu_torch.models.vqc import wrap_angle

    pi = np.float32(np.pi)
    eps = np.finfo(np.float32).eps
    base = np.array([-pi, pi, -3 * pi, 3 * pi, 2 * pi, 0.0], np.float32)
    around = np.concatenate([
        base, np.nextafter(base, np.float32(np.inf)),
        np.nextafter(base, np.float32(-np.inf)), base * (1 + 4 * eps),
        np.random.default_rng(0).uniform(-10, 10, 64).astype(np.float32),
    ]).astype(np.float32)
    want = np.asarray(ref_wrap(jnp.asarray(around)))
    got = wrap_angle(torch.as_tensor(around)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got >= -pi).all() and (got < pi).all()
    ref = ref_make(N_FOLD, L_FOLD, 2)
    model = make_vqc_classifier(N_FOLD, L_FOLD, 2, device="cpu")
    delta = {"ansatz": {"rx": around[:60].reshape(2, 3, 10),
                        "rz": around[4:64].reshape(2, 3, 10)},
             "readout": {"scale": around[:4].reshape(2, 2),
                         "bias": around[2:6].reshape(2, 2)}}
    want = ref.wrap_delta(jax.tree.map(jnp.asarray, delta))
    got = model.wrap_delta(params_from_jax(delta, device="cpu"))
    for g in delta:
        for k in delta[g]:
            np.testing.assert_array_equal(got[g][k].numpy(),
                                          np.asarray(want[g][k]))
