"""Port vs reference: the served VQC classifier (qfedx_tpu_torch/models/vqc.py).

The reference's ``make_vqc_classifier(12, 3, 2)`` runs its batched
route with the TPU program shape forced (fused, scanned, Pallas
interpreted); the port's runs the same program with the scan-body
kernel's plain version on the CPU. Same weights (carried across by
``params_from_jax``), same features: logits within 2e-5 (the reference's
own QFEDX_PALLAS on/off bound).
"""

import jax
import numpy as np
import pytest
import torch

from qfedx_tpu.models.vqc import make_vqc_classifier as ref_make
from qfedx_tpu.ops import fuse as rfuse
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
    with pytest.raises(NotImplementedError, match="amplitude"):
        make_vqc_classifier(12, 3, 2, encoding="amplitude", device="cpu")
    small = make_vqc_classifier(8, 2, 2, device="cpu")
    with pytest.raises(NotImplementedError, match="dense"):
        small.apply(small.init(0), _features(8))
    model = make_vqc_classifier(12, 3, 2, device="cpu")
    monkeypatch.setenv("QFEDX_DTYPE", "bf16")
    with pytest.raises(NotImplementedError, match="bf16"):
        model.apply(model.init(0), _features(12))


def test_device_less_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_vqc_classifier(12, 3, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_jax({"readout": {"bias": np.zeros(2)}})
