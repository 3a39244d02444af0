"""Port vs reference: the batched slab engine (qfedx_tpu_torch/ops/batched.py).

The same seeded numpy inputs go through each ``qfedx_tpu.ops.batched``
executor and its port, at n=10 and n=12 with shared (G=1) and per-sample
(G = tb) coefficient stacks. Tolerance: atol 1e-5 in f32 (same products,
other summation order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qfedx_tpu.ops import batched as rbt
from qfedx_tpu.ops.cpx import CArray as JC
from qfedx_tpu_torch.ops import batched as bt
from qfedx_tpu_torch.ops.cpx import CArray as TC


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these small tensors: the suite runs
    several workers on one CPU, where torch's default pool per worker
    oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


ATOL = 1e-5
TB = 4


def _np_c(rng, shape, real=False):
    re = rng.normal(size=shape).astype(np.float32)
    im = None if real else rng.normal(size=shape).astype(np.float32)
    return re, im


def _jax(c):
    re, im = c
    return JC(jnp.asarray(re), None if im is None else jnp.asarray(im))


def _torch(c):
    re, im = c
    return TC(torch.as_tensor(re), None if im is None else torch.as_tensor(im))


def _state(rng, n):
    re, im = _np_c(rng, (TB, 1 << n))
    norm = np.sqrt((re**2 + im**2).sum(axis=1, keepdims=True))
    return re / norm, im / norm


def _close(ref, out):
    np.testing.assert_allclose(
        np.asarray(out.re), np.asarray(ref.re), atol=ATOL, rtol=0
    )
    ref_im = np.zeros_like(np.asarray(ref.re)) if ref.im is None else ref.im
    out_im = torch.zeros_like(out.re) if out.im is None else out.im
    np.testing.assert_allclose(
        np.asarray(out_im), np.asarray(ref_im), atol=ATOL, rtol=0
    )


def _unitary(rng, lead, d):
    z = rng.normal(size=lead + (d, d)) + 1j * rng.normal(size=lead + (d, d))
    q, r = np.linalg.qr(z)
    dg = np.diagonal(r, axis1=-2, axis2=-1)
    q = q * (dg / np.abs(dg))[..., None, :]
    return q.real.astype(np.float32), q.imag.astype(np.float32)


# Each case: (name, coefficient builder (rng, n, lead) -> (re, im) or
# None, executor call on (module, state, n, coeffs)).
def _rowpair(rng, n, lead):
    re, im = _unitary(rng, lead, 4)
    shp = lead + (2, 2, 2, 2)
    return re.reshape(shp), im.reshape(shp)


CASES = {
    "gate_row": (
        lambda rng, n, lead: _unitary(rng, lead, 2),
        lambda m, s, n, c: m.apply_gate_b(s, n, c, 1),
    ),
    "gate_lane": (
        lambda rng, n, lead: _unitary(rng, lead, 2),
        lambda m, s, n, c: m.apply_gate_b(s, n, c, n - 2),
    ),
    "lane_matrix": (
        lambda rng, n, lead: _unitary(rng, lead, 128),
        lambda m, s, n, c: m.apply_lane_matrix_b(s, n, c),
    ),
    "row_matrix": (
        lambda rng, n, lead: _unitary(rng, lead, 1 << (n - 7)),
        lambda m, s, n, c: m.apply_row_matrix_b(s, n, c),
    ),
    "lane_matrix_ctrl": (
        lambda rng, n, lead: _unitary(rng, lead + (2,), 128),
        lambda m, s, n, c: m.apply_lane_matrix_ctrl_b(s, n, c, 1),
    ),
    "row_matrix_ctrl": (
        lambda rng, n, lead: _unitary(rng, lead + (2,), 1 << (n - 7)),
        lambda m, s, n, c: m.apply_row_matrix_ctrl_b(s, n, c, n - 3),
    ),
    "rowpair": (
        _rowpair,
        lambda m, s, n, c: m.apply_rowpair_b(s, n, c, 0, 2),
    ),
    "phase_mask": (
        lambda rng, n, lead: _np_c(rng, lead + (1 << n,)),
        lambda m, s, n, c: m.apply_phase_mask_b(s, n, c),
    ),
}


@pytest.mark.parametrize("grouped", [False, True], ids=["G1", "Gtb"])
@pytest.mark.parametrize("n", [10, 12])
@pytest.mark.parametrize("case", sorted(CASES))
def test_executor_parity(case, n, grouped):
    build, call = CASES[case]
    rng = np.random.default_rng([sorted(CASES).index(case), n, grouped])
    state = _state(rng, n)
    coeffs = build(rng, n, (TB,) if grouped else ())
    ref = call(rbt, _jax(state), n, _jax(coeffs))
    out = call(bt, _torch(state), n, _torch(coeffs))
    _close(ref, out)


@pytest.mark.parametrize("n", [10, 12])
@pytest.mark.parametrize(
    "ctrl_tgt",
    [(0, 1), (2, 0), (8, 9), (9, 8), (1, 9), (9, 1)],
    ids=["row-row", "row-row-rev", "lane-lane", "lane-lane-rev",
         "rowc-lanet", "lanec-rowt"],
)
def test_cnot_parity(n, ctrl_tgt):
    rng = np.random.default_rng(n)
    state = _state(rng, n)
    c, t = ctrl_tgt
    ref = rbt.apply_cnot_b(_jax(state), n, c, t)
    out = bt.apply_cnot_b(_torch(state), n, c, t)
    _close(ref, out)


@pytest.mark.parametrize("n", [10, 12])
def test_row_perm_parity(n):
    rng = np.random.default_rng(3)
    state = _state(rng, n)
    perm = rng.permutation(1 << (n - 7))
    _close(
        rbt.apply_row_perm_b(_jax(state), n, perm),
        bt.apply_row_perm_b(_torch(state), n, perm),
    )


@pytest.mark.parametrize("basis_im", [False, True], ids=["real", "complex"])
@pytest.mark.parametrize("n", [10, 11, 12])
def test_product_tree_parity(n, basis_im):
    rng = np.random.default_rng(n)
    th = rng.uniform(0, np.pi, (TB, n)).astype(np.float32)
    re = np.stack([np.cos(th / 2), np.sin(th / 2)], -1).astype(np.float32)
    im = (
        np.stack([np.zeros_like(th), -np.sin(th / 2)], -1).astype(np.float32)
        if basis_im else None
    )
    ref = rbt.bstate_product_tree(_jax((re, im)))
    _close(ref, bt.bstate_product_tree(_torch((re, im))))
    _close(ref, bt.bstate_product(_torch((re, im))))


@pytest.mark.parametrize("n", [10, 12])
def test_expect_z_parity(n):
    state = _state(np.random.default_rng(5), n)
    np.testing.assert_allclose(
        bt.expect_z_all_b(_torch(state), n).numpy(),
        np.asarray(rbt.expect_z_all_b(_jax(state), n)),
        atol=ATOL, rtol=0,
    )


def test_grouped_coefficients_must_divide_batch():
    rng = np.random.default_rng(0)
    state = _torch(_state(rng, 10))
    bad = _torch(_unitary(rng, (3,), 128))
    with pytest.raises(ValueError, match="G must divide B"):
        bt.apply_lane_matrix_b(state, 10, bad)
    with pytest.raises(ValueError, match="n ≥ 10"):
        bt.apply_cnot_b(_torch(_state(rng, 9)), 9, 0, 1)


def test_batched_pin(monkeypatch):
    monkeypatch.delenv("QFEDX_BATCHED", raising=False)
    assert bt.batched_enabled(12) is True
    assert bt.batched_enabled(9) is False
    monkeypatch.setenv("QFEDX_BATCHED", "off")
    assert bt.batched_enabled(12) is False
    monkeypatch.setenv("QFEDX_BATCHED", "maybe")
    with pytest.raises(ValueError, match="QFEDX_BATCHED"):
        bt.batched_enabled(12)


def test_gates_and_cpx_parity():
    from qfedx_tpu.ops import cpx as rcpx
    from qfedx_tpu.ops import gates as rgates
    from qfedx_tpu_torch.ops import cpx, gates

    rng = np.random.default_rng(9)
    th, ph = rng.uniform(-3, 3, (2, 5)).astype(np.float32)
    for ref, out in (
        (rgates.rot_zx_batched(jnp.asarray(th), jnp.asarray(ph)),
         gates.rot_zx_batched(torch.as_tensor(th), torch.as_tensor(ph))),
        (rgates.rot_zx(th[0], ph[0]), gates.rot_zx(th[0], ph[0])),
        (rgates.ry(th[1]), gates.ry(th[1])),
    ):
        _close(ref, out)
    z = rng.normal(size=(3, 4)) + 1j * rng.normal(size=(3, 4))
    a = cpx.from_complex(z, device="cpu")
    np.testing.assert_allclose(cpx.to_complex(a), z.astype(np.complex64))
    b = cpx.from_complex(z[::-1], device="cpu")
    _close(rcpx.cmul(rcpx.from_complex(z), rcpx.from_complex(z[::-1])),
           cpx.cmul(a, b))
