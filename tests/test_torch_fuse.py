"""Port vs reference: the stacked fusion pass and the kernel routing gate.

For the HEA at n ∈ {10, 12, 15, 16, 17}, L ∈ {2, 3}, the port's
``fuse_ops_stacked`` must emit the reference's program — same kinds,
qubits, stacked flags, static row permutations and coefficient shapes,
values within 1e-6 — and the port's ``route_ok`` must agree with the
reference's, including False at n=16 (the stacked ``g1`` the odd row
qubit leaves at even widths from 16 up). The reference runs with the
TPU program shape forced (the env pins, ``_gather_ok`` and
``_growmat_merge_ok`` patched to True); the port builds that program by
default.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qfedx_tpu.circuits import ansatz as ransatz
from qfedx_tpu.ops import fuse as rfuse
from qfedx_tpu.ops import pallas_body as rpb
from qfedx_tpu.ops.cpx import CArray as JC
from qfedx_tpu_torch.circuits import ansatz
from qfedx_tpu_torch.ops import fuse, scan_body
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


VALUE_ATOL = 1e-6


@pytest.fixture
def tpu_form(monkeypatch):
    for pin in ("QFEDX_FUSE", "QFEDX_SCAN_LAYERS", "QFEDX_PALLAS",
                "QFEDX_BATCHED"):
        monkeypatch.setenv(pin, "1")
    monkeypatch.setenv("QFEDX_GATE_FORM", "flip")
    monkeypatch.setenv("QFEDX_SLAB_LANES", "matmul")
    monkeypatch.setattr(rfuse, "_gather_ok", lambda: True)
    monkeypatch.setattr(rfuse, "_growmat_merge_ok", lambda: True)


def _angles(n, length, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-2, 2, (length, n)).astype(np.float32),
            rng.uniform(-2, 2, (length, n)).astype(np.float32))


def _programs(n, length):
    rx, rz = _angles(n, length)
    ref = rfuse.fuse_ops_stacked(
        ransatz.hea_scan_ops(n, jnp.asarray(rx), jnp.asarray(rz)), n, length
    )
    out = fuse.fuse_ops_stacked(
        ansatz.hea_scan_ops(n, torch.as_tensor(rx), torch.as_tensor(rz)),
        n, length,
    )
    return ref, out


def _same_coeffs(ref, out, where):
    if ref is None or out is None:
        assert ref is None and out is None, where
        return
    if isinstance(ref, JC):
        assert isinstance(out, TC), where
        for r, o, part in ((ref.re, out.re, "re"), (ref.im, out.im, "im")):
            if r is None:
                assert o is None, f"{where}: {part} is None in the reference"
                continue
            assert o is not None, f"{where}: {part} missing in the port"
            assert tuple(o.shape) == tuple(r.shape), where
            np.testing.assert_allclose(
                o.numpy(), np.asarray(r), atol=VALUE_ATOL, rtol=0,
                err_msg=where,
            )
        return
    # static row permutation (numpy gather map)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(ref), where)


def _same_program(ref, out, where):
    for part in ("pre", "body"):
        r_ops, o_ops = getattr(ref, part), getattr(out, part)
        assert [(o.kind, tuple(o.qubits), o.stacked) for o in o_ops] == [
            (o.kind, tuple(o.qubits), o.stacked) for o in r_ops
        ], where
        for i, (r, o) in enumerate(zip(r_ops, o_ops)):
            _same_coeffs(r.coeffs, o.coeffs, f"{where} {part}[{i}] {r.kind}")


@pytest.mark.parametrize("length", [2, 3])
@pytest.mark.parametrize("n", [10, 12, 15, 16, 17])
def test_hea_program_and_route_match_reference(tpu_form, n, length):
    ref, out = _programs(n, length)
    assert out.length == ref.length == length
    _same_program(ref, out, f"n={n}")
    for tb in (1, 4):
        rstate = JC(jnp.zeros((tb, 1 << n)), jnp.zeros((tb, 1 << n)))
        ostate = TC(torch.zeros(tb, 1 << n), torch.zeros(tb, 1 << n))
        want = rpb.route_ok(rstate, n, ref, True)
        assert scan_body.route_ok(ostate, n, out, True) is want
        # Even widths from 16 up keep a stacked g1 the kernel cannot emit.
        assert want is (n != 16)
    if n == 16:
        assert "g1" in [op.kind for op in out.body]


def test_n12_program_is_the_served_kernel_body(tpu_form):
    _, out = _programs(12, 3)
    assert [op.kind for op in out.pre] == ["rowmat"]
    assert [op.kind for op in out.body] == ["glane", "growmat"]
    glane, growmat = out.body
    assert tuple(glane.coeffs.re.shape) == (3, 2, 128, 128)
    assert tuple(growmat.coeffs.re.shape) == (3, 2, 32, 32)


def test_routing_pins(monkeypatch):
    for pin in ("QFEDX_FUSE", "QFEDX_SCAN_LAYERS", "QFEDX_PALLAS"):
        monkeypatch.delenv(pin, raising=False)
    assert scan_body.resolved_route() == {
        "fuse": True, "scan_layers": True, "pallas": True,
    }
    assert fuse.scan_active(12, 3) and not fuse.scan_active(12, 1)
    monkeypatch.setenv("QFEDX_SCAN_LAYERS", "0")
    assert scan_body.resolved_route()["pallas"] is False
    monkeypatch.setenv("QFEDX_PALLAS", "banana")
    with pytest.raises(ValueError, match="QFEDX_PALLAS"):
        scan_body.pallas_enabled()


def test_pallas_off_takes_the_layer_loop(monkeypatch):
    """QFEDX_PALLAS=0 never enters the kernel branch; the layer loop
    computes the same state."""
    n, length = 12, 3
    rx, rz = _angles(n, length, seed=4)
    prog = fuse.fuse_ops_stacked(
        ansatz.hea_scan_ops(n, torch.as_tensor(rx), torch.as_tensor(rz)),
        n, length,
    )
    rng = np.random.default_rng(5)
    state = TC(torch.as_tensor(rng.normal(size=(2, 1 << n)),
                               dtype=torch.float32), None)
    on = fuse.apply_scan(state, n, prog, batched=True)

    def boom(*a, **k):  # pragma: no cover - failure mode
        raise AssertionError("kernel branch entered with QFEDX_PALLAS=0")

    monkeypatch.setattr(scan_body, "apply_scan_pallas", boom)
    monkeypatch.setenv("QFEDX_PALLAS", "0")
    off = fuse.apply_scan(state, n, prog, batched=True)
    for a, b in zip(on, off):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=0)


def test_stacked_trace_rejects_wrong_layer_axis():
    rx, rz = _angles(10, 3)
    ops = ansatz.hea_scan_ops(10, torch.as_tensor(rx), torch.as_tensor(rz))
    with pytest.raises(ValueError, match="layer count"):
        fuse.fuse_ops_stacked(ops, 10, 4)


# --- general IR traces: the pass's branches HEA never reaches --------------

N = 10
L = 2


def _u2(rng, lead):
    z = rng.normal(size=lead + (2, 2)) + 1j * rng.normal(size=lead + (2, 2))
    q, r = np.linalg.qr(z)
    dg = np.diagonal(r, axis1=-2, axis2=-1)
    q = q * (dg / np.abs(dg))[..., None, :]
    return q.real.astype(np.float32), q.imag.astype(np.float32)


def _phase(rng, shape):
    th = rng.uniform(-np.pi, np.pi, size=shape)
    return np.cos(th).astype(np.float32), np.sin(th).astype(np.float32)


def _ry(rng, lead):
    th = rng.uniform(-2, 2, size=lead)
    c, s = np.cos(th / 2), np.sin(th / 2)
    m = np.stack([np.stack([c, -s], -1), np.stack([s, c], -1)], -2)
    return m.astype(np.float32), None


def _g2(rng, lead):
    re = rng.normal(size=lead + (2, 2, 2, 2)).astype(np.float32)
    return re, rng.normal(size=lead + (2, 2, 2, 2)).astype(np.float32)


# name -> (trace builder (rng) -> [(kind, qubits, (re, im) | None)],
#          patched constants). Program equality here plus the executor
# parity of tests/test_torch_ops.py cover the executed state.
TRACES = {
    "diag_chain": (lambda rng: [
        ("diag1", (2,), _phase(rng, (L, 2))),
        ("diag2", (3, N - 2), _phase(rng, (L, 2, 2))),
    ], {}),
    "mask_boundary_merge": (lambda rng: [
        ("diag1", (0,), _phase(rng, (L, 2))),
        ("g1", (0,), _ry(rng, (L,))),
        ("diag1", (0,), _phase(rng, (L, 2))),
    ], {"_ROWMAT_MAX_BITS": 0}),
    "lane_diag_folds": (lambda rng: [
        ("g1", (N - 1,), _u2(rng, (L,))),
        ("diag1", (N - 2,), _phase(rng, (L, 2))),
        ("diag2", (N - 3, N - 2), _phase(rng, (L, 2, 2))),
        ("g1", (N - 3,), _u2(rng, (L,))),
    ], {}),
    "row_diag_folds": (lambda rng: [
        ("g1", (0,), _u2(rng, (L,))),
        ("diag1", (1,), _phase(rng, (L, 2))),
        ("diag2", (0, 2), _phase(rng, (L, 2, 2))),
        ("cnot", (1, 2), None),
        ("g1", (2,), _u2(rng, (L,))),
    ], {}),
    "ctrl_cnot_after_collapse": (lambda rng: [
        ("cnot", (2, N - 1), None),
        ("g1", (N - 2,), _ry(rng, (L,))),
        ("cnot", (2, N - 3), None),
    ], {}),
    "mixed_group_boundary": (lambda rng: [
        ("g1", (0,), _ry(rng, (L, 2))),
        ("cnot", (N - 1, 1), None),
        ("g1", (0,), _ry(rng, (L,))),
    ], {}),
    "grouped_diag_capped": (lambda rng: [
        ("g1", (0,), _ry(rng, (L,))),
        ("diag1", (1,), _phase(rng, (L, 4, 2))),
    ], {"_ROWMAT_GROUP_MAX": 1}),
    "wide_row_pairs_and_g2": (lambda rng: [
        ("g1", (0,), _u2(rng, (L,))),
        ("g1", (1,), _u2(rng, (L,))),
        ("g1", (2,), _u2(rng, (L,))),
        ("cnot", (0, 2), None),
        ("g2", (1, 2), _g2(rng, (L,))),
    ], {"_ROWMAT_MAX_BITS": 1}),
}


@pytest.mark.parametrize("name", sorted(TRACES))
def test_general_trace_matches_reference(monkeypatch, tpu_form, name):
    build, patches = TRACES[name]
    for attr, val in patches.items():
        monkeypatch.setattr(rfuse, attr, val)
        monkeypatch.setattr(fuse, attr, val)
    trace = build(np.random.default_rng(sorted(TRACES).index(name)))

    def ops(mod, carray, arr):
        return [
            mod.Op(kind, qubits, None if c is None else carray(
                arr(c[0]), None if c[1] is None else arr(c[1])
            ))
            for kind, qubits, c in trace
        ]

    _same_program(
        rfuse.fuse_ops_stacked(ops(rfuse, JC, jnp.asarray), N, L),
        fuse.fuse_ops_stacked(ops(fuse, TC, torch.as_tensor), N, L),
        name,
    )
