"""Port vs reference: the scan-body kernel's plain version and its wrapper.

``scan_body_plain`` (the plain PyTorch version the CUDA kernel is held
against on the card) must compute what the reference's Pallas kernel
computes: ``qfedx_tpu.ops.pallas_body.apply_scan_pallas`` runs in
interpret mode on the CPU, on the HEA programs at n=12 (glane + growmat)
and n=15 (rowpairs + rowperm + glane + cnot), and on a directly built
program with every kernel op kind and all four CNOT placements (shared
G=1 and, real-valued, per-sample G=tb coefficients), at tb = 4. Tolerance:
atol 1e-5 in f32 (same products, other summation order).

The CUDA kernel itself only runs on the card (``chip_smoke.py``); here
the wrapper is held to its contract: CPU tensors take the plain version
without counting a launch, non-f32 or misshapen inputs raise, and the
packed descriptor/coefficient layout the kernel reads is consistent.
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

ATOL = 1e-5
TB = 4


@pytest.fixture(autouse=True)
def tpu_form(monkeypatch):
    for pin in ("QFEDX_FUSE", "QFEDX_SCAN_LAYERS", "QFEDX_PALLAS",
                "QFEDX_BATCHED"):
        monkeypatch.setenv(pin, "1")
    monkeypatch.setenv("QFEDX_GATE_FORM", "flip")
    monkeypatch.setenv("QFEDX_SLAB_LANES", "matmul")
    monkeypatch.setattr(rfuse, "_gather_ok", lambda: True)
    monkeypatch.setattr(rfuse, "_growmat_merge_ok", lambda: True)


def _pair(re, im):
    """Numpy (re, im) → (reference CArray, port CArray)."""
    return (
        JC(jnp.asarray(re), None if im is None else jnp.asarray(im)),
        TC(torch.as_tensor(re), None if im is None else torch.as_tensor(im)),
    )


def _state(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(TB, 1 << n)) + 1j * rng.normal(size=(TB, 1 << n))
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return _pair(x.real.astype(np.float32), x.imag.astype(np.float32))


def _kinds_programs(n, length, groups, seed, real=False):
    """Every kernel emission and all four CNOT placements (the program
    of tests/test_pallas.py::test_kernel_kinds_parity_and_grads, at any
    slab width), built once in numpy and handed to both packages."""
    rng = np.random.default_rng(seed)
    r = 1 << (n - 7)
    lead = (length,) + (() if groups is None else (groups,))

    def unitary(shape):
        d = shape[-1]
        z = rng.normal(size=shape[:-2] + (d, d))
        if not real:
            z = z + 1j * rng.normal(size=shape[:-2] + (d, d))
        q, rr = np.linalg.qr(z)
        dg = np.diagonal(rr, axis1=-2, axis2=-1)
        q = q * (dg / np.abs(dg))[..., None, :]
        return q.real.astype(np.float32), (
            None if real else q.imag.astype(np.float32)
        )

    def phases(shape):
        th = rng.uniform(-np.pi, np.pi, size=shape)
        return (np.cos(th).astype(np.float32),
                None if real else np.sin(th).astype(np.float32))

    def pair4(c):
        shp = lead + (2, 2, 2, 2)
        return tuple(None if x is None else x.reshape(shp) for x in c)

    spec = [
        ("lane", (), unitary(lead + (128, 128))),
        ("mask", (), phases(lead + (1 << n,))),
        ("growmat", (n - 2,), unitary(lead + (2, r, r))),
        ("rowpair", (0, 2), pair4(unitary(lead + (4, 4)))),
        ("rowperm", (), rng.permutation(r)),
        ("glane", (1,), unitary(lead + (2, 128, 128))),
        ("rowmat", (), unitary(lead + (r, r))),
        ("cnot", (0, 1), None),          # row-row
        ("cnot", (n - 5, n - 2), None),  # lane-lane
        ("cnot", (2, n - 1), None),      # row ctrl, lane tgt
        ("cnot", (n - 1, 2), None),      # lane ctrl, row tgt
    ]
    progs = []
    for side in (0, 1):
        mod = rfuse if side == 0 else fuse
        body = []
        for kind, qubits, c in spec:
            if kind == "rowperm":
                body.append(mod.StackedOp(kind, qubits, c, False))
            elif c is None:
                body.append(mod.StackedOp(kind, qubits, None, False))
            else:
                body.append(mod.StackedOp(kind, qubits, _pair(*c)[side], True))
        progs.append(mod.ScanProgram((), tuple(body), length))
    return progs


def _hea_programs(n, length, groups, seed):
    rng = np.random.default_rng(seed)
    shape = (length, n) if groups is None else (length, groups, n)
    rx = rng.uniform(-2, 2, shape).astype(np.float32)
    rz = rng.uniform(-2, 2, shape).astype(np.float32)
    ref = rfuse.fuse_ops_stacked(
        ransatz.hea_scan_ops(n, jnp.asarray(rx), jnp.asarray(rz)), n, length
    )
    out = fuse.fuse_ops_stacked(
        ansatz.hea_scan_ops(n, torch.as_tensor(rx), torch.as_tensor(rz)),
        n, length,
    )
    return ref, out


def _plain_after_pre(state, n, program):
    """The port's kernel inputs (pre-ops applied, packed, spec, xs) run
    through ``scan_body_plain`` directly."""
    state = TC(state.re, state.imag_or_zeros())
    for op in program.pre:
        state = fuse._exec_stacked(state, n, op, True)
    assert scan_body.route_ok(state, n, program, True)
    spec = scan_body._build_spec(state, n, program, True)
    xs = tuple(op.coeffs for op in program.body if op.stacked)
    r = 1 << (n - 7)
    packed = torch.stack([state.re.reshape(TB, r, 128),
                          state.im.reshape(TB, r, 128)])
    out = scan_body.scan_body_plain(packed, spec, xs)
    return out[0].reshape(TB, -1), out[1].reshape(TB, -1)


def _check(rstate, ostate, n, rprog, oprog):
    assert rpb.route_ok(rstate, n, rprog, True)
    ref = rpb.apply_scan_pallas(rstate, n, rprog, batched=True)
    plain = _plain_after_pre(ostate, n, oprog)
    wrapped = scan_body.apply_scan_pallas(ostate, n, oprog, batched=True)
    for got in (plain, tuple(wrapped)):
        for g, w in zip(got, (ref.re, ref.im)):
            np.testing.assert_allclose(
                g.numpy(), np.asarray(w), atol=ATOL, rtol=0
            )


@pytest.mark.parametrize(
    "n,length", [(12, 3), (15, 2)], ids=["n12-L3", "n15-L2"],
)
def test_plain_matches_reference_kernel_hea(n, length):
    rprog, oprog = _hea_programs(n, length, None, seed=n)
    rstate, ostate = _state(n, seed=n + 1)
    _check(rstate, ostate, n, rprog, oprog)


@pytest.mark.parametrize(
    "n,groups,real",
    [(10, None, False), (10, TB, True)],
    ids=["n10-G1", "n10-Gtb-real"],
)
def test_plain_matches_reference_kernel_all_kinds(n, groups, real):
    rprog, oprog = _kinds_programs(n, 2, groups, seed=11 + n, real=real)
    rstate, ostate = _state(n, seed=5)
    _check(rstate, ostate, n, rprog, oprog)


def _served_inputs():
    _, prog = _hea_programs(12, 3, None, seed=1)
    _, state = _state(12, seed=2)
    state = fuse._exec_stacked(state, 12, prog.pre[0], True)
    spec = scan_body._build_spec(state, 12, prog, True)
    xs = tuple(op.coeffs for op in prog.body if op.stacked)
    packed = torch.stack([state.re.reshape(TB, 32, 128),
                          state.im.reshape(TB, 32, 128)])
    return packed, spec, xs


def test_wrapper_cpu_takes_plain_without_counting():
    packed, spec, xs = _served_inputs()
    before = scan_body.launch_count
    out = scan_body.scan_body(packed, spec, xs)
    assert scan_body.launch_count == before
    assert torch.equal(out, scan_body.scan_body_plain(packed, spec, xs))


def test_wrapper_rejects_bad_inputs():
    packed, spec, xs = _served_inputs()
    with pytest.raises(TypeError, match="float32"):
        scan_body.scan_body(packed.double(), spec, xs)
    with pytest.raises(ValueError, match="shape"):
        scan_body.scan_body(packed[:, :2], spec, xs)
    bad = tuple(TC(c.re.double(), c.im.double()) for c in xs)
    with pytest.raises(TypeError, match="float32"):
        scan_body.scan_body(packed, spec, bad)
    with pytest.raises(ValueError, match="cuda or cpu"):
        scan_body.scan_body(packed.to("meta"), spec,
                            tuple(TC(c.re.to("meta"), c.im.to("meta"))
                                  for c in xs))


def test_kernel_layout_packs_every_stacked_op():
    """The descriptor offsets the kernel reads point at each stacked op's
    (L, G, gate) re/im blocks inside the one packed coefficient buffer,
    and the rowperm gather map sits at its static offset."""
    rprog, oprog = _kinds_programs(10, 2, TB, seed=3)
    _, ostate = _state(10, seed=4)
    spec = scan_body._build_spec(ostate, 10, oprog, True)
    xs = tuple(op.coeffs for op in oprog.body if op.stacked)
    desc, total, statics = scan_body._layout(spec)
    packed = scan_body._pack_coeffs(spec, xs).numpy()
    assert packed.size == total
    it = iter(xs)
    for row, op in zip(desc, spec.ops):
        kind, q0, q1, re_off, im_off, groups, gsize, st_off = (
            int(v) for v in row
        )
        assert kind == scan_body._KIND_CODE[op.kind]
        assert (q0, q1)[: len(op.qubits)] == tuple(op.qubits)[:2]
        if op.kind == "rowperm":
            np.testing.assert_array_equal(
                statics[st_off:st_off + len(op.perm)], op.perm
            )
        if not op.stacked:
            assert im_off == -1
            continue
        c = next(it)
        block = spec.length * groups * gsize
        assert groups == TB
        np.testing.assert_array_equal(
            packed[re_off:re_off + block], c.re.reshape(-1).numpy()
        )
        np.testing.assert_array_equal(
            packed[im_off:im_off + block], c.im.reshape(-1).numpy()
        )
