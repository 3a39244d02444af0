"""Port vs reference under QFEDX_DTYPE=bf16: the bf16-state /
f32-accumulate route, module by module and for the slice as a whole.

States are bf16 in both packages; parameters, gate construction, logits,
the loss, gradients, the optimizer and FedAvg stay f32, and coefficients
are cast to bf16 where they are applied. The reference runs with the TPU
program shape forced (``tests/test_pallas.py:42-48``); its Pallas kernel
runs in interpret mode. ``QFEDX_DTYPE`` is set through ``monkeypatch``
only, so no test leaks bf16 into another.

Inputs are made in f32 with numpy and cast to bf16 by each package (the
same round-to-nearest-even), so both start from the same bf16 values.
Where both round at the same points they still disagree now and then by
one bf16 step (2^-8 of a value), because an f32 sum taken in another
order can land on the other side of a rounding boundary; XLA may also
skip an intermediate rounding inside a fused chain (excess precision).

Tolerances, each with what these inputs give on XLA:CPU and torch's CPU
kernels (a bf16 amplitude here is ~0.01-0.1, so one bf16 step of it is
~4e-5-5e-4):
- the kernel's plain version against the interpreted kernel on the same
  coefficients — Launches A, B and C on every op kind at n = 10, 12, 15,
  the served HEA body, and ``ScanBodyFn``'s state cotangent: equal, bit
  for bit (the plain sweep rounds where ``_emit`` rounds, rowpair
  included);
- the HEA body from each package's own program build: relative norm
  SWEEP_RTOL = 1e-2 (2.5e-3: the two builds' f32 coefficients differ
  in the last bit, and 12 of 196608 round to another bf16 value);
- executors: max abs EXEC_ATOL = 1e-4 (≤ 6.1e-5, one bf16 step below
  2^-6, in 2 of 32 cases; the other 30 equal); CNOTs, row permutations,
  product states and the encoder: equal;
- logits: max abs BF16_LOGIT_ATOL = 2e-4 (≤ 5.6e-5, n = 15); per-round
  losses: BF16_LOSS_ATOL = 1e-3 (one SGD round's mean loss 1.5e-4, the
  trainer's rows ≤ 7.8e-6); AUC within one ranked pair (equal here);
- gradients and θ updates, port bf16 vs reference bf16: relative norm
  BF16_GRAD_RTOL = 5% (``ScanBodyFn``'s coefficient cotangents 3.1e-3,
  the folded model ≤ 5.3e-3, one SGD round's update 1.1e-2, the
  trainer's 1.7e-3);
- port bf16 vs port f32: the reference's own bf16-vs-f32 bounds in
  ``tests/test_bf16.py`` — 3e-2 on ⟨Z⟩ (there on the slab engine, :117;
  here ≤ 2.2e-2 on logits) and a relative gradient norm of 0.12 (:134;
  here ≤ 3.2e-2).
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import threadpoolctl
import torch

from qfedx_tpu.circuits import ansatz as ransatz
from qfedx_tpu.fed.config import FedConfig as RFedConfig
from qfedx_tpu.fed.round import (
    TRAIN_KEY_SALT,
    client_mesh,
    make_fed_round as ref_make_round,
    shard_client_data,
)
from qfedx_tpu.models.vqc import make_vqc_classifier as ref_make
from qfedx_tpu.ops import batched as rbt
from qfedx_tpu.ops import cpx as rcpx
from qfedx_tpu.ops import fuse as rfuse
from qfedx_tpu.ops import pallas_body as rpb
from qfedx_tpu.ops.cpx import CArray as JC
from qfedx_tpu.run import checkpoint as rckpt
from qfedx_tpu.run.trainer import train_federated as ref_train
from qfedx_tpu_torch.circuits import ansatz
from qfedx_tpu_torch.circuits.encoders import angle_amplitudes
from qfedx_tpu_torch.fed.client import _cross_entropy
from qfedx_tpu_torch.fed.config import FedConfig
from qfedx_tpu_torch.fed.round import make_fed_round
from qfedx_tpu_torch.models.vqc import make_vqc_classifier, params_from_jax
from qfedx_tpu_torch.ops import batched as bt
from qfedx_tpu_torch.ops import cpx, fuse, scan_body
from qfedx_tpu_torch.ops.cpx import CArray as TC
from qfedx_tpu_torch.run import checkpoint as pckpt
from qfedx_tpu_torch.run import cli as pcli
from qfedx_tpu_torch.run import config as pconfig
from qfedx_tpu_torch.run.trainer import train_federated
from qfedx_tpu_torch.utils import trees

EXEC_ATOL = 1e-4
SWEEP_RTOL = 1e-2
BF16_LOGIT_ATOL = 2e-4
BF16_LOSS_ATOL = 1e-3
BF16_GRAD_RTOL = 0.05
REF_Z_ATOL = 3e-2  # tests/test_bf16.py:117
REF_GRAD_RTOL = 0.12  # tests/test_bf16.py:134
TB = 4
# The reference's launches and their gradient run jitted: its eager
# interpreted kernel dispatches every op of every grid step on its own.
_ref_run = jax.jit(rpb._run, static_argnums=(0, 3))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these small tensors, in torch and in
    numpy's BLAS (the programs' random unitaries come from its QR): the
    suite runs several workers on one CPU, where each library's default
    pool per worker oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(1):
        yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def tpu_form(monkeypatch):
    for pin in ("QFEDX_FUSE", "QFEDX_SCAN_LAYERS", "QFEDX_PALLAS",
                "QFEDX_BATCHED"):
        monkeypatch.setenv(pin, "1")
    monkeypatch.setenv("QFEDX_GATE_FORM", "flip")
    monkeypatch.setenv("QFEDX_SLAB_LANES", "matmul")
    monkeypatch.setattr(rfuse, "_gather_ok", lambda: True)
    monkeypatch.setattr(rfuse, "_growmat_merge_ok", lambda: True)


@pytest.fixture
def bf16(monkeypatch):
    monkeypatch.setenv("QFEDX_DTYPE", "bf16")


def _f32(x):
    """A bf16 (or f32) array of either package as an f32 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _rel(got, want) -> float:
    got = [np.asarray(g, np.float64) for g in got]
    want = [np.asarray(w, np.float64) for w in want]
    num = sum(float(np.sum((g - w) ** 2)) for g, w in zip(got, want))
    den = sum(float(np.sum(w ** 2)) for w in want)
    assert den > 0
    return float(np.sqrt(num / den))


def _pair(re, im, dtype=None):
    """Numpy f32 (re, im) → (reference CArray, port CArray), cast to
    bf16 by each package when ``dtype`` is "bf16"."""
    def j(a):
        a = jnp.asarray(a)
        return a.astype(jnp.bfloat16) if dtype == "bf16" else a

    def t(a):
        a = torch.as_tensor(a)
        return a.to(torch.bfloat16) if dtype == "bf16" else a

    return (JC(j(re), None if im is None else j(im)),
            TC(t(re), None if im is None else t(im)))


def _state(n, seed, tb=TB):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(tb, 1 << n)) + 1j * rng.normal(size=(tb, 1 << n))
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return _pair(x.real.astype(np.float32), x.imag.astype(np.float32),
                 "bf16")


def _unitary(rng, lead, d, real=False):
    z = rng.normal(size=lead + (d, d))
    if not real:
        z = z + 1j * rng.normal(size=lead + (d, d))
    q, r = np.linalg.qr(z)
    dg = np.diagonal(r, axis1=-2, axis2=-1)
    q = q * (dg / np.abs(dg))[..., None, :]
    return q.real.astype(np.float32), (
        None if real else q.imag.astype(np.float32))


def _close_c(ref, out, atol=EXEC_ATOL):
    """Both packages' states carry bf16 and agree within ``atol``."""
    assert out.re.dtype == torch.bfloat16
    assert ref.re.dtype == jnp.bfloat16
    np.testing.assert_allclose(_f32(out.re), _f32(ref.re), atol=atol, rtol=0)
    ref_im = np.zeros(ref.re.shape, np.float32) if ref.im is None else _f32(
        ref.im)
    out_im = np.zeros(out.re.shape, np.float32) if out.im is None else _f32(
        out.im)
    np.testing.assert_allclose(out_im, ref_im, atol=atol, rtol=0)


# --- the pin -----------------------------------------------------------------


@pytest.mark.parametrize("value", [None, "float32", "bf16", "bfloat16",
                                   "BF16", "f16"])
def test_state_dtype_pin_grammar(monkeypatch, value):
    """QFEDX_DTYPE reads as the reference reads it: bf16 or bfloat16 give
    bf16 states, anything else (unset included) f32; RDTYPE stays f32."""
    if value is None:
        monkeypatch.delenv("QFEDX_DTYPE", raising=False)
    else:
        monkeypatch.setenv("QFEDX_DTYPE", value)
    want = rcpx.state_dtype()
    got = cpx.state_dtype()
    assert str(got).replace("torch.", "") == jnp.dtype(want).name
    assert (got == torch.bfloat16) == (value in ("bf16", "bfloat16"))
    assert cpx.RDTYPE == torch.float32


def test_angle_amplitudes_round_like_the_reference(bf16):
    """cos/sin of the f32 half angles, then the cast: the same bf16
    amplitudes, bit for bit, in every basis."""
    from qfedx_tpu.circuits.encoders import angle_amplitudes as rangle

    th = np.random.default_rng(1).uniform(0, np.pi, (TB, 12)).astype(
        np.float32)
    for basis in ("ry", "rx", "rz"):
        ref = rangle(jnp.asarray(th), basis)
        out = angle_amplitudes(torch.as_tensor(th), basis)
        _close_c(ref, out, atol=0)


# --- the executors -----------------------------------------------------------


def _phases(rng, shape):
    th = rng.uniform(-np.pi, np.pi, size=shape)
    return np.cos(th).astype(np.float32), np.sin(th).astype(np.float32)


def _rowpair(rng, n, lead):
    re, im = _unitary(rng, lead, 4)
    shp = lead + (2, 2, 2, 2)
    return re.reshape(shp), im.reshape(shp)


EXECUTORS = {
    "gate_row": (
        lambda rng, n, lead: _unitary(rng, lead, 2),
        lambda m, s, n, c: m.apply_gate_b(s, n, c, 1),
    ),
    "gate_lane": (
        lambda rng, n, lead: _unitary(rng, lead, 2),
        lambda m, s, n, c: m.apply_gate_b(s, n, c, n - 2),
    ),
    "lane": (
        lambda rng, n, lead: _unitary(rng, lead, 128),
        lambda m, s, n, c: m.apply_lane_matrix_b(s, n, c),
    ),
    "rowmat": (
        lambda rng, n, lead: _unitary(rng, lead, 1 << (n - 7)),
        lambda m, s, n, c: m.apply_row_matrix_b(s, n, c),
    ),
    "glane": (
        lambda rng, n, lead: _unitary(rng, lead + (2,), 128),
        lambda m, s, n, c: m.apply_lane_matrix_ctrl_b(s, n, c, 1),
    ),
    "growmat": (
        lambda rng, n, lead: _unitary(rng, lead + (2,), 1 << (n - 7)),
        lambda m, s, n, c: m.apply_row_matrix_ctrl_b(s, n, c, n - 3),
    ),
    "rowpair": (
        _rowpair,
        lambda m, s, n, c: m.apply_rowpair_b(s, n, c, 0, 2),
    ),
    "mask": (
        lambda rng, n, lead: _phases(rng, lead + (1 << n,)),
        lambda m, s, n, c: m.apply_phase_mask_b(s, n, c),
    ),
}


@pytest.mark.parametrize("grouped", [False, True], ids=["G1", "Gtb"])
@pytest.mark.parametrize("n", [10, 12])
@pytest.mark.parametrize("case", sorted(EXECUTORS))
def test_executor_parity_bf16(case, n, grouped):
    """Every batched executor the scan route runs, on bf16 states with f32
    coefficients (each package casts them where it applies them)."""
    build, call = EXECUTORS[case]
    rng = np.random.default_rng([sorted(EXECUTORS).index(case), n, grouped])
    rstate, ostate = _state(n, seed=int(rng.integers(1 << 30)))
    rc, oc = _pair(*build(rng, n, (TB,) if grouped else ()))
    ref = jax.jit(lambda st, c: call(rbt, st, n, c))(rstate, rc)
    _close_c(ref, call(bt, ostate, n, oc))


@pytest.mark.parametrize("n", [10, 12])
@pytest.mark.parametrize(
    "ctrl_tgt", [(0, 1), (9, 8), (1, 9), (9, 1)],
    ids=["row-row", "lane-lane", "rowc-lanet", "lanec-rowt"],
)
def test_cnot_and_rowperm_are_exact_in_bf16(n, ctrl_tgt):
    rstate, ostate = _state(n, seed=n)
    _close_c(rbt.apply_cnot_b(rstate, n, *ctrl_tgt),
             bt.apply_cnot_b(ostate, n, *ctrl_tgt), atol=0)
    perm = np.random.default_rng(n).permutation(1 << (n - 7))
    _close_c(rbt.apply_row_perm_b(rstate, n, perm),
             bt.apply_row_perm_b(ostate, n, perm), atol=0)


@pytest.mark.parametrize("basis_im", [False, True], ids=["real", "complex"])
@pytest.mark.parametrize("n", [10, 12])
def test_product_state_bf16(n, basis_im):
    rng = np.random.default_rng(n)
    th = rng.uniform(0, np.pi, (TB, n)).astype(np.float32)
    re = np.stack([np.cos(th / 2), np.sin(th / 2)], -1).astype(np.float32)
    im = (np.stack([np.zeros_like(th), -np.sin(th / 2)], -1).astype(
        np.float32) if basis_im else None)
    ramps, oamps = _pair(re, im, "bf16")
    ref = rbt.bstate_product_tree(ramps)
    _close_c(ref, bt.bstate_product_tree(oamps))
    _close_c(rbt.bstate_product(ramps), bt.bstate_product(oamps))


@pytest.mark.parametrize("n", [10, 12])
def test_expect_z_reads_bf16_states_in_f32(n):
    rstate, ostate = _state(n, seed=5)
    got = bt.expect_z_all_b(ostate, n)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(
        got.numpy(), np.asarray(rbt.expect_z_all_b(rstate, n)), atol=1e-5,
        rtol=0)


# --- the kernel's plain version ----------------------------------------------


def _kinds_programs(n, length, groups, seed):
    """Every kernel emission and all four CNOT placements (the program of
    tests/test_torch_scan_body.py), f32 coefficients for both packages."""
    rng = np.random.default_rng(seed)
    r = 1 << (n - 7)
    lead = (length,) + (() if groups is None else (groups,))

    def pair4(c):
        return tuple(x.reshape(lead + (2, 2, 2, 2)) for x in c)

    spec = [
        ("lane", (), _unitary(rng, lead, 128)),
        ("mask", (), _phases(rng, lead + (1 << n,))),
        ("growmat", (n - 2,), _unitary(rng, lead + (2,), r)),
        ("rowpair", (0, 2), pair4(_unitary(rng, lead, 4))),
        ("rowperm", (), rng.permutation(r)),
        ("glane", (1,), _unitary(rng, lead + (2,), 128)),
        ("rowmat", (), _unitary(rng, lead, r)),
        ("cnot", (0, 1), None),
        ("cnot", (n - 5, n - 2), None),
        ("cnot", (2, n - 1), None),
        ("cnot", (n - 1, 2), None),
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
                body.append(mod.StackedOp(kind, qubits, _pair(*c)[side],
                                          True))
        progs.append(mod.ScanProgram((), tuple(body), length))
    return progs


def _hea_programs(n, length, groups, seed):
    rng = np.random.default_rng(seed)
    shape = (length, n) if groups is None else (length, groups, n)
    rx = rng.uniform(-2, 2, shape).astype(np.float32)
    rz = rng.uniform(-2, 2, shape).astype(np.float32)
    return (
        rfuse.fuse_ops_stacked(
            ransatz.hea_scan_ops(n, jnp.asarray(rx), jnp.asarray(rz)), n,
            length),
        fuse.fuse_ops_stacked(
            ansatz.hea_scan_ops(n, torch.as_tensor(rx), torch.as_tensor(rz)),
            n, length),
    )


def _kernel_inputs(n, rprog, oprog, seed):
    """Both packages' kernel inputs (pre-ops applied): (spec, packed bf16
    state, xs) for the reference and the port."""
    rstate, ostate = _state(n, seed=seed)
    out = []
    for mod, prog, st, stack in (
        (rpb, rprog, rstate, jnp.stack), (scan_body, oprog, ostate,
                                          torch.stack)
    ):
        st = type(st)(st.re, st.imag_or_zeros())
        exec_ = rfuse._exec_stacked if mod is rpb else fuse._exec_stacked
        for op in prog.pre:
            st = exec_(st, n, op, True)
        assert mod.route_ok(st, n, prog, True)
        spec = mod._build_spec(st, n, prog, True)
        r = 1 << (n - 7)
        packed = stack([st.re.reshape(TB, r, 128), st.im.reshape(TB, r, 128)])
        out.append((spec, packed, tuple(op.coeffs for op in prog.body
                                        if op.stacked)))
    return out


PLAIN_CASES = [(n, g) for n in (10, 12, 15) for g in (None, 2)]


@pytest.mark.parametrize("n,groups", PLAIN_CASES,
                         ids=[f"n{n}-G{g or 1}" for n, g in PLAIN_CASES])
def test_plain_sweep_matches_reference_kernel_bf16(n, groups):
    """``scan_body_plain`` in bf16 — Launch A, Launch B (final state and
    every layer-entry boundary) and Launch C (the adjointed program with a
    bf16 cotangent as the state) — equal to the reference's interpreted
    ``_run`` on the same bf16 inputs."""
    rprog, oprog = _kinds_programs(n, 2, groups, seed=40 + n)
    (rspec, rpacked, rxs), (ospec, opacked, oxs) = _kernel_inputs(
        n, rprog, oprog, seed=n)
    assert ospec.dtype == "bfloat16" and opacked.dtype == torch.bfloat16
    rfinal, rbnd = _ref_run(rspec, rpacked, rxs, True)
    final, bnd = scan_body.scan_body(opacked, ospec, oxs,
                                     with_boundaries=True)
    assert final.dtype == bnd.dtype == torch.bfloat16
    assert tuple(bnd.shape) == tuple(rbnd.shape)
    np.testing.assert_array_equal(_f32(final), _f32(rfinal))
    np.testing.assert_array_equal(_f32(bnd), _f32(rbnd))
    assert torch.equal(scan_body.scan_body(opacked, ospec, oxs), final)
    rcot, ocot = _state(n, seed=n + 100)
    rcot = jnp.stack([rcot.re, rcot.im]).reshape(rpacked.shape)
    ocot = torch.stack([ocot.re, ocot.im]).reshape(opacked.shape)
    rstate_cot, rcbnd = _ref_run(rpb._adjoint_spec(rspec), rcot,
                                 rpb._adjoint_xs(rspec, rxs), True)
    state_cot, cbnd = scan_body.scan_body(
        ocot, scan_body._adjoint_spec(ospec),
        scan_body._adjoint_xs(ospec, oxs), with_boundaries=True,
        adjoint=True)
    np.testing.assert_array_equal(_f32(state_cot), _f32(rstate_cot))
    np.testing.assert_array_equal(_f32(cbnd), _f32(rcbnd))


def test_plain_sweep_matches_reference_kernel_bf16_hea():
    """The served body (n=12, L=3, glane + growmat, hoisted rowmat) with
    per-client groups (G=2): the main path's program. On the reference's
    coefficients the plain sweep equals the interpreted kernel; on the
    port's own program build it agrees within SWEEP_RTOL."""
    rprog, oprog = _hea_programs(12, 3, 2, seed=12)
    (rspec, rpacked, rxs), (ospec, opacked, oxs) = _kernel_inputs(
        12, rprog, oprog, seed=3)
    want = jax.jit(rpb._pallas_scan, static_argnums=0)(rspec, rpacked, rxs)
    same = tuple(TC(*(None if p is None else torch.tensor(np.asarray(p))
                      for p in (c.re, c.im))) for c in rxs)
    np.testing.assert_array_equal(
        _f32(scan_body.scan_body(opacked, ospec, same)), _f32(want))
    got = scan_body.scan_body(opacked, ospec, oxs)
    assert _rel([_f32(got)], [_f32(want)]) <= SWEEP_RTOL


@pytest.mark.parametrize("groups", [None, 2], ids=["G1", "G2"])
def test_function_grads_match_reference_bf16(groups):
    """``ScanBodyFn``'s state and coefficient cotangents (a bf16
    cotangent through Launch C, f32 coefficient cotangents back through
    the cast) ≡ ``jax.grad`` through the reference's ``_pallas_scan`` in
    bf16: the state cotangent equal, the coefficient cotangents within
    BF16_GRAD_RTOL."""
    n = 10
    rprog, oprog = _kinds_programs(n, 2, groups, seed=7)
    (rspec, rpacked, rxs), (ospec, opacked, oxs) = _kernel_inputs(
        n, rprog, oprog, seed=8)
    w = np.random.default_rng(9).normal(size=tuple(opacked.shape)).astype(
        np.float32)

    def loss(packed, xs):
        out = rpb._pallas_scan(rspec, packed, xs).astype(jnp.float32)
        return jnp.sum(jnp.asarray(w) * out ** 2)

    rg_state, rg_xs = jax.jit(jax.grad(loss, argnums=(0, 1)))(rpacked,
                                                               rxs)
    rflat = [p for c in rg_xs for p in (c.re, c.im) if p is not None]
    packed = opacked.clone().requires_grad_(True)
    flat = [p.clone().requires_grad_(True) for p in scan_body._flatten(oxs)]
    out = scan_body.ScanBodyFn.apply(ospec, packed, *flat)
    g_state, *g_flat = torch.autograd.grad(
        (torch.as_tensor(w) * out.float() ** 2).sum(), [packed] + flat)
    assert g_state.dtype == torch.bfloat16
    assert all(g.dtype == torch.float32 for g in g_flat)
    np.testing.assert_array_equal(_f32(g_state), _f32(rg_state))
    assert len(g_flat) == len(rflat)
    for g, r in zip(g_flat, rflat):
        assert tuple(g.shape) == tuple(r.shape)
    assert _rel([g.numpy() for g in g_flat],
                [np.asarray(r) for r in rflat]) <= BF16_GRAD_RTOL


# --- the wrapper and the launch configuration --------------------------------


def _spec_of(n, tb, dtype):
    q = {"glane": (1,), "growmat": (n - 2,)}
    ops = tuple(scan_body._OpSpec(k, q[k], True, 1, True, None)
                for k in ("glane", "growmat"))
    return scan_body._KernelSpec(n=n, length=3, tb=tb, batched=True,
                                 ops=ops, dtype=dtype)


@pytest.mark.parametrize("tb", [1, 8, 32, 128, 256])
@pytest.mark.parametrize("n", [10, 12, 15, 17, 18])
def test_launch_config_bf16(n, tb, monkeypatch):
    """The bf16 instance's configuration, a pure function of the spec:
    the same instance and K as f32 (the shared-memory state is f32 in
    both), a ring of 8 KB units (16-row bf16 slabs, re and im) beside a
    bf16 copy of the CTA's rows, so more shared memory than f32 at some
    shapes, but still one CTA per SM as f32, which ``_RESIDENT``
    assumes; the dtype names the instance."""
    def no_cuda(*a, **k):
        raise AssertionError("_launch_config touched the card")

    monkeypatch.setattr(scan_body, "load_kernel", no_cuda)
    monkeypatch.setattr(torch.cuda, "is_available", no_cuda)
    scan_body._launch_config.cache_clear()
    cfg = scan_body._launch_config(_spec_of(n, tb, "bfloat16"))
    ref = scan_body._launch_config(_spec_of(n, tb, "float32"))
    assert cfg.dtype == "bfloat16" and ref.dtype == "float32"
    assert (cfg.instance, cfg.cluster) == (ref.instance, ref.cluster)
    assert (cfg.instance == "cluster") == (n <= 17)
    if cfg.instance == "cluster":
        rows = (1 << (n - 7)) // cfg.cluster
        # f32 rows, their bf16 copy at 272 B a row, the descriptors
        fixed = 16 * rows * 128 + 2 * rows * 272 + 2 * 8 * 4
        units, rest = divmod(cfg.smem - fixed, 8192)
        assert rest == 0 and 4 <= units <= 16
        assert units == 16 or cfg.smem + 8192 > 232_448
        assert cfg.products == "mma"
        # one CTA per SM in both dtypes: two never share an SM's 228 KB
        assert cfg.smem <= 232_448 and ref.smem <= 232_448
        assert 2 * cfg.smem > 232_448 and 2 * ref.smem > 232_448
    else:
        assert (cfg.cluster, cfg.smem) == (1, 0)
        assert cfg.products == "ffma"


@pytest.mark.parametrize("tb", [1, 8, 16, 32, 64, 128, 256])
@pytest.mark.parametrize("n", list(range(10, 18)))
def test_launch_config_bf16_tensor_cores(n, tb, monkeypatch):
    """Every bf16 cluster launch (n = 10-17) runs its lane and row
    products on the tensor cores, chosen from the spec alone: K and rows
    per CTA as f32, up to 16 ring units of 8192 B with the bf16 copy of
    the CTA's rows (272 B a row) before the descriptors; the C entries'
    codes tell the f32 and bf16 instances apart."""
    def no_cuda(*a, **k):
        raise AssertionError("_launch_config touched the card")

    monkeypatch.setattr(scan_body, "load_kernel", no_cuda)
    monkeypatch.setattr(torch.cuda, "is_available", no_cuda)
    scan_body._launch_config.cache_clear()
    spec = _spec_of(n, tb, "bfloat16")
    cfg = scan_body._launch_config(spec)
    f32 = scan_body._launch_config(_spec_of(n, tb, "float32"))
    assert (cfg.instance, cfg.cluster, cfg.products) == (
        "cluster", f32.cluster, "mma")
    rk = (1 << (n - 7)) // cfg.cluster
    assert rk in (1, 2, 4, 8, 16, 32, 64)
    fixed = 16 * rk * 128 + 2 * rk * 272 + 2 * 8 * 4
    units = min(16, (232_448 - fixed) // 8192)
    assert cfg.smem == scan_body._cluster_smem(spec, cfg.cluster) == (
        fixed + units * 8192)
    assert 4 <= units
    if rk <= 32:  # both glane branches' eight slabs in flight at once
        assert units == 16
    assert [scan_body._DTYPE_CODE[c.dtype] for c in (f32, cfg)] == [0, 1]


def test_ring_swizzle_is_the_kernels_layout():
    """``_ring_swizzle`` stores element (j, k) of every lane matrix at
    j*128 + ((k/8) ^ (j mod 8))*8 + k mod 8 (the address the tensor-core
    instance's ldmatrix reads), is its own inverse, and the packing
    applies it to lane and glane matrices only, in the tensor-core
    instance only."""
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(3, 2, 128, 128)),
                        dtype=torch.float32)
    y = scan_body._ring_swizzle(x)
    j, k = np.meshgrid(np.arange(128), np.arange(128), indexing="ij")
    flat = (j * 128 + ((k // 8) ^ (j % 8)) * 8 + k % 8).reshape(-1)
    assert torch.equal(y.reshape(6, -1)[:, flat], x.reshape(6, -1))
    assert torch.equal(scan_body._ring_swizzle(y), x)
    _, oprog = _hea_programs(12, 3, None, seed=1)
    (_, _, _), (spec, _, xs) = _kernel_inputs(
        12, _hea_programs(12, 3, None, seed=1)[0], oprog, seed=2)
    plain = scan_body._pack_coeffs(spec, xs)
    swz = scan_body._pack_coeffs(spec, xs, swizzle=True)
    want = []
    for op, c in zip([op for op in spec.ops if op.stacked], xs):
        for p in (c.re, c.im):
            p = p.to(torch.bfloat16)
            if op.kind in ("lane", "glane"):
                p = scan_body._ring_swizzle(p)
            want.append(p.reshape(-1))
    assert torch.equal(swz, torch.cat(want))
    assert not torch.equal(swz, plain)
    assert torch.equal(torch.sort(swz.float())[0],
                       torch.sort(plain.float())[0])


def test_swizzle_index_is_built_once_per_spec():
    """The tensor-core packing's gather index is cached per (spec,
    device), so a launch pays one gather and no index build; it is the
    identity outside the lane and glane matrices and an involution."""
    _, oprog = _hea_programs(12, 3, None, seed=1)
    (_, _, _), (spec, _, xs) = _kernel_inputs(
        12, _hea_programs(12, 3, None, seed=1)[0], oprog, seed=2)
    scan_body._swizzle_index.cache_clear()
    cpu = torch.device("cpu")
    idx = scan_body._swizzle_index(spec, cpu)
    assert scan_body._swizzle_index(spec, cpu) is idx
    total = scan_body._layout(spec)[1]
    assert idx.dtype == torch.int32 and idx.shape == (total,)
    ident = torch.arange(total, dtype=torch.int32)
    assert torch.equal(idx[idx.long()], ident)
    moved = torch.zeros(total, dtype=torch.bool)
    desc = scan_body._layout(spec)[0]
    for op, row in zip(spec.ops, desc):
        if op.stacked and op.kind in ("lane", "glane"):
            block = spec.length * op.groups * int(row[6])
            for off in (int(row[3]), int(row[4])):
                if off >= 0:
                    moved[off:off + block] = True
    assert moved.any() and not moved.all()
    assert torch.equal(idx[~moved], ident[~moved])
    assert not torch.equal(idx[moved], ident[moved])
    flat = scan_body._pack_coeffs(spec, xs)
    assert torch.equal(flat.index_select(0, idx),
                       scan_body._pack_coeffs(spec, xs, swizzle=True))


def test_wrapper_dtype_contract():
    """A bf16 state runs with a bf16 spec only, coefficients come f32 or
    bf16 and pack as bf16 (rounded as the reference's ``_coeff_operands``
    casts), and the CPU takes the plain version without a launch."""
    _, oprog = _hea_programs(12, 3, None, seed=1)
    (_, _, _), (spec, packed, xs) = _kernel_inputs(
        12, _hea_programs(12, 3, None, seed=1)[0], oprog, seed=2)
    assert spec.dtype == "bfloat16"
    coeffs = scan_body._pack_coeffs(spec, xs)
    assert coeffs.dtype == torch.bfloat16
    want = torch.cat([p.reshape(-1) for p in scan_body._flatten(xs)])
    assert torch.equal(coeffs, want.to(torch.bfloat16))
    with pytest.raises(TypeError, match="bfloat16 spec"):
        scan_body.scan_body(packed.float(), spec, xs)
    with pytest.raises(TypeError, match="float32 spec"):
        scan_body.scan_body(packed, spec._replace(dtype="float32"), xs)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        scan_body.scan_body(packed.half(), spec, xs)
    bf_xs = tuple(TC(c.re.to(torch.bfloat16), c.im.to(torch.bfloat16))
                  for c in xs)
    before = dict(scan_body.dtype_counts)
    assert torch.equal(scan_body.scan_body(packed, spec, bf_xs),
                       scan_body.scan_body(packed, spec, xs))
    assert scan_body.dtype_counts == before
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        scan_body.scan_body(packed, spec, tuple(
            TC(c.re.half(), c.im.half()) for c in xs))
    with pytest.raises(TypeError, match="bfloat16 launch"):
        scan_body.prepare_launch(packed.float(), spec, xs)


# --- the model ---------------------------------------------------------------


def _ref_params(model, seed, scale):
    p = model.init(jax.random.PRNGKey(seed))
    return jax.tree.map(lambda a: np.asarray(a) * scale, p)


def _features(n, batch, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (batch, n)).astype(
        np.float32)


@pytest.mark.parametrize("n", [12, 15])
def test_logits_match_reference_bf16(monkeypatch, bf16, n):
    """The served model (n=12, L=3; and n=15, rowpairs) in bf16: logits
    f32, within BF16_LOGIT_ATOL of the reference's interpreted kernel route;
    the port's bf16 logits within the reference's own bf16-vs-f32 bound
    of its f32 ones."""
    layers = 3
    ref = ref_make(n, layers, 2)
    params = _ref_params(ref, seed=n, scale=10.0)
    x = _features(n, 8)
    want = np.asarray(jax.jit(ref.apply)(params, x))
    model = make_vqc_classifier(n, layers, 2, device="cpu")
    p = params_from_jax(params, device="cpu")
    got = model.apply(p, x)
    assert got.dtype == torch.float32 and tuple(got.shape) == (8, 2)
    np.testing.assert_allclose(got.numpy(), want, atol=BF16_LOGIT_ATOL,
                               rtol=0)
    monkeypatch.delenv("QFEDX_DTYPE")
    f32 = model.apply(p, x)
    np.testing.assert_allclose(got.numpy(), f32.numpy(), atol=REF_Z_ATOL,
                               rtol=0)
    assert not torch.equal(got, f32)  # the pin really changed the route


N_FOLD, L_FOLD, C_FOLD = 10, 3, 2


def _ref_client_params(seed=5):
    ref = ref_make(N_FOLD, L_FOLD, 2)
    p = _ref_params(ref, seed=seed, scale=10.0)
    rng = np.random.default_rng(seed)
    return ref, jax.tree.map(
        lambda a: (a[None] + 0.3 * rng.normal(size=(C_FOLD,) + a.shape))
        .astype(np.float32), p,
    )


def test_folded_logits_and_grads_match_reference_bf16(monkeypatch, bf16):
    """``apply_clients`` in bf16 (the folded local step: Launch B forward,
    Launch C and the coefficient cotangents backward): logits within
    BF16_LOGIT_ATOL and every leaf's gradient of Σ_c mean-CE_c within
    BF16_GRAD_RTOL of the reference's ``jax.grad`` in bf16; against the
    port's own f32 run, within the reference's bf16-vs-f32 bounds."""
    ref, cparams = _ref_client_params()
    x = _features(N_FOLD, C_FOLD * 4, 6).reshape(C_FOLD, 4, N_FOLD)
    y = np.random.default_rng(6).integers(0, 2, (C_FOLD, 4)).astype(np.int32)

    def ref_loss(cp):
        ce = optax.softmax_cross_entropy_with_integer_labels(
            ref.apply_clients(cp, x), jnp.asarray(y))
        return jnp.sum(jnp.mean(ce, axis=1))

    want_logits = np.asarray(jax.jit(ref.apply_clients)(cparams, x))
    want = jax.jit(jax.grad(ref_loss))(cparams)
    model = make_vqc_classifier(N_FOLD, L_FOLD, 2, device="cpu")

    def port(cp):
        leaves = {g: {k: v.requires_grad_(True) for k, v in d.items()}
                  for g, d in params_from_jax(cp, device="cpu").items()}
        logits = model.apply_clients(leaves, x)
        _cross_entropy(logits, torch.as_tensor(y)).mean(dim=1).sum(
        ).backward()
        return logits.detach(), {g: {k: v.grad for k, v in d.items()}
                                 for g, d in leaves.items()}

    logits, grads = port(cparams)
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), want_logits,
                               atol=BF16_LOGIT_ATOL, rtol=0)
    for g, d in grads.items():
        for k, v in d.items():
            assert v.dtype == torch.float32
            assert _rel([v.numpy()], [np.asarray(want[g][k])]) <= (
                BF16_GRAD_RTOL), f"{g}/{k}"
    monkeypatch.delenv("QFEDX_DTYPE")
    f32_logits, f32_grads = port(cparams)
    np.testing.assert_allclose(logits.numpy(), f32_logits.numpy(),
                               atol=REF_Z_ATOL, rtol=0)
    for g, d in grads.items():
        for k, v in d.items():
            assert _rel([v.numpy()], [f32_grads[g][k].numpy()]) <= (
                REF_GRAD_RTOL), f"{g}/{k}"


# --- federated rounds and the trainer ----------------------------------------

N, L, C, S, BATCH = 10, 2, 2, 8, 4


def _fed_data(seed=0):
    rng = np.random.default_rng(seed)
    cx = rng.uniform(0, 1, (C, S, N)).astype(np.float32)
    cy = rng.integers(0, 2, (C, S)).astype(np.int32)
    cm = np.ones((C, S), np.float32)
    tx = rng.uniform(0, 1, (20, N)).astype(np.float32)
    ty = rng.integers(0, 2, 20).astype(np.int32)
    return cx, cy, cm, tx, ty


def _ref_perms(round_key):
    """The (C, 1, S) shuffles the reference's folded local update draws
    from ``round_key`` (one epoch)."""
    train_key = jax.random.fold_in(round_key, TRAIN_KEY_SALT)
    out = []
    for cid in range(C):
        ekey = jax.random.split(jax.random.fold_in(train_key, cid), 1)[0]
        out.append([np.asarray(jax.random.permutation(
            jax.random.split(ekey)[0], S))])
    return torch.as_tensor(np.asarray(out), dtype=torch.int64)


def _delta_rel(after, before, want_after):
    """Relative norm of the port's θ update against the reference's."""
    got = [np.asarray(a) - np.asarray(b) for a, b in zip(after, before)]
    want = [np.asarray(a) - np.asarray(b) for a, b in zip(want_after,
                                                           before)]
    return _rel(got, want)


def test_sgd_round_matches_reference_bf16(monkeypatch, bf16):
    """One SGD-momentum round in bf16 from the same θ, data and shuffles:
    the θ update within BF16_GRAD_RTOL of the reference's (relative
    norm), the mean loss within BF16_LOSS_ATOL, the counts exactly; θ stays
    f32. The reference runs its ``lax.scan`` route, which agrees with its
    interpreted kernel in bf16 at n=10."""
    cfg_kwargs = dict(learning_rate=0.1, momentum=0.9)
    cx, cy, cm, _, _ = _fed_data()
    model = ref_make(N, L, 2)
    init = _ref_params(model, seed=0, scale=10.0)
    mesh = client_mesh(num_devices=1)
    monkeypatch.setenv("QFEDX_PALLAS", "0")
    rf = ref_make_round(model, RFedConfig(local_epochs=1, batch_size=BATCH,
                                          **cfg_kwargs), mesh, num_clients=C)
    key = jax.random.PRNGKey(100)
    want, wstats = rf(init, *shard_client_data(
        mesh, jnp.asarray(cx), jnp.asarray(cy), jnp.asarray(cm)), key, None)
    monkeypatch.setenv("QFEDX_PALLAS", "1")
    pmodel = make_vqc_classifier(N, L, 2, device="cpu")
    rf_port = make_fed_round(pmodel, FedConfig(local_epochs=1,
                                               batch_size=BATCH,
                                               **cfg_kwargs), num_clients=C)
    got, gstats = rf_port(params_from_jax(init, device="cpu"),
                          *(torch.as_tensor(a) for a in (cx, cy, cm)),
                          perms=_ref_perms(key))
    leaves = trees.tree_leaves(got)
    assert all(v.dtype == torch.float32 for v in leaves)
    assert _delta_rel([v.numpy() for v in leaves], jax.tree.leaves(init),
                      jax.tree.leaves(want)) <= BF16_GRAD_RTOL
    assert abs(float(gstats.mean_loss) - float(wstats.mean_loss)) <= (
        BF16_LOSS_ATOL)
    assert float(gstats.total_weight) == float(wstats.total_weight)
    for field in ("num_participants", "rejected_updates", "applied"):
        assert float(getattr(gstats, field)) == float(getattr(wstats, field))


_CFG = dict(local_epochs=1, batch_size=BATCH, learning_rate=0.1,
            momentum=0.9, optimizer="sgd")
SEED = 5


def test_trainer_rows_match_reference_bf16(monkeypatch, bf16):
    """``train_federated`` in bf16, two rounds from the reference's init
    with its shuffles injected: per-round loss within BF16_LOSS_ATOL,
    accuracy within one evaluation sample, AUC within one ranked pair,
    the θ update within BF16_GRAD_RTOL (relative norm)."""
    monkeypatch.setenv("QFEDX_PALLAS", "0")
    model = ref_make(N, L, 2)
    rows = []
    res = ref_train(
        model, RFedConfig(**_CFG), *_fed_data(), num_rounds=2, seed=SEED,
        mesh=client_mesh(num_devices=1), rounds_per_call=1,
        on_round_end=lambda r, m: rows.append(dict(m)),
    )
    init_key, base = jax.random.split(jax.random.PRNGKey(SEED))
    init = jax.tree.map(np.asarray, model.init(init_key))
    perms = [_ref_perms(jax.random.fold_in(base, r)) for r in range(2)]
    monkeypatch.setenv("QFEDX_PALLAS", "1")
    got_rows = []
    got = train_federated(
        make_vqc_classifier(N, L, 2, device="cpu"), FedConfig(**_CFG),
        *_fed_data(), num_rounds=2, seed=SEED, rounds_per_call=1,
        on_round_end=lambda r, m: got_rows.append(dict(m)),
        params=params_from_jax(init, device="cpu"),
        perms_for_round=lambda r: perms[r],
    )
    assert [r["round"] for r in got_rows] == [r["round"] for r in rows]
    ty = _fed_data()[4]
    pairs = int(ty.sum()) * int((1 - ty).sum())  # one swap moves AUC 1/pairs
    for g, w in zip(got_rows, rows):
        assert w["n"] == len(ty)
        assert abs(g["loss"] - w["loss"]) <= BF16_LOSS_ATOL
        assert abs(g["accuracy"] - w["accuracy"]) <= 1.0 / w["n"] + 1e-12
        assert abs(g["auc"] - w["auc"]) <= 1.0 / pairs + 1e-12
        assert set(g) == set(w)
    assert _delta_rel([v.numpy() for v in trees.tree_leaves(got.params)],
                      jax.tree.leaves(init),
                      jax.tree.leaves(jax.tree.map(np.asarray, res.params))
                      ) <= BF16_GRAD_RTOL


def test_cli_bf16_run_restores_in_reference(monkeypatch, bf16, tmp_path):
    """``train`` then ``serve --run-dir`` under bf16 on the CPU: schema-1
    rows, f32 checkpoints in the reference's format that the reference
    restores bit for bit, a route that reports bfloat16, and served
    logits equal to the restored model's."""
    from qfedx_tpu.run import metrics as rmetrics

    monkeypatch.setattr(pcli, "DataConfig", functools.partial(
        pconfig.DataConfig, synthetic_train=256, synthetic_test=128))
    argv = ["train", "--model", "vqc", "--qubits", str(N), "--layers",
            str(L), "--classes", "0,1", "--clients", "2", "--rounds", "2",
            "--local-epochs", "1", "--checkpoint-every", "1", "--lr", "0.1",
            "--run-root", str(tmp_path), "--name", "cli"]
    pcli.main(argv, device="cpu")
    run = tmp_path / "cli"
    for line in (run / "metrics.jsonl").read_text().splitlines():
        row = rmetrics.validate_metrics_record(json.loads(line))
        assert np.isfinite(row["loss"])
    template = make_vqc_classifier(N, L, 2, device="cpu").init(0)
    theta, r = pckpt.Checkpointer(run / "checkpoints").restore_latest(
        template)
    assert r == 2
    assert all(v.dtype == torch.float32 for v in trees.tree_leaves(theta))
    jtemplate = jax.tree.map(lambda t: jnp.asarray(t.numpy()), template,
                             is_leaf=lambda t: isinstance(t, torch.Tensor))
    got = rckpt.Checkpointer(run / "checkpoints", every=1).restore(
        2, jtemplate)
    for a, b in zip(jax.tree.leaves(got), trees.tree_leaves(theta)):
        assert np.asarray(a).dtype == np.float32
        assert np.asarray(a).tobytes() == b.numpy().tobytes()
    x = _features(N, 3)
    (tmp_path / "in.jsonl").write_text(
        "\n".join(json.dumps(v.tolist()) for v in x) + "\n")
    from qfedx_tpu_torch.serve import engine_from_run_dir

    engine, _ = engine_from_run_dir(run, device="cpu")
    assert engine.warmup()["route_resolved"]["dtype"] == "bfloat16"
    served = pcli.main(["serve", "--run-dir", str(run), "--input",
                        str(tmp_path / "in.jsonl"), "--output",
                        str(tmp_path / "out.jsonl"), "--buckets", "1,8"],
                       device="cpu")
    assert served["served"] == 3
    resp = [json.loads(line) for line in
            (tmp_path / "out.jsonl").read_text().splitlines()]
    model = make_vqc_classifier(N, L, 2, device="cpu")
    with torch.no_grad():
        want = model.apply(theta, x).numpy()
    np.testing.assert_allclose(np.array([q["logits"] for q in resp]), want,
                               atol=1e-6, rtol=0)
