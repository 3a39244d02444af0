"""Port vs reference: the dense statevector engine below the slab widths
(qfedx_tpu_torch/ops/{gates,statevector}.py, circuits/encoders.angle_encode
and circuits/readout.z_logits).

The same seeded numpy states, angles and features go through the
reference (one state at a time, ``jax.vmap`` over a batch) and through
the port (the batch a leading state axis). The port has one gate form,
the reference's "flip"; QFEDX_GATE_FORM pins the reference's side:
"dot" (its XLA:CPU form) at n = 2, 4, 6, 8, 9, "flip" at n ≤ 6 with at
most 4 states (the reference records minutes-long XLA:CPU compiles for
flip-form batches, qfedx_tpu/ops/statevector.py:99-117).

Tolerances: f32 amplitudes within 1e-6, and the f32 readouts of either
dtype within 1e-6 (both packages square a bf16 state in bf16 and sum
in f32: the bf16 readings are ≤ 6e-8, while a readout that sums in
bf16 reads 2e-3 to 3e-3 against the reference here). bf16 states by
the relative norm ||port − ref|| / ||ref||: within 1.5e-2 where the
reference runs "dot" gates (its bf16 rounding differs from the flip
form's; readings up to 1.12e-2), and within 1e-3 where both packages
run the same arithmetic (readings 0). The readings print under ``-s``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qfedx_tpu.circuits import encoders as rencoders
from qfedx_tpu.circuits import readout as rreadout
from qfedx_tpu.ops import gates as rgates
from qfedx_tpu.ops import statevector as rsv
from qfedx_tpu.ops.cpx import CArray as RCArray
from qfedx_tpu_torch.circuits import encoders, readout
from qfedx_tpu_torch.ops import gates
from qfedx_tpu_torch.ops import statevector as sv
from qfedx_tpu_torch.ops.cpx import CArray


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these small tensors: the suite runs
    several workers on one CPU, where torch's default pool per worker
    oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


ATOL = 1e-6
BF16_RTOL = 1e-3
BF16_DOT_RTOL = 1.5e-2
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
# (form, n, states): dot at every width, flip small.
CASES = [("dot", n, 4) for n in (2, 4, 6, 8, 9)] + [
    ("flip", n, 3) for n in (2, 4, 6)]


@pytest.fixture(params=CASES, ids=lambda c: f"{c[0]}-n{c[1]}")
def case(request, monkeypatch):
    form, n, b = request.param
    monkeypatch.setenv("QFEDX_GATE_FORM", form)
    return form, n, b


@pytest.fixture(params=sorted(DTYPES))
def dtypes(request):
    return request.param, DTYPES[request.param]


def _state(rng, lead, n):
    shape = tuple(lead) + (2,) * n
    x = rng.normal(size=shape) + 1j * rng.normal(size=shape)
    norm = np.linalg.norm(x.reshape(tuple(lead) + (-1,)), axis=-1)
    return x / norm.reshape(tuple(lead) + (1,) * n)


def _port(x, dt):
    return CArray(torch.tensor(x.real, dtype=dt), torch.tensor(x.imag,
                                                               dtype=dt))


def _ref(x, dt):
    return RCArray(jnp.asarray(x.real, dt), jnp.asarray(x.imag, dt))


def _np(c):
    """CArray (either package) → complex128 numpy."""
    def f(t):
        if t is None:
            return 0.0
        if isinstance(t, torch.Tensor):
            return t.detach().float().numpy().astype(np.float64)
        return np.asarray(t, dtype=np.float64)

    return f(c.re) + 1j * f(c.im)


def _check(got, want, name, dtype_key, bf16_rtol=BF16_RTOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    if dtype_key == "f32":
        err = float(np.abs(got - want).max())
        print(f"{name}: max|port-ref| {err:.3e}")
        assert err <= ATOL, (name, err)
    else:
        rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
        print(f"{name}: ||port-ref||/||ref|| {rel:.3e}")
        assert rel <= bf16_rtol, (name, rel)


# --- gates -------------------------------------------------------------------


@pytest.mark.parametrize("name", ["rx", "rz", "ry", "ry_batched", "rot_zx",
                                  "rz_diag", "cphase_diag", "crz"])
def test_rotations_match_reference(name):
    theta = np.random.default_rng(1).uniform(-3, 3, 5).astype(np.float32)
    for t in ([theta[0]] if name in ("rx", "rz", "ry", "crz") else
              [theta[0], theta]):
        args = (t, 0.5 * t) if name == "rot_zx" else (t,)
        fn = gates.rot_zx_batched if name == "rot_zx" else getattr(gates,
                                                                    name)
        got = fn(*(torch.as_tensor(a) for a in args))
        rfn = rgates.rot_zx_batched if name == "rot_zx" else getattr(rgates,
                                                                     name)
        want = rfn(*(jnp.asarray(a) for a in args))
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-7, rtol=0)


@pytest.mark.parametrize("name", ["CNOT", "CZ", "CZ_DIAG"])
def test_constant_gates_match_reference(name):
    got, want = getattr(gates, name), getattr(rgates, name)
    assert got.im is None and want.im is None
    np.testing.assert_array_equal(got.re.numpy(), np.asarray(want.re))


# --- the engine --------------------------------------------------------------


def test_zero_and_product_state(case, dtypes):
    _, n, b = case
    key, (pdt, rdt) = dtypes
    rng = np.random.default_rng(n)
    z = sv.zero_state(n, (b,), device="cpu")
    assert tuple(z.re.shape) == (b,) + (2,) * n and z.im is None
    np.testing.assert_array_equal(
        z.re[0].float().numpy(), np.asarray(rsv.zero_state(n).re,
                                            dtype=np.float32))
    amps = rng.normal(size=(b, n, 2)) + 1j * rng.normal(size=(b, n, 2))
    got = sv.product_state(_port(amps, pdt))
    want = jax.vmap(rsv.product_state)(_ref(amps, rdt))
    _check(got, want, f"product_state n={n} {key}", key)


def test_gates_on_every_qubit(case, dtypes):
    """A per-state rotation on every qubit in turn, then CNOTs in all
    three axis orders (forward, the ring's wrap, a long jump back) and a
    controlled RZ: each state's own gates (a (B, 2, 2) stack on a
    (B, 2, …, 2) state) against the reference's per-state apply."""
    form, n, b = case
    key, (pdt, rdt) = dtypes
    rng = np.random.default_rng(10 + n)
    x = _state(rng, (b,), n)
    th = rng.uniform(-3, 3, (n, b)).astype(np.float32)
    ph = rng.uniform(-3, 3, (n, b)).astype(np.float32)
    cnots = [(0, 1), (n - 1, 0)] + ([(n - 1, 1)] if n > 2 else [])
    theta = float(rng.uniform(-3, 3))

    def ref_one(s, t, p):
        for q in range(n):
            s = rsv.apply_gate(s, rgates.rot_zx(t[q], p[q]), q)
        rot = s
        for c, tg in cnots:
            s = rsv.apply_cnot(s, c, tg)
        ring = s
        return rot, ring, rsv.apply_gate_2q(s, rgates.crz(theta), n - 1, 0)

    want = jax.jit(jax.vmap(ref_one))(_ref(x, rdt), jnp.asarray(th.T),
                                      jnp.asarray(ph.T))
    rtol = BF16_DOT_RTOL if form == "dot" else BF16_RTOL
    got = _port(x, pdt)
    for q in range(n):
        got = sv.apply_gate(got, gates.rot_zx_batched(
            torch.as_tensor(th[q]), torch.as_tensor(ph[q])), q, n)
        assert got.re.dtype == pdt and got.im.dtype == pdt
    _check(got, want[0], f"{form} rotations n={n} {key}", key, rtol)
    for c, t in cnots:
        got = sv.apply_cnot(got, c, t, n)
        assert got.re.dtype == pdt
    _check(got, want[1], f"{form} CNOTs n={n} {key}", key, rtol)
    got = sv.apply_gate_2q(got, gates.crz(theta), n - 1, 0, n)
    assert got.re.dtype == pdt and got.im.dtype == pdt
    _check(got, want[2], f"{form} crz n={n} {key}", key, rtol)


def test_per_client_gates_meet_their_rows(case):
    """A (C, 2, 2) per-client gate on a (C, B, 2, …, 2) state applies
    client c's gate to client c's rows only: each client's rows against
    the reference's apply with that client's gate (distinct angles)."""
    form, n, b = case
    rng = np.random.default_rng(20 + n)
    clients = 2
    x = _state(rng, (clients, b), n)
    th = rng.uniform(-3, 3, (clients, n)).astype(np.float32)
    ph = rng.uniform(-3, 3, (clients, n)).astype(np.float32)
    got = _port(x, torch.float32)
    for q in range(n):
        got = sv.apply_gate(got, gates.rot_zx_batched(
            torch.as_tensor(th[:, q]), torch.as_tensor(ph[:, q])), q, n)
    got = sv.apply_cnot(got, 0, n - 1, n)
    for c in range(clients):
        want = _ref(x[c], jnp.float32)

        def one(s, c=c):
            for q in range(n):
                s = rsv.apply_gate(s, rgates.rot_zx(th[c, q], ph[c, q]), q)
            return rsv.apply_cnot(s, 0, n - 1)

        want = jax.vmap(one)(want)
        row = CArray(got.re[c], got.im[c])
        _check(row, want, f"{form} client {c} n={n}", "f32")


def test_phase_mask_and_bf16_dtype(case):
    """A phase mask multiplies like the reference's, and a bf16 state
    stays bf16 through it (an f32 mask would promote it)."""
    form, n, b = case
    rng = np.random.default_rng(30 + n)
    x = _state(rng, (b,), n)
    ang = rng.uniform(-3, 3, 1 << n).astype(np.float32)
    mask = CArray(torch.as_tensor(np.cos(ang)), torch.as_tensor(np.sin(ang)))
    rmask = RCArray(jnp.cos(jnp.asarray(ang)), jnp.sin(jnp.asarray(ang)))
    for key, (pdt, rdt) in DTYPES.items():
        got = sv.apply_phase_mask(_port(x, pdt), mask, n)
        want = jax.vmap(lambda s: rsv.apply_phase_mask(s, rmask))(
            _ref(x, rdt))
        assert got.re.dtype == pdt and got.im.dtype == pdt
        _check(got, want, f"{form} mask n={n} {key}", key)


# --- encoder and readouts ----------------------------------------------------


@pytest.mark.parametrize("basis", ["ry", "rx", "rz"])
def test_angle_encode(case, dtypes, basis, monkeypatch):
    _, n, b = case
    key, _ = dtypes
    monkeypatch.setenv("QFEDX_DTYPE", "bf16" if key == "bf16" else "float32")
    f = np.random.default_rng(40 + n).uniform(0, 1, (b, n)).astype(
        np.float32)
    got = encoders.angle_encode(torch.as_tensor(f), basis)
    want = jax.vmap(lambda v: rencoders.angle_encode(v, basis))(
        jnp.asarray(f))
    assert tuple(got.re.shape) == (b,) + (2,) * n
    assert got.re.dtype == DTYPES[key][0]
    _check(got, want, f"angle_encode {basis} n={n} {key}", key)


def test_readouts(case, dtypes):
    """probabilities, expect_z, expect_z_all, fidelity and z_logits on a
    batch of states (f32 results in both dtypes, within 1e-6)."""
    _, n, b = case
    key, (pdt, rdt) = dtypes
    rng = np.random.default_rng(50 + n)
    x, y = _state(rng, (b,), n), _state(rng, (b,), n)
    ps, rs = _port(x, pdt), _ref(x, rdt)
    k = min(n, 3)
    params = {"scale": rng.uniform(0.5, 2, k).astype(np.float32),
              "bias": rng.uniform(-1, 1, k).astype(np.float32)}
    outs = {
        "probabilities": (sv.probabilities(ps, n),
                          jax.vmap(rsv.probabilities)(rs)),
        "expect_z": (sv.expect_z(ps, n - 1, n),
                     jax.vmap(lambda s: rsv.expect_z(s, n - 1))(rs)),
        "expect_z_all": (sv.expect_z_all(ps, n),
                         jax.vmap(rsv.expect_z_all)(rs)),
        "fidelity": (sv.fidelity(ps, _port(y, pdt), n),
                     jax.vmap(rsv.fidelity)(rs, _ref(y, rdt))),
        "z_logits": (readout.z_logits(
            ps, {k_: torch.as_tensor(v) for k_, v in params.items()}, n),
            jax.vmap(lambda s: rreadout.z_logits(
                s, {k_: jnp.asarray(v) for k_, v in params.items()}))(rs)),
    }
    for name, (got, want) in outs.items():
        assert got.dtype == torch.float32, name
        err = float(np.abs(got.numpy() - np.asarray(want, np.float32)).max())
        print(f"{name} n={n} {key}: max|port-ref| {err:.3e}")
        assert err <= ATOL, (name, err)


def test_z_logits_per_client_readout():
    """(C, k) readouts left-align with a (C, B, …) state: client c's
    scale and bias on client c's rows."""
    n, clients, b, k = 4, 3, 2, 2
    rng = np.random.default_rng(60)
    x = _state(rng, (clients, b), n)
    scale = rng.uniform(0.5, 2, (clients, k)).astype(np.float32)
    bias = rng.uniform(-1, 1, (clients, k)).astype(np.float32)
    got = readout.z_logits(_port(x, torch.float32),
                           {"scale": torch.as_tensor(scale),
                            "bias": torch.as_tensor(bias)}, n)
    assert tuple(got.shape) == (clients, b, k)
    for c in range(clients):
        want = jax.vmap(lambda s: rreadout.z_logits(
            s, {"scale": jnp.asarray(scale[c]),
                "bias": jnp.asarray(bias[c])}))(_ref(x[c], jnp.float32))
        np.testing.assert_allclose(got[c].numpy(), np.asarray(want),
                                   atol=ATOL, rtol=0)
