"""The port's slot-sharded statevector (``qfedx_tpu_torch/parallel/``)
held against the reference's ``shard_map`` programs and the port's dense
engine.

Every case runs the same circuit on eight CPU slots (3 global qubits)
in the port and in the reference's 8-device virtual CPU mesh, on the
same seeded numpy states. The reference's cases are built into ONE
``shard_map`` program per module (a module-scoped fixture), so the file
pays one compile. Tolerances: states, gates and ⟨Z⟩ 1e-5 against both
the reference and the dense engine; the HEA forward and its gradient
1e-4 (the reference's own bounds, tests/test_sharded.py). The port has
no ``pmean_grad``: its gradient is autograd's plain sum over the slots,
held against the dense gradient and the reference's sharded one.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as RMesh, PartitionSpec as P

from qfedx_tpu import parallel as rpar
from qfedx_tpu.circuits.ansatz import hardware_efficient as r_hea
from qfedx_tpu.circuits.encoders import angle_encode as r_angle_encode
from qfedx_tpu.ops import gates as rgates, statevector as rsv
from qfedx_tpu.ops.cpx import CArray as RCArray
from qfedx_tpu.utils.compat import shard_map
from qfedx_tpu_torch.circuits.ansatz import hardware_efficient
from qfedx_tpu_torch.circuits.encoders import angle_encode
from qfedx_tpu_torch.ops import gates, statevector as sv
from qfedx_tpu_torch.ops.cpx import CArray, from_complex, to_complex
from qfedx_tpu_torch.parallel import (
    ShardCtx,
    apply_cnot_sharded,
    apply_gate_2q_sharded,
    apply_gate_sharded,
    expect_z_all_sharded,
    expect_z_sharded,
    fed_mesh,
    from_dense,
    make_sharded_forward,
    norm_sq_sharded,
    product_state_local,
    swap_global_local,
    zero_state_local,
)
from qfedx_tpu_torch.parallel.circuit import sharded_hea_state
from qfedx_tpu_torch.parallel.sharded import (
    amplitude_encode_local,
    apply_op_sharded,
    gather_dense,
    psum,
)

N_GLOBAL = 3
SLOTS = ("cpu",) * 8
ATOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _state_np(n, seed, real=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2,) * n)
    if not real:
        x = x + 1j * rng.normal(size=(2,) * n)
    return x / np.linalg.norm(x)


def _ref_state(x):
    return RCArray(jnp.asarray(x.real, jnp.float32),
                   jnp.asarray(x.imag, jnp.float32))


def _swap_np():
    s = np.zeros((2, 2, 2, 2))
    for a in range(2):
        for b in range(2):
            s[b, a, a, b] = 1.0
    return s


def _port_gate(g):
    return CArray(torch.as_tensor(np.asarray(g.re), dtype=torch.float32),
                  None if g.im is None
                  else torch.as_tensor(np.asarray(g.im), dtype=torch.float32))


# Each case: (name, n, seed, real, reference fn(ctx, dense), port fn(ctx,
# shards), dense fn(state)). The reference and port fns return a state
# (gathered over the slots) or a replicated array.
def _cases():
    out = []
    for q in (0, 2, 3, 5):  # global (0, 2) and local (3, 5)
        for real in (True, False):
            rg = rgates.ry(1.1) if real else rgates.rx(0.7)
            out.append((f"g1-{q}-{real}", 6, q, real,
                        lambda c, d, q=q, g=rg: rpar.apply_gate_sharded(
                            c, rpar.from_dense(c, d), g, q),
                        lambda c, s, q=q, g=rg: apply_gate_sharded(
                            c, s, _port_gate(g), q),
                        lambda d, q=q, g=rg: sv.apply_gate(
                            d, _port_gate(g), q)))
    for q in (1, 4):  # a complex gate on a real state
        out.append((f"rz-{q}", 5, 9, True,
                    lambda c, d, q=q: rpar.apply_gate_sharded(
                        c, rpar.from_dense(c, d), rgates.rz(0.4), q),
                    lambda c, s, q=q: apply_gate_sharded(
                        c, s, _port_gate(rgates.rz(0.4)), q),
                    lambda d, q=q: sv.apply_gate(d, gates.rz(0.4), q)))
    swap = RCArray(jnp.asarray(_swap_np(), jnp.float32), None)
    for g, l in ((0, 3), (2, 5), (1, 4)):
        out.append((f"swap-{g}-{l}", 6, g * 10 + l, False,
                    lambda c, d, g=g, l=l: rpar.swap_global_local(
                        c, rpar.from_dense(c, d), g, l),
                    lambda c, s, g=g, l=l: swap_global_local(c, s, g, l),
                    lambda d, g=g, l=l: sv.apply_gate_2q(
                        d, _port_gate(swap), g, l)))
    for q1, q2 in ((3, 4), (0, 3), (3, 0), (0, 2), (2, 1)):
        out.append((f"cnot-{q1}-{q2}", 6, q1 * 7 + q2, False,
                    lambda c, d, a=q1, b=q2: rpar.apply_gate_2q_sharded(
                        c, rpar.from_dense(c, d), rgates.CNOT, a, b),
                    lambda c, s, a=q1, b=q2: apply_cnot_sharded(c, s, a, b),
                    lambda d, a=q1, b=q2: sv.apply_cnot(d, a, b)))
        out.append((f"cnot2q-{q1}-{q2}", 6, q1 * 7 + q2, False,
                    lambda c, d, a=q1, b=q2: rpar.apply_gate_2q_sharded(
                        c, rpar.from_dense(c, d), rgates.CNOT, a, b),
                    lambda c, s, a=q1, b=q2: apply_gate_2q_sharded(
                        c, s, gates.CNOT, a, b),
                    lambda d, a=q1, b=q2: sv.apply_cnot(d, a, b)))
    out.append(("crz", 5, 3, False,
                lambda c, d: rpar.apply_gate_2q_sharded(
                    c, rpar.from_dense(c, d), rgates.crz(0.9), 1, 0),
                lambda c, s: apply_gate_2q_sharded(c, s, gates.crz(0.9),
                                                   1, 0),
                lambda d: sv.apply_gate_2q(d, gates.crz(0.9), 1, 0)))
    for q in (0, 1, 3, 4):
        out.append((f"z-{q}", 5, q + 20, False,
                    lambda c, d, q=q: rpar.expect_z_sharded(
                        c, rpar.from_dense(c, d), q),
                    lambda c, s, q=q: expect_z_sharded(c, s, q),
                    lambda d, q=q: sv.expect_z(d, q)))
    out.append(("z-all", 6, 42, False,
                lambda c, d: rpar.expect_z_all_sharded(
                    c, rpar.from_dense(c, d)),
                lambda c, s: expect_z_all_sharded(c, s),
                lambda d: sv.expect_z_all(d)))
    out.append(("norm", 6, 1, False,
                lambda c, d: rpar.norm_sq_sharded(c, rpar.from_dense(c, d)),
                lambda c, s: norm_sq_sharded(c, s),
                lambda d: torch.ones(())))
    out.append(("roundtrip", 6, 1, False,
                lambda c, d: rpar.from_dense(c, d),
                lambda c, s: s,
                lambda d: d))
    return out


CASES = _cases()
NAMES = [c[0] for c in CASES]


@pytest.fixture(scope="module")
def ref_results():
    """Every case's reference result from ONE shard_map program over the
    reference's 8 devices: a state gathered over the sv axis, or the
    replicated array."""
    mesh = RMesh(np.array(jax.devices()), ("sv",))
    inputs = [_ref_state(_state_np(n, seed, real))
              for _, n, seed, real, *_ in CASES]

    def per_device(*states):
        outs = []
        for (name, n, *_rest), d in zip(CASES, states):
            ctx = rpar.ShardCtx("sv", n, N_GLOBAL)
            o = _rest[2](ctx, d)
            if isinstance(o, RCArray):
                outs.append((o.re.reshape(1, -1),
                             o.imag_or_zeros().reshape(1, -1)))
            else:
                outs.append(jnp.broadcast_to(o, (1,) + o.shape))
        return outs

    f = jax.jit(shard_map(per_device, mesh=mesh, in_specs=P(),
                          out_specs=P("sv"), check_vma=False))
    got = f(*inputs)
    res = {}
    for (name, n, *_), o in zip(CASES, got):
        if isinstance(o, tuple):
            res[name] = (np.asarray(o[0]) + 1j * np.asarray(o[1])).reshape(
                (2,) * n)
        else:
            res[name] = np.asarray(o)[0]
    return res


@pytest.mark.parametrize("case", CASES, ids=NAMES)
def test_primitive_matches_reference_and_dense(case, ref_results):
    name, n, seed, real, _ref_fn, port_fn, dense_fn = case
    x = _state_np(n, seed, real)
    dense = from_complex(x, "cpu")
    if real:
        dense = CArray(dense.re, None)
    ctx = ShardCtx("sv", n, N_GLOBAL, SLOTS)
    out = port_fn(ctx, from_dense(ctx, dense))
    want_dense = dense_fn(dense)
    if isinstance(out, list):
        got = to_complex(gather_dense(ctx, out))
        np.testing.assert_allclose(got, ref_results[name], atol=ATOL)
        np.testing.assert_allclose(got, to_complex(want_dense), atol=ATOL)
    else:
        got = out.numpy()
        np.testing.assert_allclose(got, ref_results[name], atol=ATOL)
        np.testing.assert_allclose(got, want_dense.numpy(), atol=ATOL)


def test_zero_and_product_states():
    """|0…0⟩ on slot 0, and the angle product state assembled from the
    slots' global-bit scalars, against the dense engine (1e-6) on a
    batch of two states."""
    n = 5
    ctx = ShardCtx("sv", n, N_GLOBAL, SLOTS)
    got = to_complex(gather_dense(ctx, zero_state_local(ctx)))
    np.testing.assert_allclose(got, to_complex(sv.zero_state(n,
                                                             device="cpu")),
                               atol=1e-6)
    x = torch.as_tensor(np.random.default_rng(2).uniform(0, 1, (2, n)),
                        dtype=torch.float32)
    from qfedx_tpu_torch.circuits.encoders import angle_amplitudes

    shards = product_state_local(ctx, angle_amplitudes(x * math.pi))
    np.testing.assert_allclose(to_complex(gather_dense(ctx, shards)),
                               to_complex(angle_encode(x)), atol=1e-6)
    norms = norm_sq_sharded(ctx, shards)
    np.testing.assert_allclose(norms.numpy(), np.ones(2), atol=1e-6)
    # amplitude encoding with the all-zero → uniform fallback row
    a = np.random.default_rng(3).normal(size=(3, 1 << n)).astype(np.float32)
    a[1] = 0.0
    from qfedx_tpu_torch.circuits.encoders import amplitude_encode

    np.testing.assert_allclose(
        to_complex(gather_dense(ctx, amplitude_encode_local(ctx, a))),
        to_complex(amplitude_encode(a)), atol=1e-6)


def test_op_dispatch_and_psum():
    """``apply_op_sharded`` reaches every IR kind; ``psum`` sums in slot
    order."""
    from qfedx_tpu_torch.ops import fuse

    n = 6
    ctx = ShardCtx("sv", n, N_GLOBAL, SLOTS)
    d = from_complex(_state_np(n, 5), "cpu")
    diag = CArray(torch.tensor([0.6, -0.8]), torch.tensor([0.8, 0.6]))
    for op, want in [
        (fuse.Op("diag1", (1,), diag),
         sv.apply_gate(d, fuse.diag1_gate(diag), 1)),
        (fuse.Op("g2", (0, 4), gates.CNOT), sv.apply_cnot(d, 0, 4)),
        (fuse.Op("diag2", (2, 0), gates.CZ_DIAG),
         sv.apply_gate_2q(d, fuse.diag2_gate(gates.CZ_DIAG), 2, 0)),
    ]:
        got = gather_dense(ctx, apply_op_sharded(ctx, from_dense(ctx, d), op))
        np.testing.assert_allclose(to_complex(got), to_complex(want),
                                   atol=ATOL)
    parts = [torch.full((2,), float(j)) for j in range(8)]
    assert psum(parts).tolist() == [28.0, 28.0]


@pytest.fixture(scope="module")
def ref_forward():
    """The reference's make_sharded_forward on its 8 devices, with its
    value-and-gradient, compiled once for the module."""
    from qfedx_tpu.circuits.ansatz import init_ansatz_params

    out = {}
    # The reference's two shapes (tests/test_sharded.py).
    for n, layers, seed, scale, lo, hi in ((6, 2, 0, 0.3, 0.1, 0.9),
                                           (5, 1, 1, 0.2, 0.2, 0.8)):
        fwd, _ = rpar.make_sharded_forward(n, RMesh(np.array(jax.devices()),
                                                    ("sv",)))
        p = init_ansatz_params(jax.random.PRNGKey(seed), n, layers,
                               scale=scale)
        x = jnp.linspace(lo, hi, n)

        def loss(p, fwd=fwd, x=x):
            return jnp.sum(fwd(p, x) ** 2)

        z = np.asarray(fwd(p, x))
        g = jax.grad(loss)(p)
        out[n] = (jax.tree.map(np.asarray, p), np.asarray(x), z,
                  {k: np.asarray(v) for k, v in g.items()})
    return out


@pytest.mark.parametrize("n", [6, 5])
def test_sharded_hea_forward_and_grad(n, ref_forward):
    """Angle encode → HEA → ⟨Z⟩ on the (1 × 8) mesh: ⟨Z⟩ and the
    gradient of Σ⟨Z⟩² against the reference's sharded program and the
    port's dense engine at 1e-4."""
    p_np, x_np, z_ref, g_ref = ref_forward[n]
    fwd, ctx = make_sharded_forward(n, fed_mesh(sv_size=8, devices=SLOTS))
    assert ctx.n_global == N_GLOBAL
    p = {k: torch.tensor(v, requires_grad=True) for k, v in p_np.items()}
    x = torch.as_tensor(x_np)
    z = fwd(p, x)
    g = torch.autograd.grad(torch.sum(z ** 2), [p["rx"], p["rz"]])
    zd = sv.expect_z_all(hardware_efficient(angle_encode(x), n, p), n)
    gd = torch.autograd.grad(torch.sum(zd ** 2), [p["rx"], p["rz"]])
    np.testing.assert_allclose(z.detach().numpy(), z_ref, atol=1e-4)
    np.testing.assert_allclose(z.detach().numpy(), zd.detach().numpy(),
                               atol=1e-4)
    for got, dense, key in zip(g, gd, ("rx", "rz")):
        np.testing.assert_allclose(got.numpy(), g_ref[key], atol=1e-4)
        np.testing.assert_allclose(got.numpy(), dense.numpy(), atol=1e-4)
    want = np.asarray(rsv.expect_z_all(r_hea(r_angle_encode(
        jnp.asarray(x_np)), p_np)))
    np.testing.assert_allclose(z.detach().numpy(), want, atol=1e-4)


@pytest.mark.parametrize("n,sv_size", [(9, 4), (10, 8)])
def test_fused_local_runs_match_dense(n, sv_size):
    """At ≥ 7 local qubits the local runs take the fusion pass (lane
    matrices and row pairs on each shard): a batch of two through the
    2-layer HEA, ⟨Z⟩ and its gradient against the dense engine at
    1e-4."""
    from qfedx_tpu_torch.circuits.ansatz import init_ansatz_params

    ctx = ShardCtx("sv", n, (sv_size - 1).bit_length(), ("cpu",) * sv_size)
    assert ctx.n_local >= 7
    p = {k: v.requires_grad_(True) for k, v in
         init_ansatz_params(4, n, 2, 0.3, "cpu").items()}
    x = torch.as_tensor(np.random.default_rng(n).uniform(0, 1, (2, n)),
                        dtype=torch.float32)
    z = expect_z_all_sharded(ctx, sharded_hea_state(ctx, x, p))
    zd = sv.expect_z_all(hardware_efficient(angle_encode(x), n, p), n)
    np.testing.assert_allclose(z.detach().numpy(), zd.detach().numpy(),
                               atol=1e-4)
    g = torch.autograd.grad(z.sum(), [p["rx"], p["rz"]])
    gd = torch.autograd.grad(zd.sum(), [p["rx"], p["rz"]])
    for a, b in zip(g, gd):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4)
