"""Port vs reference: the amplitude and data-reuploading encodings.

Each module of the slice is held against its reference function on the
CPU, with the same numpy inputs made from a seed:

- ``amplitude_encode`` and ``bstate_amplitude`` (the zero-row fallback,
  the 2^n error): 1e-6;
- ``data_reuploading`` and its ``_b``/``_cb`` twins on the dense, the
  per-layer fused and the scan routes: states within 1e-5;
- the stacked reupload program (the scan route's body) at every row of
  the routing probe — served at tb = 1, 8, 32, 33, 128 (n = 12), n = 10
  and 15 at tb = 32, n = 16 at tb = 8; folded at (C, B) = (2, 4),
  (2, 16), (4, 8), (4, 32), (32, 32), (64, 32) — op kinds, qubits,
  group counts and coefficients within 1e-6, and ``route_ok`` equal to
  the reference's (True exactly where a bank has at most 32 groups:
  ``_ROWMAT_GROUP_MAX``);
- ``scan_body_plain`` vs the reference's interpreted Pallas kernel on
  the per-sample (G = tb) and mixed-group (G = tb beside G = C)
  programs, 1e-5; ``ScanBodyFn``'s cotangents vs ``jax.grad`` through
  the reference's custom_vjp, 2e-5;
- logits and gradients of both encodings through the models, 2e-5; the
  port's autograd vs ``param_shift_grad`` on the rotation leaves, and
  the port's parameter shift vs the reference's;
- one folded SGD round of a reupload model, θ within 1e-5.

The reference runs with the TPU program shape forced (the pins,
``_gather_ok``/``_growmat_merge_ok`` patched), its lax.scan route where
a whole model runs (exact against its interpreted kernel,
tests/test_pallas.py) and interpreted Pallas where the kernel is held.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qfedx_tpu.circuits import ansatz as ransatz
from qfedx_tpu.circuits import encoders as rencoders
from qfedx_tpu.circuits import gradients as rgradients
from qfedx_tpu.fed.config import FedConfig as RFedConfig
from qfedx_tpu.fed.round import (
    TRAIN_KEY_SALT,
    client_mesh,
    make_fed_round as ref_make_round,
    shard_client_data,
)
from qfedx_tpu.models.vqc import make_vqc_classifier as ref_make
from qfedx_tpu.ops import batched as rbatched
from qfedx_tpu.ops import fuse as rfuse
from qfedx_tpu.ops import gates as rgates
from qfedx_tpu.ops import pallas_body as rpb
from qfedx_tpu.ops.cpx import CArray as JC
from qfedx_tpu_torch.circuits import ansatz, encoders, gradients
from qfedx_tpu_torch.fed.config import FedConfig
from qfedx_tpu_torch.fed.round import make_fed_round
from qfedx_tpu_torch.models.vqc import make_vqc_classifier, params_from_jax
from qfedx_tpu_torch.ops import batched, fuse, scan_body
from qfedx_tpu_torch.ops.cpx import CArray as TC
from qfedx_tpu_torch.utils import trees

ENC_ATOL = 1e-6
STATE_ATOL = 1e-5
PROGRAM_ATOL = 1e-6
KERNEL_ATOL = 1e-5
GRAD_ATOL = 2e-5
SGD_ATOL = 1e-5
L = 3


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these small tensors: the suite runs
    several workers on one CPU, where torch's default pool per worker
    oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
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


def _close(got, want, atol, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=0,
                               err_msg=what)


def _close_state(got, want, atol, what=""):
    _close(got.re, want.re, atol, what + " re")
    if want.im is None:
        assert got.im is None or float(got.im.abs().max()) <= atol, what
    else:
        _close(got.imag_or_zeros(), want.im, atol, what + " im")


def _params(n, clients=None, seed=0, reupload=True):
    """Reupload (or HEA) parameters as numpy: (L, n) or (C, L, n)."""
    rng = np.random.default_rng(seed)
    shape = ((clients,) if clients else ()) + (L, n)
    p = {k: rng.uniform(-2, 2, shape).astype(np.float32)
         for k in ("rx", "rz")}
    if reupload:
        p["enc_w"] = (1 + 0.5 * rng.normal(size=shape)).astype(np.float32)
        p["enc_b"] = rng.uniform(-1, 1, shape).astype(np.float32)
    return p


def _features(shape, seed=1):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(
        np.float32)


def _jax(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _torch(tree):
    return {k: torch.as_tensor(v) for k, v in tree.items()}


# --- encoders -----------------------------------------------------------------


@pytest.mark.parametrize("n", [3, 10])
def test_amplitude_encoders_match_reference(n):
    x = np.random.default_rng(n).normal(size=(4, 1 << n)).astype(np.float32)
    x[1] = 0.0  # the all-zero row → the uniform state
    want = jax.vmap(rencoders.amplitude_encode)(jnp.asarray(x))
    got = encoders.amplitude_encode(torch.as_tensor(x))
    assert tuple(got.re.shape) == tuple(want.re.shape) == (4,) + (2,) * n
    assert got.im is None and want.im is None
    _close(got.re, want.re, ENC_ATOL, "amplitude_encode")
    _close(got.re[1].reshape(-1), np.full(1 << n, 2 ** (-n / 2)), ENC_ATOL)
    want_b = rbatched.bstate_amplitude(jnp.asarray(x), jnp.float32)
    got_b = batched.bstate_amplitude(torch.as_tensor(x), torch.float32)
    assert got_b.im is None and tuple(got_b.re.shape) == (4, 1 << n)
    _close(got_b.re, want_b.re, ENC_ATOL, "bstate_amplitude")


@pytest.mark.parametrize("size", [6, 0])
def test_amplitude_encoders_refuse_a_count_that_is_not_a_power_of_two(size):
    x = np.ones((2, size), np.float32)
    with pytest.raises(ValueError, match="2\\^n features"):
        rbatched.bstate_amplitude(jnp.asarray(x), jnp.float32)
    with pytest.raises(ValueError, match="2\\^n features"):
        batched.bstate_amplitude(torch.as_tensor(x), torch.float32)
    with pytest.raises(ValueError, match="2\\^n features"):
        encoders.amplitude_encode(torch.as_tensor(x))


# --- circuits -----------------------------------------------------------------


def test_init_reuploading_params():
    a = ansatz.init_reuploading_params(7, 10, L, 0.1, "cpu")
    b = ansatz.init_reuploading_params(np.random.default_rng(7), 10, L, 0.1,
                                       "cpu")
    ref = ransatz.init_reuploading_params(jax.random.PRNGKey(0), 10, L)
    assert sorted(a) == sorted(ref) == ["enc_b", "enc_w", "rx", "rz"]
    for k in a:
        assert tuple(a[k].shape) == ref[k].shape and a[k].dtype == torch.float32
        assert torch.equal(a[k], b[k])
    # The first two draws are init_ansatz_params' own.
    hea = ansatz.init_ansatz_params(7, 10, L, 0.1, "cpu")
    assert torch.equal(a["rx"], hea["rx"]) and torch.equal(a["rz"], hea["rz"])
    assert abs(float(a["enc_w"].mean()) - 1.0) < 0.1


def _ref_state(route, x, p):
    """The reference's state for ``route`` (jitted; the pins are read at
    trace time): its per-sample vmap of ``data_reuploading`` on the
    dense routes, ``data_reuploading_b``/``_cb`` on the slab ones."""
    if route in ("dense", "dense-clients"):
        def one(xi, pi):
            return ransatz.data_reuploading(xi, pi)

        if route == "dense-clients":
            fn = jax.vmap(lambda xc, pc: jax.vmap(lambda xi: one(xi, pc))(xc))
        else:
            fn = lambda xb, pb: jax.vmap(lambda xi: one(xi, pb))(xb)  # noqa: E731
    elif x.ndim == 3:
        fn = ransatz.data_reuploading_cb
    else:
        fn = ransatz.data_reuploading_b
    return jax.jit(fn)(jnp.asarray(x), _jax(p))


@pytest.mark.parametrize("route", ["dense", "dense-clients", "per-layer",
                                   "per-layer-remat", "scan",
                                   "folded-per-layer", "folded-scan"])
def test_reupload_states_match_reference(route, monkeypatch):
    """States of the reupload circuit: the dense engine below the slab
    widths (shared and per-client parameters), and at n = 10 the
    per-layer fused route (with remat: the dense route's checkpointed
    blocks, on the slab), the scan route and their client-folded twins
    (the reference's lax.scan route)."""
    clients = 2 if route in ("dense-clients", "folded-per-layer",
                             "folded-scan") else None
    n = 6 if route.startswith("dense") else 10
    p = _params(n, clients)
    lead = ((clients,) if clients else ()) + (4,)
    x = _features(lead + (n,))
    monkeypatch.setenv("QFEDX_PALLAS", "0")  # the reference's lax.scan
    if "per-layer" in route:
        monkeypatch.setenv("QFEDX_SCAN_LAYERS", "0")
    if n < 10:
        # The reference's dense engine in its XLA:CPU gate form (the
        # port runs flip, held against both in test_torch_dense.py).
        monkeypatch.setenv("QFEDX_GATE_FORM", "dot")
    want = _ref_state(route, x, p)
    monkeypatch.setenv("QFEDX_PALLAS", "1")
    tx, tp = torch.as_tensor(x), _torch(p)
    if route.startswith("dense"):
        got = ansatz.data_reuploading(tx, tp)
        assert tuple(got.re.shape) == lead + (2,) * n
    elif route == "per-layer-remat":
        # The dense route's remat at a slab width: the dense state runs
        # as its slab, block by block under checkpoint.
        monkeypatch.setenv("QFEDX_SCAN_LAYERS", "1")
        got = ansatz.data_reuploading(tx, tp, remat=True)
        got = TC(got.re.reshape(4, -1), got.im.reshape(4, -1))
    elif clients:
        got = ansatz.data_reuploading_cb(tx, tp)
    else:
        got = ansatz.data_reuploading_b(tx, tp)
    _close_state(got, want, STATE_ATOL, route)


# --- the stacked program and the kernel route ----------------------------------


class _Captured(Exception):
    def __init__(self, state, program):
        super().__init__("captured")
        self.state, self.program = state, program


def _capture(*args, **kwargs):
    state, _, program = args[:3]
    raise _Captured(state, program)


def _scan_inputs(n, tb, clients, monkeypatch, seed=0):
    """The reference's and the port's (state entering the scan, stacked
    program) of the reupload circuit: served (clients=None, features
    (tb, n)) or folded (C clients of tb/C samples)."""
    p = _params(n, clients, seed=seed)
    if clients:
        x = _features((clients, tb // clients, n), seed=seed + 1)
        calls = (lambda: ransatz.data_reuploading_cb(jnp.asarray(x), _jax(p)),
                 lambda: ansatz.data_reuploading_cb(torch.as_tensor(x),
                                                    _torch(p)))
    else:
        x = _features((tb, n), seed=seed + 1)
        calls = (lambda: ransatz.data_reuploading_b(jnp.asarray(x), _jax(p)),
                 lambda: ansatz.data_reuploading_b(torch.as_tensor(x),
                                                   _torch(p)))
    out = []
    saved = rfuse.apply_scan, fuse.apply_scan
    rfuse.apply_scan = fuse.apply_scan = _capture
    try:
        for call in calls:
            with pytest.raises(_Captured) as got:
                call()
            out.append((got.value.state, got.value.program))
    finally:
        rfuse.apply_scan, fuse.apply_scan = saved
    return out


def _groups(op, tb):
    """(kind, qubits, stacked, groups) of a program op."""
    if not op.stacked:
        return (op.kind, tuple(op.qubits), False, 1)
    trailing = {"g1": 2, "lane": 2, "rowmat": 2, "mask": 1, "glane": 3,
                "growmat": 3, "rowpair": 4}[op.kind]
    lead = op.coeffs.re.ndim - 1 - trailing
    return (op.kind, tuple(op.qubits), True,
            1 if lead == 0 else int(op.coeffs.re.shape[1]))


def _same_program(ref, out, tb, where):
    assert out.length == ref.length == L - 1, where
    for part in ("pre", "body"):
        r_ops, o_ops = getattr(ref, part), getattr(out, part)
        assert [_groups(o, tb) for o in o_ops] == [
            _groups(o, tb) for o in r_ops], f"{where} {part}"
        for i, (r, o) in enumerate(zip(r_ops, o_ops)):
            what = f"{where} {part}[{i}] {r.kind}"
            if isinstance(r.coeffs, JC):
                assert tuple(o.coeffs.re.shape) == tuple(r.coeffs.re.shape)
                _close(o.coeffs.re, r.coeffs.re, PROGRAM_ATOL, what)
                assert (o.coeffs.im is None) == (r.coeffs.im is None), what
                if r.coeffs.im is not None:
                    _close(o.coeffs.im, r.coeffs.im, PROGRAM_ATOL, what)
            elif r.coeffs is not None:  # a static row permutation
                np.testing.assert_array_equal(np.asarray(o.coeffs),
                                              np.asarray(r.coeffs), what)


def _programs(n, tb, clients, seed=0):
    """Both packages' stacked reupload programs from the same angles: the
    per-sample (L−1, tb, 2, 2) RY banks, then the shared (L−1, n) or
    per-client (L−1, C, n) rotations — the reference's trace as
    ``data_reuploading_b``/``_cb`` build it (ansatz.py:318-324, 376-383),
    the port's through its own ``_bank_ops`` and ``hea_scan_ops``."""
    rng = np.random.default_rng(seed)
    angles = rng.uniform(-2, 2, (L - 1, tb, n)).astype(np.float32)
    shape = (L - 1,) + ((clients,) if clients else ()) + (n,)
    rx, rz = (rng.uniform(-2, 2, shape).astype(np.float32)
              for _ in range(2))
    rops = [
        rfuse.Op("g1", (q,), rgates.ry_batched(jnp.asarray(angles[:, :, q])))
        for q in range(n)
    ] + ransatz.hea_scan_ops(n, jnp.asarray(rx), jnp.asarray(rz))
    oops = ansatz._bank_ops(torch.as_tensor(angles)) + ansatz.hea_scan_ops(
        n, torch.as_tensor(rx), torch.as_tensor(rz))
    return (rfuse.fuse_ops_stacked(rops, n, L - 1),
            fuse.fuse_ops_stacked(oops, n, L - 1))


# (n, tb, clients, the body's kinds, route_ok): the routing probe.
PROBE = [
    (12, 1, None, ["glane", "growmat"], True),
    (12, 8, None, ["glane", "growmat"], True),
    (12, 32, None, ["glane", "growmat"], True),
    (12, 33, None, ["rowpair", "rowpair", "g1", "rowmat", "glane", "cnot"],
     False),
    (12, 128, None, ["rowpair", "rowpair", "g1", "rowmat", "glane", "cnot"],
     False),
    (10, 32, None, ["glane", "growmat"], True),
    (15, 32, None, ["rowpair"] * 8 + ["rowperm", "glane", "cnot"], True),
    (16, 8, None, ["rowpair"] * 9 + ["rowperm", "glane", "cnot"], True),
    (12, 8, 2, ["lane", "rowmat", "glane", "growmat"], True),
    (12, 32, 2, ["lane", "rowmat", "glane", "growmat"], True),
    (12, 32, 4, ["lane", "rowmat", "glane", "growmat"], True),
    (12, 128, 4, ["rowpair", "rowpair", "g1", "lane", "rowmat", "glane",
                  "cnot"], False),
    (12, 1024, 32, ["rowpair", "rowpair", "g1", "lane", "rowmat", "glane",
                    "cnot"], False),
    (12, 2048, 64, ["rowpair", "rowpair", "g1", "rowpair", "rowpair",
                    "lane", "g1", "rowperm", "glane", "cnot"], False),
]


@pytest.mark.parametrize(
    "n,tb,clients,kinds,ok", PROBE,
    ids=[f"n{n}-tb{tb}" + (f"-C{c}" if c else "") for n, tb, c, _, _ in PROBE],
)
def test_stacked_program_and_route_match_reference(n, tb, clients, kinds,
                                                   ok):
    rprog, oprog = _programs(n, tb, clients)
    _same_program(rprog, oprog, tb, f"n={n} tb={tb} C={clients}")
    assert [op.kind for op in oprog.body] == kinds
    rstate = JC(jnp.zeros((tb, 1 << n)), jnp.zeros((tb, 1 << n)))
    ostate = TC(torch.zeros(tb, 1 << n), torch.zeros(tb, 1 << n))
    want = rpb.route_ok(rstate, n, rprog, True)
    assert scan_body.route_ok(ostate, n, oprog, True) is want is ok
    # A per-sample bank group (G = tb) rides the body only while the
    # banks fold into row matrices (≤ 32 groups).
    groups = {_groups(op, tb)[3] for op in oprog.body if op.stacked}
    if ok and tb > 1:
        assert tb in groups


KERNEL_CASES = [(10, 8, None), (10, 8, 2)]
KERNEL_IDS = ["served-n10-tb8", "folded-n10-C2xB4"]


def _kernel_inputs(n, tb, clients, monkeypatch):
    (rstate, rprog), (ostate, oprog) = _scan_inputs(n, tb, clients,
                                                    monkeypatch, seed=3)
    assert rpb.route_ok(rstate, n, rprog, True)
    assert scan_body.route_ok(ostate, n, oprog, True)
    return (rstate, rprog), (ostate, oprog)


@pytest.mark.parametrize("n,tb,clients", KERNEL_CASES, ids=KERNEL_IDS)
def test_plain_sweep_matches_interpreted_kernel(n, tb, clients, monkeypatch):
    """The kernel's plain version on the reupload bodies — per-sample
    [glane, growmat] (G = tb) and the folded [lane (G = tb), rowmat
    (G = C), glane (G = C), growmat (G = tb)] — equals the reference's
    Pallas kernel in interpret mode."""
    (rstate, rprog), (ostate, oprog) = _kernel_inputs(n, tb, clients,
                                                      monkeypatch)
    want = jax.jit(lambda st: rpb.apply_scan_pallas(
        st, n, rprog, batched=True))(rstate)
    got = scan_body.apply_scan_pallas(ostate, n, oprog, batched=True)
    _close_state(got, want, KERNEL_ATOL, "Launch A")
    spec = scan_body._build_spec(ostate, n, oprog, True)
    assert {op.groups for op in spec.ops if op.stacked} == (
        {tb} if clients is None else {tb, clients})


@pytest.mark.parametrize("n,tb,clients", KERNEL_CASES, ids=KERNEL_IDS)
def test_function_grads_match_reference(n, tb, clients, monkeypatch):
    """``ScanBodyFn`` (Launch B, then C and the coefficient cotangents:
    per-sample stacks come back as (L−1, tb, …) stacks) ≡ ``jax.grad``
    through the reference's custom_vjp, interpreted."""
    (rstate, rprog), (ostate, oprog) = _kernel_inputs(n, tb, clients,
                                                      monkeypatch)
    for op in rprog.pre:
        rstate = rfuse._exec_stacked(rstate, n, op, True)
    ostate = TC(ostate.re, ostate.imag_or_zeros())
    for op in oprog.pre:
        ostate = fuse._exec_stacked(ostate, n, op, True)
    rstate = JC(rstate.re, rstate.im if rstate.im is not None
                else jnp.zeros_like(rstate.re))
    r = 1 << (n - 7)
    rspec = rpb._build_spec(rstate, n, rprog, True)
    ospec = scan_body._build_spec(ostate, n, oprog, True)
    rpacked = jnp.stack([rstate.re.reshape(tb, r, 128),
                         rstate.im.reshape(tb, r, 128)])
    opacked = torch.stack([ostate.re.reshape(tb, r, 128),
                           ostate.im.reshape(tb, r, 128)])
    rxs = tuple(op.coeffs for op in rprog.body if op.stacked)
    oxs = tuple(op.coeffs for op in oprog.body if op.stacked)
    w = np.random.default_rng(9).normal(size=(2, tb, r, 128)).astype(
        np.float32)

    def loss(packed, xs):
        return jnp.sum(jnp.asarray(w) * rpb._pallas_scan(rspec, packed,
                                                         xs) ** 2)

    rg_state, rg_xs = jax.jit(jax.grad(loss, argnums=(0, 1)))(rpacked,
                                                               rxs)
    rflat = [q for c in rg_xs for q in (c.re, c.im) if q is not None]
    packed = opacked.clone().requires_grad_(True)
    flat = [q.clone().requires_grad_(True) for q in scan_body._flatten(oxs)]
    out = scan_body.ScanBodyFn.apply(ospec, packed, *flat)
    g_state, *g_flat = torch.autograd.grad(
        (torch.as_tensor(w) * out ** 2).sum(), [packed] + flat)
    _close(g_state, rg_state, GRAD_ATOL, "state cotangent")
    assert len(g_flat) == len(rflat)
    for i, (g, want) in enumerate(zip(g_flat, rflat)):
        assert tuple(g.shape) == tuple(want.shape)
        _close(g, want, GRAD_ATOL, f"coefficient cotangent {i}")
    # Per-sample stacks keep their sample axis: (L−1, tb, …).
    assert any(tuple(g.shape[:2]) == (L - 1, tb) for g in g_flat)


# --- the models ----------------------------------------------------------------


def _model_pair(n, encoding):
    ref = ref_make(n, L, 2, encoding=encoding)
    rp = ref.init(jax.random.PRNGKey(0))
    widened = {
        "ansatz": {k: np.asarray(v) * (1.0 if k == "enc_w" else 8.0)
                   for k, v in rp["ansatz"].items()},
        "readout": {k: np.asarray(v) + 0.3 for k, v in rp["readout"].items()},
    }
    port = make_vqc_classifier(n, L, 2, encoding=encoding, device="cpu")
    return ref, port, widened


def _model_features(n, encoding, lead, seed=2):
    width = (1 << n) if encoding == "amplitude" else n
    x = _features(lead + (width,), seed=seed)
    if encoding == "amplitude":
        x = x - 0.5
    return x


@pytest.mark.parametrize("n,encoding", [(6, "reupload"), (10, "reupload"),
                                        (10, "amplitude")])
def test_logits_and_grads_match_reference(n, encoding, monkeypatch):
    """Logits and every leaf's gradient through the models: the dense
    engine at n = 6, the batched route (the kernel's plain version) at
    n = 10."""
    monkeypatch.setenv("QFEDX_PALLAS", "0")  # the reference's lax.scan
    if n < 10:
        monkeypatch.setenv("QFEDX_GATE_FORM", "dot")
    ref, port, p = _model_pair(n, encoding)
    x = _model_features(n, encoding, (4,))
    w = np.random.default_rng(3).normal(size=(4, 2)).astype(np.float32)

    def rloss(params):
        logits = ref.apply(params, jnp.asarray(x))
        return jnp.sum(jnp.asarray(w) * logits), logits

    (_, want_logits), want_grads = jax.jit(
        jax.value_and_grad(rloss, has_aux=True))(jax.tree.map(jnp.asarray, p))
    tp = params_from_jax(p, device="cpu")
    leaves = [v.requires_grad_(True) for v in trees.tree_leaves(tp)]
    logits = port.apply(tp, x)
    assert port.engine() == ("batched" if n >= 10 else "vmap")
    _close(logits, want_logits, GRAD_ATOL, "logits")
    grads = torch.autograd.grad((torch.as_tensor(w) * logits).sum(), leaves)
    for g, want in zip(grads, jax.tree.leaves(want_grads)):
        _close(g, want, GRAD_ATOL, "gradient")


def test_autograd_matches_parameter_shift():
    """The port's autograd (n = 10: through ``ScanBodyFn`` and the
    coefficient cotangents of the per-sample stacks) equals the
    parameter-shift rule on the rotation leaves rx and rz of the scanned
    layers 1 and 2 (layer 0 runs outside the scan), on three row qubits
    and three lane qubits of each."""
    n = 10
    port = make_vqc_classifier(n, L, 2, encoding="reupload", device="cpu")
    p = params_from_jax(_model_pair(n, "reupload")[2], device="cpu")
    x = torch.as_tensor(_model_features(n, "reupload", (1,)))
    w = torch.as_tensor([[1.0, -0.5]])

    qubits = [0, 1, 2, 7, 8, 9]

    def loss(angles):
        full = {}
        for k, v in angles.items():
            full[k] = p["ansatz"][k].clone()
            full[k][1:, qubits] = v
        q = {"ansatz": {**p["ansatz"], **full}, "readout": p["readout"]}
        return (w * port.apply(q, x)).sum()

    angles = {k: p["ansatz"][k][1:, qubits].clone().requires_grad_(True)
              for k in ("rx", "rz")}
    auto = torch.autograd.grad(loss(angles), list(angles.values()))
    shift = gradients.param_shift_grad_pytree(
        loss, {k: v.detach() for k, v in angles.items()})
    for (k, a) in zip(angles, auto):
        _close(a, shift[k].numpy(), GRAD_ATOL, k)


def test_param_shift_matches_reference():
    """The port's parameter shift ≡ the reference's, on a function that
    both packages evaluate alike (a sum of products of cosines)."""
    rng = np.random.default_rng(6)
    tree = {"a": rng.uniform(-2, 2, (3, 2)).astype(np.float32),
            "b": {"c": rng.uniform(-2, 2, (4,)).astype(np.float32)}}
    coef = rng.normal(size=4).astype(np.float32)

    def fn(t, mod):
        a, c = t["a"], t["b"]["c"]
        w = jnp.asarray(coef) if mod is jnp else torch.as_tensor(coef)
        return (mod.sum(mod.cos(a)) * mod.sum(mod.sin(c * 0.5) * w)
                + mod.sum(mod.cos(c)))

    want = rgradients.param_shift_grad_pytree(
        lambda t: fn(t, jnp), jax.tree.map(jnp.asarray, tree))
    got = gradients.param_shift_grad_pytree(
        lambda t: fn(t, torch), {"a": torch.as_tensor(tree["a"]),
                                 "b": {"c": torch.as_tensor(tree["b"]["c"])}})
    _close(got["a"], want["a"], 1e-6, "a")
    _close(got["b"]["c"], want["b"]["c"], 1e-6, "c")


def test_folded_sgd_round_matches_reference(monkeypatch):
    """One folded round of the reupload model (n = 10, C = 2 clients of
    S = 8, batch 4: tb = 8, the mixed-group kernel body) under SGD with
    momentum, the reference's shuffles injected."""
    n, c, s, batch = 10, 2, 8, 4
    rng = np.random.default_rng(5)
    cx = rng.uniform(0, 1, (c, s, n)).astype(np.float32)
    cy = rng.integers(0, 2, (c, s)).astype(np.int32)
    cm = np.ones((c, s), np.float32)
    kw = dict(local_epochs=1, batch_size=batch, learning_rate=0.1,
              momentum=0.9)
    ref, port, p = _model_pair(n, "reupload")
    monkeypatch.setenv("QFEDX_PALLAS", "0")
    mesh = client_mesh(num_devices=1)
    rf = ref_make_round(ref, RFedConfig(**kw), mesh, num_clients=c)
    key = jax.random.PRNGKey(11)
    rparams, rstats = rf(jax.tree.map(jnp.asarray, p),
                         *shard_client_data(mesh, *(jnp.asarray(a) for a in
                                                    (cx, cy, cm))), key)
    train_key = jax.random.fold_in(key, TRAIN_KEY_SALT)
    perms = torch.as_tensor(np.asarray([[np.asarray(jax.random.permutation(
        jax.random.split(jax.random.split(jax.random.fold_in(
            train_key, cid), 1)[0])[0], s))] for cid in range(c)]))
    monkeypatch.setenv("QFEDX_PALLAS", "1")
    scan_body.reset_counts()
    pf = make_fed_round(port, FedConfig(**kw), num_clients=c)
    params, stats = pf(params_from_jax(p, device="cpu"),
                       *(torch.as_tensor(a) for a in (cx, cy, cm)),
                       perms=perms)
    for g, want in zip(trees.tree_leaves(params), jax.tree.leaves(rparams)):
        _close(g, want, SGD_ATOL, "θ")
    assert abs(float(stats.mean_loss) - float(rstats.mean_loss)) <= SGD_ATOL
