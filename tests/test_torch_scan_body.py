"""Port vs reference: the scan-body kernel's plain version and its wrapper.

``scan_body_plain`` (the plain PyTorch version the CUDA kernel is held
against on the card) must compute what the reference's Pallas kernel
computes: ``qfedx_tpu.ops.pallas_body.apply_scan_pallas`` runs in
interpret mode on the CPU, on the HEA programs at n=12 (glane + growmat)
and n=15 (rowpairs + rowperm + glane + cnot), and on a directly built
program with every kernel op kind and all four CNOT placements (shared
G=1 and, real-valued, per-sample G=tb coefficients), at tb = 4. Tolerance:
atol 1e-5 in f32 (same products, other summation order).

The kernel's three launches and its gradient: with boundaries, the plain
version's final state and layer-entry states equal the reference's
``_run(with_boundaries=True)`` (Launch B); ``_adjoint_spec``/
``_adjoint_xs`` (Launch C's inputs) equal the reference's exactly; and
``ScanBodyFn``'s state and coefficient cotangents equal ``jax.grad``
through the reference's ``_pallas_scan`` custom_vjp in interpret mode
(atol 2e-5, the reference's own bound in ``tests/test_pallas.py``) and
plain torch autograd through ``scan_body_plain`` — on the all-kinds
programs at n=10, G ∈ {1, 2}, real and complex.

The CUDA kernel itself only runs on the card (``chip_smoke.py``); here
the wrapper is held to its contract: CPU tensors take the plain version
without counting a launch, non-f32 or misshapen inputs raise, inputs
that require grad go through ``ScanBodyFn``, and the packed
descriptor/coefficient layout the kernel reads is consistent.
"""

import jax
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


# --- the launch configuration and the build tag ------------------------------

SMEM_LIMIT = 232_448  # an H100 block's shared memory, bytes


def _spec_of(n, tb, kinds=("glane", "growmat")):
    """A stacked spec of width n over tb blocks (the served HEA body's
    kinds by default)."""
    q = {"glane": (1,), "growmat": (n - 2,), "cnot": (0, 1)}
    ops = tuple(
        scan_body._OpSpec(k, q[k], k != "cnot", 1, k != "cnot", None)
        for k in kinds
    )
    return scan_body._KernelSpec(n=n, length=3, tb=tb, batched=True, ops=ops)


@pytest.mark.parametrize("tb", [1, 2, 8, 32, 64])
@pytest.mark.parametrize("n", list(range(10, 21)))
def test_launch_config_fits_the_card(n, tb, monkeypatch):
    """For every width and tb: K is a power of two that divides R, at most
    16; the cluster's shared memory fits a block; the instance is the
    cluster exactly where a ≤16-CTA cluster holds the state (n ≤ 17), so
    the main path's n=12 and the parity programs' n=15 take it; the tb
    clusters fit the card's resident clusters of K (one wave) wherever
    the state allows; and the
    choice is a pure function of the spec, made without the kernel
    library or any CUDA call."""
    def no_cuda(*a, **k):
        raise AssertionError("_launch_config touched the card")

    monkeypatch.setattr(scan_body, "load_kernel", no_cuda)
    monkeypatch.setattr(torch.cuda, "is_available", no_cuda)
    scan_body._launch_config.cache_clear()
    spec = _spec_of(n, tb)
    cfg = scan_body._launch_config(spec)
    rows = 1 << (n - 7)
    assert cfg.instance in ("cluster", "global")
    assert 1 <= cfg.cluster <= 16 and rows % cfg.cluster == 0
    assert cfg.cluster & (cfg.cluster - 1) == 0
    assert 0 <= cfg.smem <= SMEM_LIMIT
    if cfg.instance == "cluster":
        assert cfg.smem == scan_body._cluster_smem(spec, cfg.cluster)
        fixed = 16 * rows // cfg.cluster * 128 + 8 * 4 * 2
        units, rest = divmod(cfg.smem - fixed, 16384)
        assert rest == 0 and 4 <= units <= 8
        assert units == 8 or cfg.smem + 16384 > SMEM_LIMIT
    else:
        assert (cfg.cluster, cfg.smem) == (1, 0)
    assert (cfg.instance == "cluster") == (n <= 17)
    if cfg.instance == "cluster" and cfg.cluster < min(16, rows):
        # A larger K was refused: its clusters did not fit one wave, or
        # its rows did not fit the shared memory.
        big = 2 * cfg.cluster
        assert (scan_body._cluster_smem(spec, big) is None
                or tb > scan_body._RESIDENT[big])
    if n in (12, 15):
        assert cfg.instance == "cluster"
    if n <= 13:  # the rows fit at every K: one wave of clusters sets K
        want = {1: 16, 2: 16, 8: 8, 32: 2, 64: 2}[tb]
        assert cfg.cluster == min(want, rows)
        assert tb <= scan_body._RESIDENT[cfg.cluster]
    # Same spec, same answer; another spec of the same (n, tb) and op
    # count, same answer: nothing else enters the choice.
    scan_body._launch_config.cache_clear()
    assert scan_body._launch_config(spec) == cfg
    assert scan_body._launch_config(_spec_of(n, tb, ("cnot", "glane"))) == cfg


# The f32 configurations as they stand (the served HEA body's kinds, L=3):
# (n, tb) -> (K, dynamic shared memory). The bf16 instance's tensor-core
# products left the f32 instance's launches as they were.
F32_CONFIGS = {
    (10, 1): (8, 133184), (10, 8): (8, 133184), (10, 16): (4, 135232),
    (10, 32): (2, 139328), (10, 64): (2, 139328), (10, 128): (1, 147520),
    (10, 256): (1, 147520), (11, 1): (16, 133184), (11, 8): (8, 135232),
    (11, 16): (4, 139328), (11, 32): (2, 147520), (11, 64): (2, 147520),
    (11, 128): (1, 163904), (11, 256): (1, 163904), (12, 1): (16, 135232),
    (12, 8): (8, 139328), (12, 16): (4, 147520), (12, 32): (2, 163904),
    (12, 64): (2, 163904), (12, 128): (1, 196672), (12, 256): (1, 196672),
    (13, 1): (16, 139328), (13, 8): (8, 147520), (13, 16): (4, 163904),
    (13, 32): (2, 196672), (13, 64): (2, 196672), (13, 128): (1, 229440),
    (13, 256): (1, 229440), (14, 1): (16, 147520), (14, 8): (8, 163904),
    (14, 16): (4, 196672), (14, 32): (2, 229440), (14, 64): (2, 229440),
    (14, 128): (2, 229440), (14, 256): (2, 229440), (15, 1): (16, 163904),
    (15, 8): (8, 196672), (15, 16): (4, 229440), (15, 32): (4, 229440),
    (15, 64): (4, 229440), (15, 128): (4, 229440), (15, 256): (4, 229440),
    (16, 1): (16, 196672), (16, 8): (8, 229440), (16, 16): (8, 229440),
    (16, 32): (8, 229440), (16, 64): (8, 229440), (16, 128): (8, 229440),
    (16, 256): (8, 229440), (17, 1): (16, 229440), (17, 8): (16, 229440),
    (17, 16): (16, 229440), (17, 32): (16, 229440), (17, 64): (16, 229440),
    (17, 128): (16, 229440), (17, 256): (16, 229440),
}


@pytest.mark.parametrize("n,tb", sorted(F32_CONFIGS))
def test_launch_config_f32_frozen(n, tb):
    """The f32 instance keeps its launches: the cluster instance, K and
    shared memory of every n = 10-17 and tb, its products FFMA, and the
    C entries' f32 code."""
    scan_body._launch_config.cache_clear()
    cfg = scan_body._launch_config(_spec_of(n, tb))
    k, smem = F32_CONFIGS[n, tb]
    assert cfg == scan_body.LaunchConfig("cluster", k, smem, "float32",
                                         "ffma")
    assert scan_body._cluster_smem(_spec_of(n, tb), k) == smem
    assert scan_body._DTYPE_CODE[cfg.dtype] == 0


def _csrc_copy(tmp_path, monkeypatch):
    dst = tmp_path / "csrc"
    dst.mkdir()
    for path in scan_body._build_inputs():
        (dst / path.name).write_bytes(path.read_bytes())
    monkeypatch.setattr(scan_body, "_CSRC", dst)
    monkeypatch.setattr(scan_body, "_SOURCE", dst / "scan_body.cu")
    return dst


def test_build_inputs_are_every_kernel_source():
    names = {p.name for p in scan_body._build_inputs()}
    assert names == {p.name for p in scan_body._CSRC.iterdir()
                     if p.suffix in (".cu", ".cuh")}
    assert {"scan_body.cu", "scan_body_common.cuh",
            "scan_body_cluster.cuh", "scan_body_mma.cuh"} <= names


@pytest.mark.parametrize("name", ["scan_body.cu", "scan_body_common.cuh",
                                  "scan_body_cluster.cuh",
                                  "scan_body_mma.cuh"])
def test_build_tag_follows_every_source(name, tmp_path, monkeypatch):
    """Editing any file the build reads changes the library's tag, so a
    stale shared library is never loaded."""
    dst = _csrc_copy(tmp_path, monkeypatch)
    before = scan_body._build_tag()
    assert scan_body._build_tag() == before
    path = dst / name
    path.write_bytes(path.read_bytes() + b"\n// edited\n")
    assert scan_body._build_tag() != before


def test_build_tag_follows_a_new_header(tmp_path, monkeypatch):
    dst = _csrc_copy(tmp_path, monkeypatch)
    before = scan_body._build_tag()
    (dst / "extra.cuh").write_text("#pragma once\n")
    assert scan_body._build_tag() != before


def test_refused_cluster_launch_names_its_config():
    cfg = scan_body.LaunchConfig("cluster", 16, 131104)
    msg = scan_body.launch_error(scan_body._ERR_CLUSTER_UNSCHEDULABLE, cfg)
    assert "16 CTAs" in msg and "131104" in msg
    assert "CUDA error 1" in scan_body.launch_error(1, cfg)


# --- Launches B and C, and the gradient --------------------------------------

GRAD_ATOL = 2e-5
KINDS_CASES = [(None, False), (2, False), (None, True), (2, True)]
KINDS_IDS = ["G1", "G2", "G1-real", "G2-real"]


def _kinds_inputs(groups, real, seed=21):
    """The all-kinds program at n=10, L=2 on both sides: (reference spec,
    packed, xs), (port spec, packed, xs)."""
    n = 10
    rprog, oprog = _kinds_programs(n, 2, groups, seed=seed, real=real)
    rstate, ostate = _state(n, seed=seed + 1)
    rspec = rpb._build_spec(rstate, n, rprog, True)
    ospec = scan_body._build_spec(ostate, n, oprog, True)
    rpacked = jnp.stack([rstate.re.reshape(TB, 8, 128),
                         rstate.im.reshape(TB, 8, 128)])
    opacked = torch.stack([ostate.re.reshape(TB, 8, 128),
                           ostate.im.reshape(TB, 8, 128)])
    rxs = tuple(op.coeffs for op in rprog.body if op.stacked)
    oxs = tuple(op.coeffs for op in oprog.body if op.stacked)
    return (rspec, rpacked, rxs), (ospec, opacked, oxs)


def _close(got, want, atol, what=""):
    np.testing.assert_allclose(
        got.detach().numpy(), np.asarray(want), atol=atol, rtol=0,
        err_msg=what,
    )


@pytest.mark.parametrize("groups,real", KINDS_CASES, ids=KINDS_IDS)
def test_boundaries_match_reference_launch_b(groups, real):
    (rspec, rpacked, rxs), (ospec, opacked, oxs) = _kinds_inputs(groups,
                                                                  real)
    rfinal, rbnd = rpb._run(rspec, rpacked, rxs, with_boundaries=True)
    final, bnd = scan_body.scan_body(opacked, ospec, oxs,
                                     with_boundaries=True)
    assert tuple(bnd.shape) == tuple(rbnd.shape) == (2, 2, TB, 8, 128)
    _close(final, rfinal, ATOL, "final state")
    _close(bnd, rbnd, ATOL, "boundaries")
    # Without boundaries: the same final state (Launch A).
    assert torch.equal(scan_body.scan_body(opacked, ospec, oxs), final)


@pytest.mark.parametrize("groups,real", KINDS_CASES, ids=KINDS_IDS)
def test_adjoint_artifacts_match_reference(groups, real):
    (rspec, _, rxs), (ospec, _, oxs) = _kinds_inputs(groups, real)
    raspec, oaspec = rpb._adjoint_spec(rspec), scan_body._adjoint_spec(ospec)
    assert oaspec.ops == raspec.ops
    assert (oaspec.n, oaspec.length, oaspec.tb) == (
        raspec.n, raspec.length, raspec.tb)
    assert [op.kind for op in oaspec.ops] == [
        op.kind for op in reversed(ospec.ops)]
    raxs = rpb._adjoint_xs(rspec, rxs)
    oaxs = scan_body._adjoint_xs(ospec, oxs)
    assert len(raxs) == len(oaxs)
    for r, o in zip(raxs, oaxs):
        assert tuple(o.re.shape) == tuple(r.re.shape)
        np.testing.assert_array_equal(o.re.numpy(), np.asarray(r.re))
        assert (o.im is None) == (r.im is None)
        if r.im is not None:
            np.testing.assert_array_equal(o.im.numpy(), np.asarray(r.im))


def _weights(seed=31):
    return np.random.default_rng(seed).normal(
        size=(2, TB, 8, 128)).astype(np.float32)


def _port_grads(ospec, opacked, oxs, w, through):
    """Cotangents of Σ w·out² w.r.t. the packed state and every flat
    coefficient, through ``ScanBodyFn`` or straight through the plain
    version's autograd."""
    packed = opacked.clone().requires_grad_(True)
    flat = [p.clone().requires_grad_(True) for p in scan_body._flatten(oxs)]
    if through == "function":
        out = scan_body.ScanBodyFn.apply(ospec, packed, *flat)
    else:
        out = scan_body.scan_body_plain(
            packed, ospec, scan_body._unflatten(ospec, flat))
    loss = (torch.as_tensor(w) * out**2).sum()
    grads = torch.autograd.grad(loss, [packed] + flat)
    return grads, out.detach()


@pytest.mark.parametrize("groups,real", KINDS_CASES, ids=KINDS_IDS)
def test_function_grads_match_reference(groups, real):
    """State and coefficient cotangents of ``ScanBodyFn`` ≡ ``jax.grad``
    through the reference's custom_vjp (interpreted Launches B and C)."""
    (rspec, rpacked, rxs), (ospec, opacked, oxs) = _kinds_inputs(groups,
                                                                  real)
    w = _weights()

    def loss(packed, xs):
        return jnp.sum(jnp.asarray(w) * rpb._pallas_scan(rspec, packed,
                                                         xs) ** 2)

    rg_state, rg_xs = jax.grad(loss, argnums=(0, 1))(rpacked, rxs)
    rflat = [p for c in rg_xs for p in (c.re, c.im) if p is not None]
    (g_state, *g_flat), _ = _port_grads(ospec, opacked, oxs, w, "function")
    assert len(g_flat) == len(rflat)
    _close(g_state, rg_state, GRAD_ATOL, "state cotangent")
    for i, (g, r) in enumerate(zip(g_flat, rflat)):
        assert tuple(g.shape) == tuple(r.shape)
        _close(g, r, GRAD_ATOL, f"coefficient cotangent {i}")


@pytest.mark.parametrize("groups,real", KINDS_CASES, ids=KINDS_IDS)
def test_function_grads_match_plain_autograd(groups, real):
    """The same cotangents ≡ torch autograd straight through
    ``scan_body_plain`` (no Function): the pure-torch oracle the card's
    gradient check uses."""
    _, (ospec, opacked, oxs) = _kinds_inputs(groups, real)
    w = _weights()
    got, out_fn = _port_grads(ospec, opacked, oxs, w, "function")
    want, out_plain = _port_grads(ospec, opacked, oxs, w, "plain")
    assert torch.equal(out_fn, out_plain)
    for i, (g, r) in enumerate(zip(got, want)):
        _close(g, r, GRAD_ATOL, f"cotangent {i}")


def test_differentiable_call_goes_through_the_function(monkeypatch):
    """A differentiable sweep no longer refuses: ``apply_scan_pallas``
    under grad runs ``ScanBodyFn`` — the wrapper once with boundaries in
    the forward and once on the adjoint spec in the backward — and the
    wrapper itself refuses grad-requiring inputs rather than dropping the
    graph. CPU tensors count no launches on either call."""
    _, (ospec, opacked, oxs) = _kinds_inputs(2, False)
    calls = []
    real = scan_body.scan_body

    def spy(packed, spec, xs, with_boundaries=False, adjoint=False):
        calls.append((spec, with_boundaries, adjoint))
        return real(packed, spec, xs, with_boundaries, adjoint)

    monkeypatch.setattr(scan_body, "scan_body", spy)
    _, oprog = _kinds_programs(10, 2, 2, seed=21)
    _, ostate = _state(10, seed=22)
    body = tuple(
        fuse.StackedOp(op.kind, op.qubits,
                       TC(op.coeffs.re.clone().requires_grad_(True),
                          op.coeffs.im), True)
        if op.stacked else op
        for op in oprog.body
    )
    coeffs = [op.coeffs.re for op in body if op.stacked]
    prog = fuse.ScanProgram((), body, 2)
    before = scan_body.launch_count
    out = scan_body.apply_scan_pallas(ostate, 10, prog, batched=True)
    assert out.re.grad_fn is not None
    assert [(w, a) for _, w, a in calls] == [(True, False)]
    (out.re.sum() + out.im.square().sum()).backward()
    assert [(w, a) for _, w, a in calls] == [(True, False), (True, True)]
    assert calls[1][0] == scan_body._adjoint_spec(calls[0][0])
    assert all(c.grad is not None and torch.isfinite(c.grad).all()
               for c in coeffs)
    assert scan_body.launch_count == before
    with pytest.raises(RuntimeError, match="ScanBodyFn"):
        real(opacked.clone().requires_grad_(True), ospec, oxs)
    with torch.no_grad():
        real(opacked.clone().requires_grad_(True), ospec, oxs)

