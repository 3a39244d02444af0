"""Circuit-fusion compiler: a gate trace → per-layer super-gates
(``fuse_ops``) or one stacked super-gate body over L layers
(``fuse_ops_stacked``), and their executors.

Counterpart of ``qfedx_tpu/ops/fuse.py``. The IR is a flat list of
``Op`` records — static Python qubit indices, CArray coefficients with
optional leading group axes (and, for the scan form, a leading layer
axis) — and both passes compose it with the reference's greedy
accumulator discipline (pairwise-disjoint footprints, flush on overlap),
so the emitted programs have the reference's kinds, qubits, static
permutations and coefficient shapes. The trace-time numpy statics are
the reference's verbatim.

Executors: ``apply_fused`` (dense ``(*lead, 2, …, 2)`` states),
``apply_fused_b`` (batched ``(B, 2^n)`` slabs) and the gate-by-gate
``apply_ops_unfused``; ``apply_scan`` runs a stacked program on a
batched slab, or on a dense state as its slab (one reshape each way).
The dense route thus reaches ``scan_body.route_ok`` and the scan-body
kernel exactly as the batched route does (one launch at tb = prod(lead);
the reference's dense scan is a vmapped kernel with tb = 1 per sample:
the same math). When ``route_ok`` refuses a program,
``apply_scan`` runs the body as a torch loop over the layers — the
port's counterpart of the reference's ``lax.scan`` route, taken exactly
where the reference takes it (e.g. a stacked ``g1`` at even widths
n ≥ 16).

Routing pins keep the reference's names (QFEDX_FUSE, QFEDX_SCAN_LAYERS)
and default ON — the program the card runs — and the backend gates
``_gather_ok``/``_growmat_merge_ok`` return True, so the CPU tests build
the card's program.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from qfedx_tpu_torch.ops import statevector as sv
from qfedx_tpu_torch.ops.cpx import CArray, RDTYPE, cmul
from qfedx_tpu_torch.ops.statevector import _LANE_BITS, _LANES, _SLAB_MIN
from qfedx_tpu_torch.utils import pins


class Op(NamedTuple):
    """One gate of the trace-level IR: kind ∈ {"g1", "cnot", "g2",
    "diag1", "diag2"}, static qubits, CArray coefficients (None for
    cnot) — (…,2,2) g1, (…,2,2,2,2) g2, (…,2) diag1, (…,2,2) diag2."""

    kind: str
    qubits: tuple
    coeffs: CArray | None = None


class FusedOp(NamedTuple):
    """One op of a per-layer fused program: the IR kinds pass through
    unfused, plus "lane" (composed (…,128,128) lane matrix), "rowpair"
    (merged (…,2,2,2,2) super-gate on two row qubits, qubits sorted) and
    "mask" (precomputed (…,2^n) phase mask)."""

    kind: str
    qubits: tuple
    coeffs: object = None


class StackedOp(NamedTuple):
    """One op of a stacked (scan-form) program. ``stacked`` marks
    coefficients carrying the leading (L, …) layer axis; static ones
    (CNOT qubits, numpy row permutations) apply identically per layer.
    Kinds: "g1", "g2", "cnot", "lane", "rowpair", "mask", "rowmat"
    ((…,R,R)), "rowperm" (static gather map), "glane" ((…,2,128,128),
    qubits[0] the control row qubit) and "growmat" ((…,2,R,R),
    qubits[0] the control lane qubit)."""

    kind: str
    qubits: tuple
    coeffs: object = None
    stacked: bool = False


class ScanProgram(NamedTuple):
    """A fused layer stack: ``pre`` runs once before the layer loop (a
    hoisted boundary head), ``body`` is the per-layer op list."""

    pre: tuple
    body: tuple
    length: int


def fuse_enabled() -> bool:
    """QFEDX_FUSE pins ("1"/"on", "0"/"off"); default on."""
    return pins.bool_pin("QFEDX_FUSE", True)


def fuse_active(n_qubits: int, min_width: int = _SLAB_MIN) -> bool:
    return n_qubits >= min_width and fuse_enabled()


def scan_enabled() -> bool:
    """QFEDX_SCAN_LAYERS pins ("1"/"on", "0"/"off"); default on."""
    return pins.bool_pin("QFEDX_SCAN_LAYERS", True)


def scan_active(
    n_qubits: int, n_layers: int, min_width: int = _SLAB_MIN
) -> bool:
    """The scan route engages on top of an active fusion route, with ≥ 2
    layers to share one body."""
    return (
        n_layers >= 2
        and fuse_active(n_qubits, min_width)
        and scan_enabled()
    )


def _gather_ok() -> bool:
    """May the pass emit gather-applied row permutations ("rowperm")?
    Yes on the card (the kernel gathers rows directly)."""
    return True


def _growmat_merge_ok() -> bool:
    """Fold the HEA wrap CNOT into a "growmat"?  Yes on the card: one op
    fewer per layer in the kernel's sweep."""
    return True


# --- complex composition helpers --------------------------------------------


def _cmatmul(a: CArray, b: CArray) -> CArray:
    """a @ b over the last two axes, broadcasting leading group axes."""
    rr = a.re @ b.re
    if a.im is None and b.im is None:
        return CArray(rr, None)
    if a.im is None:
        return CArray(rr, a.re @ b.im)
    if b.im is None:
        return CArray(rr, a.im @ b.re)
    return CArray(rr - a.im @ b.im, a.re @ b.im + a.im @ b.re)


def _ckron2(a: CArray, b: CArray) -> CArray:
    """super[…,o1,o2,i1,i2] = a[…,o1,i1]·b[…,o2,i2]."""

    def k(x, y):
        return x[..., :, None, :, None] * y[..., None, :, None, :]

    rr = k(a.re, b.re)
    if a.im is None and b.im is None:
        return CArray(rr, None)
    a_im, b_im = a.imag_or_zeros(), b.imag_or_zeros()
    return CArray(rr - k(a_im, b_im), k(a.re, b_im) + k(a_im, b.re))


def _lead_compatible(s1: tuple, s2: tuple) -> bool:
    """Two coefficient stacks compose only if their group axes broadcast."""
    return s1 == s2 or s1 == () or s2 == ()


def _lane_map(coeffs: CArray, build) -> CArray:
    return CArray(
        build(coeffs.re),
        None if coeffs.im is None else build(coeffs.im),
    )


def _lane_g1(coeffs: CArray, p: int) -> CArray:
    """(…,2,2) gate on lane bit p → (…,128,128) Mt."""
    return _lane_map(coeffs, lambda part: sv._lane_mt(part, p))


def _zero_like(vals: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=vals.dtype, device=vals.device)


def _pick2(b1, b2, vals, tail):
    """d[b1, b2] broadcast over the bit grids (``tail`` singleton axes)."""

    def e(r, c):
        return vals[..., r, c][(...,) + (None,) * tail]

    return torch.where(
        b1 == 0,
        torch.where(b2 == 0, e(0, 0), e(0, 1)),
        torch.where(b2 == 0, e(1, 0), e(1, 1)),
    )


def _lane_diag2(coeffs: CArray, p1: int, p2: int) -> CArray:
    """(…,2,2) two-qubit diagonal d[b1,b2] on lane bits (p1,p2) →
    diagonal (…,128,128) matrix."""
    j, l = sv._lane_iota(coeffs.re.device)
    eye = j == l
    b1, b2 = (l >> p1) & 1, (l >> p2) & 1
    return _lane_map(
        coeffs,
        lambda vals: torch.where(
            eye, _pick2(b1, b2, vals, 2), _zero_like(vals)
        ),
    )


def _mask_factor(op: Op, n: int) -> CArray:
    """One diagonal factor broadcast over the flat (…,2^n) index space."""
    idx = torch.arange(1 << n, device=op.coeffs.re.device)
    if op.kind == "diag1":
        bit = (idx >> (n - 1 - op.qubits[0])) & 1
        return _lane_map(
            op.coeffs,
            lambda vals: torch.where(
                bit == 1, vals[..., 1][..., None], vals[..., 0][..., None]
            ),
        )
    b1 = (idx >> (n - 1 - op.qubits[0])) & 1
    b2 = (idx >> (n - 1 - op.qubits[1])) & 1
    return _lane_map(op.coeffs, lambda vals: _pick2(b1, b2, vals, 1))


def _build_mask(facs: list, n: int) -> CArray:
    mask = _mask_factor(facs[0], n)
    for op in facs[1:]:
        mask = cmul(mask, _mask_factor(op, n))
    return mask


def diag1_gate(coeffs: CArray) -> CArray:
    """(…,2) diagonal entries → (…,2,2) gate matrix (off-diagonal zero)."""

    def build(vals):
        z = torch.zeros_like(vals[..., 0])
        return torch.stack(
            [
                torch.stack([vals[..., 0], z], dim=-1),
                torch.stack([z, vals[..., 1]], dim=-1),
            ],
            dim=-2,
        )

    return _lane_map(coeffs, build)


def diag2_gate(coeffs: CArray) -> CArray:
    """(…,2,2) entries d[b1,b2] → (…,2,2,2,2) gate tensor
    G[o1,o2,i1,i2] = d[i1,i2]·δ(o1,i1)·δ(o2,i2)."""
    eye = torch.eye(2, dtype=RDTYPE, device=coeffs.re.device)

    def build(vals):
        return (vals[..., None, None, :, :] * eye[:, None, :, None]
                * eye[None, :, None, :])

    return _lane_map(coeffs, build)


# --- the per-layer fusion pass ----------------------------------------------


def fuse_ops(ops: list, n: int) -> list:
    """Greedy one-pass fusion of an IR trace for an n-qubit state: a
    composed lane matrix, one pending row single and a diagonal run are
    accumulated, and an accumulator is flushed exactly when an op
    overlapping its qubits arrives, so every reorder is between ops on
    disjoint qubits. Lane fusion needs n ≥ 7, row pairs both qubits in
    the row region; anything unfusible passes through unchanged."""
    lane_region = n - _LANE_BITS
    has_lanes = n >= _LANE_BITS
    dev = next(
        (op.coeffs.re.device for op in ops if op.coeffs is not None),
        torch.device("cpu"),
    )

    def is_lane(q: int) -> bool:
        return has_lanes and q >= lane_region

    out: list = []
    lane_acc: CArray | None = None
    lane_qs: set = set()
    row_q: int | None = None
    row_gate: CArray | None = None
    diag_facs: list = []
    diag_qs: set = set()

    def flush_lane():
        nonlocal lane_acc, lane_qs
        if lane_acc is not None:
            out.append(FusedOp("lane", tuple(sorted(lane_qs)), lane_acc))
            lane_acc, lane_qs = None, set()

    def flush_row():
        nonlocal row_q, row_gate
        if row_q is not None:
            out.append(FusedOp("g1", (row_q,), row_gate))
            row_q, row_gate = None, None

    def flush_diag():
        nonlocal diag_facs, diag_qs
        if diag_facs:
            out.append(FusedOp("mask", tuple(sorted(diag_qs)),
                               _build_mask(diag_facs, n)))
            diag_facs, diag_qs = [], set()

    def fold_lane(mt: CArray, qs: set):
        nonlocal lane_acc, lane_qs
        if lane_acc is not None and not _lead_compatible(
            _group_of(lane_acc, False, 2), _group_of(mt, False, 2)
        ):
            flush_lane()
        lane_acc = mt if lane_acc is None else _cmatmul(lane_acc, mt)
        lane_qs |= qs

    for op in ops:
        qs = set(op.qubits)
        if op.kind == "g1":
            q = op.qubits[0]
            if qs & diag_qs:
                flush_diag()
            if is_lane(q):
                fold_lane(_lane_g1(op.coeffs, sv._slab_pos(n, q)), qs)
            elif row_q is None:
                row_q, row_gate = q, op.coeffs
            elif row_q == q:
                if _lead_compatible(_group_of(row_gate, False, 2),
                                    _group_of(op.coeffs, False, 2)):
                    # Sequential A then B on one qubit is the matrix B·A.
                    row_gate = _cmatmul(op.coeffs, row_gate)
                else:
                    flush_row()
                    row_q, row_gate = q, op.coeffs
            elif _lead_compatible(_group_of(row_gate, False, 2),
                                    _group_of(op.coeffs, False, 2)):
                q1, g1_, q2, g2_ = (
                    (row_q, row_gate, q, op.coeffs)
                    if row_q < q
                    else (q, op.coeffs, row_q, row_gate)
                )
                out.append(FusedOp("rowpair", (q1, q2), _ckron2(g1_, g2_)))
                row_q, row_gate = None, None
            else:
                flush_row()
                row_q, row_gate = q, op.coeffs
        elif op.kind == "cnot":
            if qs & diag_qs:
                flush_diag()
            if row_q in qs:
                flush_row()
            if is_lane(op.qubits[0]) and is_lane(op.qubits[1]):
                mt = CArray(sv._lane_perm_cnot(
                    sv._slab_pos(n, op.qubits[0]),
                    sv._slab_pos(n, op.qubits[1]), RDTYPE, dev), None)
                fold_lane(mt, qs)
            else:
                if qs & lane_qs:
                    flush_lane()
                out.append(FusedOp("cnot", op.qubits, None))
        elif op.kind in ("diag1", "diag2"):
            if row_q in qs:
                flush_row()
            if all(is_lane(q) for q in qs) and lane_acc is not None:
                # A lane product is already pending: composing the
                # diagonal in is free; starting one for it is not.
                p = [sv._slab_pos(n, q) for q in op.qubits]
                mt = (
                    _lane_g1(diag1_gate(op.coeffs), p[0])
                    if op.kind == "diag1"
                    else _lane_diag2(op.coeffs, p[0], p[1])
                )
                fold_lane(mt, qs)
            else:
                if qs & lane_qs:
                    flush_lane()
                diag_facs.append(op)
                diag_qs |= qs
        elif op.kind == "g2":
            if qs & diag_qs:
                flush_diag()
            if row_q in qs:
                flush_row()
            if qs & lane_qs:
                flush_lane()
            out.append(FusedOp("g2", op.qubits, op.coeffs))
        else:
            raise ValueError(f"unknown IR op kind {op.kind!r}")
    flush_diag()
    flush_row()
    flush_lane()
    return out


# --- stacked-program helpers ------------------------------------------------

# Row-matrix contraction cap: R ≤ one lane register (n ≤ 14).
_ROWMAT_MAX_BITS = _LANE_BITS
# Grouped coefficient stacks fold into a row matrix only up to this
# group count (a per-sample bank would materialize more matrix than state).
_ROWMAT_GROUP_MAX = 32

_GATE_AXES = {"g1": 2, "g2": 4, "diag1": 1, "diag2": 2}


def _cexpand(c: CArray, axis: int) -> CArray:
    return CArray(
        c.re.unsqueeze(axis), None if c.im is None else c.im.unsqueeze(axis)
    )


def _cslice(c: CArray, sl) -> CArray:
    return CArray(c.re[sl], None if c.im is None else c.im[sl])


def _cconcat(a: CArray, b: CArray) -> CArray:
    im = None
    if a.im is not None or b.im is not None:
        im = torch.cat([a.imag_or_zeros(), b.imag_or_zeros()], dim=0)
    return CArray(torch.cat([a.re, b.re], dim=0), im)


def _align_pair(a: CArray, sa: bool, ga: tuple, b: CArray, sb: bool,
                gb: tuple):
    """Insert singleton group axes so two STACKED coefficient stacks whose
    group ranks differ broadcast (the ()-group one widened after its
    layer axis)."""
    if sa and sb and len(ga) != len(gb):
        if len(ga) < len(gb):
            a = _cexpand(a, 1)
        else:
            b = _cexpand(b, 1)
    return a, b


def _group_of(c: CArray, stacked: bool, trailing: int) -> tuple:
    lead = tuple(c.re.shape[: c.re.ndim - trailing])
    return lead[1:] if stacked else lead


def _const(arr: np.ndarray, device) -> CArray:
    """A trace-time numpy static as a real CArray on ``device``."""
    return CArray(torch.as_tensor(arr, dtype=RDTYPE, device=device), None)


def _row_iota(rbits: int, device):
    size = 1 << rbits
    j = torch.arange(size, device=device)[:, None].expand(size, size)
    l = torch.arange(size, device=device)[None, :].expand(size, size)
    return j, l


def _row_g1_mt(coeffs: CArray, p: int, rbits: int) -> CArray:
    """(…,2,2) gate on row bit p → (…,R,R) LEFT-multiply matrix:
    M[r,r'] = gate[bit_r(p), bit_r'(p)] where all other bits agree."""
    j, l = _row_iota(rbits, coeffs.re.device)
    size = 1 << rbits
    other_ok = ((j ^ l) & (size - 1 - (1 << p))) == 0
    bj, bl = (j >> p) & 1, (l >> p) & 1
    return _lane_map(
        coeffs,
        lambda part: torch.where(
            other_ok, _pick2(bj, bl, part, 2), _zero_like(part)
        ),
    )


def _row_diag2_mt(coeffs: CArray, p1: int, p2: int, rbits: int) -> CArray:
    """(…,2,2) diagonal d[b1,b2] on row bits (p1,p2) → (…,R,R)."""
    j, l = _row_iota(rbits, coeffs.re.device)
    eye = j == l
    b1, b2 = (l >> p1) & 1, (l >> p2) & 1
    return _lane_map(
        coeffs,
        lambda vals: torch.where(
            eye, _pick2(b1, b2, vals, 2), _zero_like(vals)
        ),
    )


def _row_pos(rbits: int, qubit: int) -> int:
    """Bit position of row ``qubit`` in the row index (qubit 0 = MSB)."""
    return rbits - 1 - qubit


def _ckron_step(a: CArray, b: CArray) -> CArray:
    """kron(a (…,s,s), b (…,2,2)) → (…,2s,2s): b's bit appends BELOW
    a's bits; leading group axes broadcast."""

    def k(x, y):
        z = x[..., :, None, :, None] * y[..., None, :, None, :]
        s = x.shape[-1] * y.shape[-1]
        return z.reshape(z.shape[:-4] + (s, s))

    rr = k(a.re, b.re)
    if a.im is None and b.im is None:
        return CArray(rr, None)
    a_im, b_im = a.imag_or_zeros(), b.imag_or_zeros()
    return CArray(rr - k(a_im, b_im), k(a.re, b_im) + k(a_im, b.re))


def _ctranspose(c: CArray) -> CArray:
    return CArray(
        c.re.transpose(-1, -2),
        None if c.im is None else c.im.transpose(-1, -2),
    )


def _kron_matrix(bank: dict, nbits: int, transpose: bool = False) -> CArray:
    """(…,S,S) matrix of a bank of single-bit gates on distinct bit
    positions, as a hierarchical kron (identity on uncovered bits).
    ``transpose`` builds the RIGHT-multiply (lane) orientation; default
    is the LEFT-multiply (row) orientation."""
    device = next(iter(bank.values())).re.device
    eye2 = CArray(torch.eye(2, dtype=RDTYPE, device=device), None)
    out = None
    for p in range(nbits - 1, -1, -1):  # MSB first: bit p sits above p-1
        g = bank.get(p)
        if g is None:
            f = eye2
        else:
            f = _ctranspose(g) if transpose else g
        if out is None:
            out = f
        else:
            ga = _group_of(out, True, 2) if out.re.ndim > 2 else ()
            gb = _group_of(f, True, 2) if f.re.ndim > 2 else ()
            a, b = _align_pair(
                out, out.re.ndim > 2, ga, f, f.re.ndim > 2, gb
            )
            out = _ckron_step(a, b)
    return out


def _np_perm_mt(tgt: np.ndarray) -> np.ndarray:
    """Static RIGHT-multiply permutation matrix: Mt[j,l] = δ(l = tgt(j))."""
    return np.eye(len(tgt), dtype=np.float32)[tgt]


def _np_lane_cnot(pc: int, pt: int) -> np.ndarray:
    j = np.arange(_LANES)
    return _np_perm_mt(np.where(((j >> pc) & 1) == 1, j ^ (1 << pt), j))


def _np_lane_flip(p: int) -> np.ndarray:
    return _np_perm_mt(np.arange(_LANES) ^ (1 << p))


def _row_cnot_sigma(pc: int, pt: int, rbits: int) -> np.ndarray:
    """Gather map of a row-row CNOT: out[r] = in[σ(r)]."""
    r = np.arange(1 << rbits)
    return np.where(((r >> pc) & 1) == 1, r ^ (1 << pt), r)


def _sigma_matrix(sigma: np.ndarray, device) -> CArray:
    """Permutation gather map → static LEFT-multiply (R,R) matrix."""
    return _const(np.eye(len(sigma), dtype=np.float32)[sigma], device)


# --- the stacked fusion pass ------------------------------------------------


def fuse_ops_stacked(ops: list, n: int, length: int) -> ScanProgram:
    """Fuse a layer-stacked IR trace into one scanned super-gate body.

    ``ops`` is ONE layer's trace with every coefficient carrying a
    leading layer axis of size ``length``; CNOTs are layer-constant.
    The accumulator discipline, contraction mechanisms (row matrices,
    row permutations, boundary-CNOT lane-pair absorption, cross-layer
    boundary merge) and emission order are the reference's."""
    rbits = n - _LANE_BITS
    has_lanes = n >= _LANE_BITS
    rowmat_on = 1 <= rbits <= _ROWMAT_MAX_BITS
    dev = next(
        (op.coeffs.re.device for op in ops if op.coeffs is not None),
        torch.device("cpu"),
    )

    def is_lane(q: int) -> bool:
        return has_lanes and q >= rbits

    def stack_group(op: Op) -> tuple:
        trailing = _GATE_AXES[op.kind]
        if op.coeffs.re.ndim < trailing + 1:
            raise ValueError(
                f"scan trace coefficient for {op.kind} on {op.qubits} "
                f"has rank {op.coeffs.re.ndim}, expected a leading "
                f"layer axis before the {trailing} gate axes"
            )
        g = _group_of(op.coeffs, True, trailing)
        if op.coeffs.re.shape[0] != length:
            raise ValueError(
                f"scan trace coefficient for {op.kind} on {op.qubits} has "
                f"leading axis {op.coeffs.re.shape[0]}, expected the "
                f"layer count {length}"
            )
        return g

    out: list[StackedOp] = []
    pend: list[dict] = []  # creation-ordered accumulators

    def flush(pred):
        nonlocal pend
        keep = []
        for acc in pend:
            if pred(acc):
                op = acc["emit"]()
                if op is not None:
                    out.append(op)
            else:
                keep.append(acc)
        pend = keep

    def flush_overlap(qs: set, keep: dict | None):
        flush(lambda acc: acc is not keep and acc["qs"] & qs)

    def find(tag: str) -> dict | None:
        for acc in pend:
            if acc["tag"] == tag:
                return acc
        return None

    # -- lane accumulator: s @ [bank kron | mat] @ static ---------------
    def lane_new(group: tuple) -> dict:
        acc = {
            "tag": "lane", "qs": set(), "bank": {}, "mat": None,
            "static": None, "ctrl": None, "group": group,
            "mat_ctrl": False,
        }

        def emit_lane(a=acc):
            traced = a["mat"]
            if traced is None and a["bank"]:
                traced = _kron_matrix(a["bank"], _LANE_BITS, transpose=True)
            ctrl = a["ctrl"]
            lanes = tuple(sorted(q for q in a["qs"] if q != ctrl))
            qubits = ((ctrl,) if ctrl is not None else ()) + lanes
            kind = "lane" if ctrl is None else "glane"
            if traced is None:
                if a["static"] is None:
                    return None
                return StackedOp(kind, qubits, _const(a["static"], dev),
                                 False)
            if a["static"] is not None:
                static = _const(a["static"], dev)
                if ctrl is not None and not a["mat_ctrl"] and (
                    static.re.ndim == 3
                ):
                    traced = _cexpand(traced, -3)
                traced = _cmatmul(traced, static)
            return StackedOp(kind, qubits, traced, True)

        acc["emit"] = emit_lane
        pend.append(acc)
        return acc

    def _lane_collapse(acc: dict):
        """bank/static → one traced matrix, for matmul-composed folds."""
        traced = acc["mat"]
        if traced is None and acc["bank"]:
            traced = _kron_matrix(acc["bank"], _LANE_BITS, transpose=True)
            acc["bank"] = {}
        if acc["static"] is not None:
            t = _const(acc["static"], dev)
            if traced is None:
                traced = t
            else:
                if (
                    acc["ctrl"] is not None
                    and not acc["mat_ctrl"]
                    and t.re.ndim == 3
                ):
                    traced = _cexpand(traced, -3)
                traced = _cmatmul(traced, t)
            acc["static"] = None
            if acc["ctrl"] is not None:
                acc["mat_ctrl"] = True
        acc["mat"] = traced

    def lane_get(group: tuple) -> dict:
        acc = find("lane")
        if acc is not None and not _lead_compatible(acc["group"], group):
            flush(lambda a: a is acc)
            acc = None
        if acc is None:
            acc = lane_new(group)
        acc["group"] = group if acc["group"] == () else acc["group"]
        return acc

    def lane_fold_g1(coeffs: CArray, group: tuple, qs: set, pos: int):
        acc = lane_get(group)
        if acc["static"] is None and acc["mat"] is None:
            if pos in acc["bank"]:
                old = acc["bank"][pos]
                a, b = _align_pair(
                    coeffs, True, _group_of(coeffs, True, 2),
                    old, True, _group_of(old, True, 2),
                )
                acc["bank"][pos] = _cmatmul(a, b)  # A then B ⇒ B·A (2×2)
            else:
                acc["bank"][pos] = coeffs
        else:
            _lane_collapse(acc)
            mt = _lane_g1(coeffs, pos)
            if acc["mat_ctrl"]:
                mt = _cexpand(mt, -3)
            a, b = _align_pair(
                acc["mat"], True, acc["group"], mt, True, group
            )
            acc["mat"] = _cmatmul(a, b)
        acc["qs"] |= qs

    def lane_fold_static(p_np: np.ndarray, qs: set):
        acc = lane_get(())
        t = acc["static"]
        acc["static"] = p_np if t is None else t @ p_np
        acc["qs"] |= qs

    def lane_fold_ctrl(ctrl_q: int, p_np: np.ndarray, qs: set):
        acc = lane_get(())
        if acc["ctrl"] is not None and acc["ctrl"] != ctrl_q:
            flush(lambda a: a is acc)
            acc = lane_get(())
        pair = np.stack([np.eye(_LANES, dtype=np.float32), p_np])
        t = acc["static"]
        if acc["ctrl"] is None:
            acc["static"] = (
                pair if t is None else np.einsum("lk,xkm->xlm", t, pair)
            )
            acc["ctrl"] = ctrl_q
        else:
            # t can be None: a collapse moved an earlier pair into mat.
            acc["static"] = pair if t is None else t @ pair
        acc["qs"] |= qs | {ctrl_q}

    def lane_fold_mt(mt: CArray, group: tuple, qs: set):
        """Matmul-composed traced fold (diag2) — collapse first."""
        acc = lane_get(group)
        _lane_collapse(acc)
        if acc["mat"] is None:
            acc["mat"] = mt
        else:
            if acc["mat_ctrl"]:
                mt = _cexpand(mt, -3)
            a, b = _align_pair(
                acc["mat"], True, acc["group"], mt, True, group
            )
            acc["mat"] = _cmatmul(a, b)
        acc["qs"] |= qs

    # -- row-matrix accumulator: sigma ∘ [bank kron | mat] --------------
    def row_new(group: tuple) -> dict:
        acc = {
            "tag": "rowmat", "qs": set(), "bank": {}, "mat": None,
            "sigma": None, "group": group,
        }

        def emit_row(a=acc):
            traced = a["mat"]
            if traced is None and a["bank"]:
                traced = _kron_matrix(a["bank"], rbits)
            qubits = tuple(sorted(a["qs"]))
            if traced is None:
                if a["sigma"] is None:
                    return None
                if _gather_ok():
                    return StackedOp("rowperm", qubits, a["sigma"], False)
                return StackedOp(
                    "rowmat", qubits, _sigma_matrix(a["sigma"], dev), False
                )
            if a["sigma"] is not None:
                traced = _cmatmul(_sigma_matrix(a["sigma"], dev), traced)
            return StackedOp("rowmat", qubits, traced, True)

        acc["emit"] = emit_row
        pend.append(acc)
        return acc

    def row_get(group: tuple) -> dict:
        acc = find("rowmat")
        if acc is not None and not _lead_compatible(acc["group"], group):
            flush(lambda a: a is acc)
            acc = None
        if acc is None:
            acc = row_new(group)
        acc["group"] = group if acc["group"] == () else acc["group"]
        return acc

    def _row_collapse(acc: dict):
        traced = acc["mat"]
        if traced is None and acc["bank"]:
            traced = _kron_matrix(acc["bank"], rbits)
            acc["bank"] = {}
        if acc["sigma"] is not None:
            sig = _sigma_matrix(acc["sigma"], dev)
            traced = sig if traced is None else _cmatmul(sig, traced)
            acc["sigma"] = None
        acc["mat"] = traced

    def row_fold_g1(coeffs: CArray, group: tuple, qs: set, pos: int):
        acc = row_get(group)
        if acc["sigma"] is None and acc["mat"] is None:
            if pos in acc["bank"]:
                old = acc["bank"][pos]
                a, b = _align_pair(
                    coeffs, True, _group_of(coeffs, True, 2),
                    old, True, _group_of(old, True, 2),
                )
                acc["bank"][pos] = _cmatmul(a, b)
            else:
                acc["bank"][pos] = coeffs
        else:
            _row_collapse(acc)
            a, b = _align_pair(
                _row_g1_mt(coeffs, pos, rbits), True, group,
                acc["mat"], True, acc["group"],
            )
            acc["mat"] = _cmatmul(a, b)  # A then B ⇒ B@A
        acc["qs"] |= qs

    def row_fold_sigma(sigma: np.ndarray, qs: set):
        acc = row_get(())
        # σ1 then σ2 gathers as combined[r] = σ1[σ2[r]].
        acc["sigma"] = sigma if acc["sigma"] is None else acc["sigma"][sigma]
        acc["qs"] |= qs

    def row_fold_mt(mt: CArray, group: tuple, qs: set):
        acc = row_get(group)
        _row_collapse(acc)
        if acc["mat"] is None:
            acc["mat"] = mt
        else:
            a, b = _align_pair(
                mt, True, group, acc["mat"], True, acc["group"]
            )
            acc["mat"] = _cmatmul(a, b)
        acc["qs"] |= qs

    # -- row single/pair accumulator (past the rowmat cap) --------------
    def rowsingle_fold(q: int, coeffs: CArray, group: tuple):
        acc = find("rowsingle")
        if acc is None:
            acc = {
                "tag": "rowsingle", "qs": {q}, "coeffs": coeffs,
                "stacked": True, "group": group, "q": q,
            }
            acc["emit"] = lambda a=acc: StackedOp(
                "g1", (a["q"],), a["coeffs"], True
            )
            pend.append(acc)
            return
        if acc["q"] == q:
            if _lead_compatible(acc["group"], group):
                a, b = _align_pair(
                    coeffs, True, group,
                    acc["coeffs"], acc["stacked"], acc["group"],
                )
                acc["coeffs"] = _cmatmul(a, b)  # B·A
                acc["group"] = group if acc["group"] == () else acc["group"]
            else:
                flush(lambda a: a is acc)
                rowsingle_fold(q, coeffs, group)
            return
        if _lead_compatible(acc["group"], group):
            q1, g1_, gr1, q2, g2_, gr2 = (
                (acc["q"], acc["coeffs"], acc["group"], q, coeffs, group)
                if acc["q"] < q
                else (q, coeffs, group, acc["q"], acc["coeffs"], acc["group"])
            )
            a, b = _align_pair(g1_, True, gr1, g2_, True, gr2)
            out.append(StackedOp("rowpair", (q1, q2), _ckron2(a, b), True))
            pend.remove(acc)
        else:
            flush(lambda a: a is acc)
            rowsingle_fold(q, coeffs, group)

    # -- diagonal chain --
    def diag_fold(op: Op, qs: set, group: tuple):
        acc = find("diag")
        if acc is not None and not _lead_compatible(acc["group"], group):
            flush(lambda a: a is acc)
            acc = None
        if acc is None:
            acc = {
                "tag": "diag", "qs": set(qs), "facs": [op], "group": group,
            }

            def emit_diag(a=acc):
                # Widen shared (L,2^n) factors after the layer axis so
                # they broadcast against grouped (L,G,2^n) ones.
                masks = [_mask_factor(f, n) for f in a["facs"]]
                rank = max(m.re.ndim for m in masks)
                masks = [
                    _cexpand(m, 1) if m.re.ndim < rank else m
                    for m in masks
                ]
                mask = masks[0]
                for m in masks[1:]:
                    mask = cmul(mask, m)
                return StackedOp("mask", tuple(sorted(a["qs"])), mask, True)

            acc["emit"] = emit_diag
            pend.append(acc)
            return
        acc["facs"].append(op)
        acc["qs"] |= qs
        acc["group"] = group if acc["group"] == () else acc["group"]

    def row_group_ok(group: tuple) -> bool:
        return group == () or int(np.prod(group)) <= _ROWMAT_GROUP_MAX

    for op in ops:
        qs = set(op.qubits)
        if op.kind == "g1":
            q = op.qubits[0]
            group = stack_group(op)
            if is_lane(q):
                flush_overlap(qs, find("lane"))
                lane_fold_g1(op.coeffs, group, qs, sv._slab_pos(n, q))
            elif rowmat_on and row_group_ok(group):
                flush_overlap(qs, find("rowmat"))
                row_fold_g1(op.coeffs, group, qs, _row_pos(rbits, q))
            else:
                flush_overlap(qs, find("rowsingle"))
                rowsingle_fold(q, op.coeffs, group)
        elif op.kind == "cnot":
            c_, t_ = op.qubits
            if is_lane(c_) and is_lane(t_):
                flush_overlap(qs, find("lane"))
                lane_fold_static(
                    _np_lane_cnot(sv._slab_pos(n, c_), sv._slab_pos(n, t_)),
                    qs,
                )
            elif not is_lane(c_) and not is_lane(t_):
                if not rowmat_on and not _gather_ok():
                    flush_overlap(qs, None)
                    out.append(StackedOp("cnot", op.qubits, None, False))
                else:
                    sigma = _row_cnot_sigma(
                        _row_pos(rbits, c_), _row_pos(rbits, t_), rbits
                    )
                    flush_overlap(qs, find("rowmat"))
                    row_fold_sigma(sigma, qs)
            elif not is_lane(c_):  # row control → lane target
                flush_overlap(qs | {c_}, find("lane"))
                lane_fold_ctrl(c_, _np_lane_flip(sv._slab_pos(n, t_)), {t_})
            else:  # lane control → row target: a 1-pass engine op
                flush_overlap(qs, None)
                out.append(StackedOp("cnot", op.qubits, None, False))
        elif op.kind in ("diag1", "diag2"):
            group = stack_group(op)
            if all(is_lane(q) for q in qs) and find("lane") is not None:
                flush_overlap(qs, find("lane"))
                if op.kind == "diag1":
                    lane_fold_g1(
                        diag1_gate(op.coeffs), group, qs,
                        sv._slab_pos(n, op.qubits[0]),
                    )
                else:
                    p = [sv._slab_pos(n, q) for q in op.qubits]
                    lane_fold_mt(
                        _lane_diag2(op.coeffs, p[0], p[1]), group, qs
                    )
            elif (
                rowmat_on
                and all(not is_lane(q) for q in qs)
                and find("rowmat") is not None
                and row_group_ok(group)
            ):
                flush_overlap(qs, find("rowmat"))
                if op.kind == "diag1":
                    row_fold_g1(
                        diag1_gate(op.coeffs), group, qs,
                        _row_pos(rbits, op.qubits[0]),
                    )
                else:
                    p = [_row_pos(rbits, q) for q in op.qubits]
                    row_fold_mt(
                        _row_diag2_mt(op.coeffs, p[0], p[1], rbits),
                        group, qs,
                    )
            else:
                flush_overlap(qs, find("diag"))
                diag_fold(op, qs, group)
        elif op.kind == "g2":
            stack_group(op)
            flush_overlap(qs, None)
            out.append(StackedOp("g2", op.qubits, op.coeffs, True))
        else:
            raise ValueError(f"unknown IR op kind {op.kind!r}")
    flush(lambda acc: True)

    pre, body = _merge_scan_boundary(out, n, length)
    return ScanProgram(tuple(pre), tuple(body), length)


# Cross-layer boundary composition rules: how a body's TAIL op composes
# with the NEXT layer's HEAD of the same kind.
_BOUNDARY_COMPOSE = {
    "mask": lambda tail, head: cmul(tail, head),
    "lane": lambda tail, head: _cmatmul(tail, head),
    "rowmat": lambda tail, head: _cmatmul(head, tail),
}


def _merge_scan_boundary(body: list, n: int, length: int):
    """Cross-layer contraction at the scan boundary: fold layer l's tail
    into layer l+1's head (tail[l] ∘ head[l+1]) and hoist layer 0's head
    before the loop. HEA special case first: a tail wrap CNOT (lane
    control → row target) absorbs into the next layer's head row matrix
    as a lane-bit-selected pair ("growmat")."""
    if length < 2 or len(body) < 2:
        return [], body
    head, tail = body[0], body[-1]
    rbits = n - _LANE_BITS
    if (
        _growmat_merge_ok()
        and head.kind == "rowmat"
        and head.stacked
        and tail.kind == "cnot"
        and len(tail.qubits) == 2
        and tail.qubits[0] >= rbits > tail.qubits[1]
    ):
        ctrl, tgt = tail.qubits
        dev = head.coeffs.re.device
        flip = _sigma_matrix(
            np.arange(1 << rbits) ^ (1 << _row_pos(rbits, tgt)), dev
        )
        eye = CArray(
            torch.eye(1 << rbits, dtype=RDTYPE, device=dev).expand(
                (1,) + tuple(head.coeffs.re.shape[1:])
            ),
            None,
        )
        r_next = _cconcat(_cslice(head.coeffs, slice(1, None)), eye)
        flipped = _cmatmul(r_next, flip)  # CNOT first, then rowmat: R@F

        def stk(g0, g1):
            return torch.stack([g0, g1], dim=-3)

        im = None
        if r_next.im is not None or flipped.im is not None:
            im = stk(r_next.imag_or_zeros(), flipped.imag_or_zeros())
        grow = CArray(stk(r_next.re, flipped.re), im)
        qubits = (ctrl,) + tuple(sorted(set(head.qubits) | {tgt}))
        pre = [StackedOp("rowmat", head.qubits,
                         _cslice(head.coeffs, 0), False)]
        merged = list(body[1:-1]) + [StackedOp("growmat", qubits, grow, True)]
        return pre, merged
    if (
        head.kind != tail.kind
        or head.kind not in _BOUNDARY_COMPOSE
        or not (head.stacked and tail.stacked)
    ):
        return [], body
    trailing = 1 if head.kind == "mask" else 2
    gh = _group_of(head.coeffs, True, trailing)
    gt = _group_of(tail.coeffs, True, trailing)
    if not _lead_compatible(gh, gt):
        return [], body
    t_most, h_next = _align_pair(
        _cslice(tail.coeffs, slice(0, length - 1)), True, gt,
        _cslice(head.coeffs, slice(1, None)), True, gh,
    )
    composed = _BOUNDARY_COMPOSE[head.kind](t_most, h_next)
    last = _cslice(tail.coeffs, slice(length - 1, None))
    if last.re.shape[1:] != composed.re.shape[1:]:
        # Mixed groups: broadcast the uncomposed final tail layer to the
        # composed slices' group shape (the shared matrix applies
        # identically to every group).
        while last.re.ndim < composed.re.ndim:
            last = _cexpand(last, 1)
        tgt = (1,) + tuple(composed.re.shape[1:])
        last = CArray(
            last.re.expand(tgt),
            None if last.im is None else last.im.expand(tgt),
        )
    combined = _cconcat(composed, last)
    qubits = tuple(sorted(set(head.qubits) | set(tail.qubits)))
    pre = [StackedOp(head.kind, head.qubits,
                     _cslice(head.coeffs, 0), False)]
    merged = list(body[1:-1]) + [StackedOp(tail.kind, qubits, combined, True)]
    return pre, merged


# --- executors --------------------------------------------------------------


def _exec_stacked(state: CArray, n: int, op, batched: bool) -> CArray:
    """Run ONE (layer-sliced) op of a fused or stacked program on the
    batched slab engine (a dense state gets here only as its slab)."""
    if not batched:
        raise ValueError("run a dense state as its slab (sv.to_slab)")
    from qfedx_tpu_torch.ops import batched as bt

    if op.kind == "g1":
        return bt.apply_gate_b(state, n, op.coeffs, op.qubits[0])
    if op.kind == "cnot":
        return bt.apply_cnot_b(state, n, *op.qubits)
    if op.kind == "lane":
        return bt.apply_lane_matrix_b(state, n, op.coeffs)
    if op.kind == "rowpair":
        return bt.apply_rowpair_b(state, n, op.coeffs, *op.qubits)
    if op.kind == "mask":
        return bt.apply_phase_mask_b(state, n, op.coeffs)
    if op.kind == "rowmat":
        return bt.apply_row_matrix_b(state, n, op.coeffs)
    if op.kind == "rowperm":
        return bt.apply_row_perm_b(state, n, op.coeffs)
    if op.kind == "glane":
        return bt.apply_lane_matrix_ctrl_b(state, n, op.coeffs, op.qubits[0])
    if op.kind == "growmat":
        return bt.apply_row_matrix_ctrl_b(state, n, op.coeffs, op.qubits[0])
    raise ValueError(f"op kind {op.kind!r} has no batched executor")


def apply_fused(state: CArray, fused: list, n: int | None = None) -> CArray:
    """Run a ``fuse_ops`` program on a dense (*lead, 2, …, 2) state
    (``n`` defaults to ``state.ndim``) with the dense engine's entry
    points (a row pair is a 2-qubit gate); grouped coefficients
    left-align with the leading axes."""
    n = state.ndim if n is None else n
    for op in fused:
        if op.kind == "g1":
            state = sv.apply_gate(state, op.coeffs, op.qubits[0], n)
        elif op.kind == "cnot":
            state = sv.apply_cnot(state, *op.qubits, n=n)
        elif op.kind in ("g2", "rowpair"):
            state = sv.apply_gate_2q(state, op.coeffs, *op.qubits, n=n)
        elif op.kind == "lane":
            state = sv.apply_lane_matrix(state, op.coeffs, n)
        elif op.kind == "mask":
            state = sv.apply_phase_mask(state, op.coeffs, n)
        else:
            raise ValueError(f"unknown fused op kind {op.kind!r}")
    return state


def apply_fused_b(state: CArray, n: int, fused: list) -> CArray:
    """Run a ``fuse_ops`` program on a batched (B, 2^n) slab; grouped
    (G,…) stacks apply per contiguous row group."""
    for op in fused:
        state = _exec_stacked(state, n, op, True)
    return state


def apply_ops_unfused(state: CArray, ops: list, n: int | None = None
                      ) -> CArray:
    """Gate-by-gate executor of an IR trace on a dense state — the
    baseline the fused programs are held against (diagonals apply as
    ordinary gates with zero off-diagonals)."""
    n = state.ndim if n is None else n
    for op in ops:
        if op.kind == "g1":
            state = sv.apply_gate(state, op.coeffs, op.qubits[0], n)
        elif op.kind == "cnot":
            state = sv.apply_cnot(state, *op.qubits, n=n)
        elif op.kind == "g2":
            state = sv.apply_gate_2q(state, op.coeffs, *op.qubits, n=n)
        elif op.kind == "diag1":
            state = sv.apply_gate(state, diag1_gate(op.coeffs),
                                  op.qubits[0], n)
        elif op.kind == "diag2":
            state = sv.apply_gate_2q(state, diag2_gate(op.coeffs),
                                     *op.qubits, n=n)
        else:
            raise ValueError(f"unknown IR op kind {op.kind!r}")
    return state


def layer_slice(op: StackedOp, layer: int) -> StackedOp:
    """``op`` with layer ``layer``'s coefficients (static ops as-is)."""
    if not op.stacked:
        return op
    return StackedOp(op.kind, op.qubits, _cslice(op.coeffs, layer), False)


def apply_scan(state: CArray, n: int, program: ScanProgram,
               batched: bool = False) -> CArray:
    """Run a stacked fused program over its layer axis: as ONE scan-body
    kernel sweep when ``scan_body.route_ok`` accepts the program (the
    reference's Pallas branch), else as a torch loop over the layers
    (the reference's ``lax.scan`` branch). The imaginary part is
    materialized up front, as there. A dense state runs as its batched
    slab (one group axis at most on the coefficients)."""
    from qfedx_tpu_torch.ops import scan_body

    if not batched:
        lead = tuple(state.shape[: state.ndim - n])
        out = apply_scan(sv.to_slab(state, n), n, program, batched=True)
        return sv.from_slab(out, lead, n)
    if scan_body.route_ok(state, n, program, batched):
        return scan_body.apply_scan_pallas(state, n, program, batched)
    state = CArray(state.re, state.imag_or_zeros())
    for op in program.pre:
        state = _exec_stacked(state, n, op, batched)
    for layer in range(program.length):
        for op in program.body:
            state = _exec_stacked(state, n, layer_slice(op, layer), batched)
    return state
