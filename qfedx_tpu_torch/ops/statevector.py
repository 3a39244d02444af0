"""Dense statevector engine, slab-layout constants and lane matrices.

Counterpart of ``qfedx_tpu/ops/statevector.py``.

**The dense engine.** A state is a CArray of shape ``(*lead, 2, …, 2)``:
the last ``n`` axes are the qubits (qubit k is axis ``len(lead) + k``)
and the leading axes are batch or client axes. The reference reads
``n = state.ndim`` and batches with ``jax.vmap``; here every function
takes ``n`` (default: ``state.ndim``, one state with no leading axes)
and broadcasts the leading axes, so vmap becomes broadcasting. A gate's
own leading (group) axes LEFT-align with the state's: a per-client
(C, 2, 2) stack meets a (C, B, 2, …, 2) state as (C, 1, 2, 2), each
client's gate on its own rows.

Gates apply in the reference's "flip" form (its card program): a 2×2
gate as ``out[i] = U[i,i]·s[i] + U[i,1−i]·s[1−i]`` on the halves of an
``(…, a, 2, c)`` view, a CNOT as a select of swapped halves. The
reference's other form, "dot" (2×2 contractions), exists there for
XLA:CPU compile times and is not ported: the tests hold this form
against the reference's "dot" below the slab widths. Gates are built in
f32 and cast to the state's dtype and device (``_cast_gate``), so a bf16
state stays bf16; readouts accumulate in f32.

At the slab widths (n ≥ ``_SLAB_MIN``) a contiguous dense state IS the
batched engine's ``(prod(lead), 2^n)`` slab: the ansatz and the fused
programs reshape it once and run ``ops/batched.py`` there; the per-axis
gate and CNOT forms here work at every width.

**The slab layout.** States with n ≥ ``_SLAB_MIN`` qubits are (R, 128) =
(2^{n-7}, 2^7) row-major views: qubits n−7…n−1 live in the 128-lane minor
dim, qubits 0…n−8 in the row dim. Lane-qubit gates are (R,128)×(128,128)
products against small structured matrices built here; row-qubit gates
flip and select along leading axes (``ops/batched.py``).
"""

from __future__ import annotations

import math

import torch

from qfedx_tpu_torch.ops.cpx import CArray, state_dtype
from qfedx_tpu_torch.utils import pins

_SLAB_MIN = 10
_LANES = 128
_LANE_BITS = 7


def _slab_pos(n: int, qubit: int) -> int:
    """Lane-bit position of qubit (valid when qubit ≥ n−7): qubit n−1 is
    lane bit 0 (row-major flat index, axis 0 = MSB)."""
    return n - 1 - qubit


def _row_split(n: int, qubit: int) -> tuple:
    """(a, 2, c, 128) view dims splitting the row index at ``qubit``."""
    rbits = n - _LANE_BITS
    return (1 << qubit, 2, 1 << (rbits - qubit - 1), _LANES)


def _lane_iota(device=None):
    j = torch.arange(_LANES, device=device)[:, None].expand(_LANES, _LANES)
    l = torch.arange(_LANES, device=device)[None, :].expand(_LANES, _LANES)
    return j, l


def _lane_mt(part: torch.Tensor, p: int) -> torch.Tensor:
    """(…,128,128) Mt with (s @ Mt) applying the 2×2 ``part`` on lane bit
    p: Mt[j,l] = part[bit_l(p), bit_j(p)] where all other bits of j,l
    agree. Leading (…) axes of ``part`` broadcast (layer/group stacks)."""
    j, l = _lane_iota(part.device)
    other_ok = ((j ^ l) & (_LANES - 1 - (1 << p))) == 0
    bj = (j >> p) & 1
    bl = (l >> p) & 1

    def elem(r, c):
        return part[..., r, c][..., None, None]

    val = torch.where(
        bl == 0,
        torch.where(bj == 0, elem(0, 0), elem(0, 1)),
        torch.where(bj == 0, elem(1, 0), elem(1, 1)),
    )
    return torch.where(other_ok, val, torch.zeros((), dtype=part.dtype,
                                                  device=part.device))


def _lane_perm_flip(p: int, dtype, device=None) -> torch.Tensor:
    """(128,128) symmetric permutation: lane l ← lane l ^ (1<<p)."""
    j, l = _lane_iota(device)
    return (j == (l ^ (1 << p))).to(dtype)


def _lane_perm_cnot(pc: int, pt: int, dtype, device=None) -> torch.Tensor:
    """(128,128) Mt for CNOT with control lane-bit pc, target pt."""
    j, l = _lane_iota(device)
    tgt = torch.where(((j >> pc) & 1) == 1, j ^ (1 << pt), j)
    return (l == tgt).to(dtype)


# --- the dense engine --------------------------------------------------------


def _width(state: CArray, n: int | None) -> int:
    return state.ndim if n is None else n


def _lead(state: CArray, n: int) -> tuple:
    return tuple(state.shape[: state.ndim - n])


def _creshape(c: CArray, shape) -> CArray:
    return CArray(
        c.re.reshape(shape), None if c.im is None else c.im.reshape(shape)
    )


def _align(t: torch.Tensor, trailing: int, lead_nd: int,
           mid: int = 0) -> torch.Tensor:
    """``t`` = (*g, *gate) with ``trailing`` gate axes: singleton axes
    after the group axes g so that they left-align with ``lead_nd``
    leading state axes, plus ``mid`` more before the gate axes."""
    g = t.ndim - trailing
    if g > lead_nd:
        raise ValueError(
            f"coefficients with {g} group axes for a state with "
            f"{lead_nd} leading axes"
        )
    return t.reshape(
        tuple(t.shape[:g]) + (1,) * (lead_nd - g + mid) + tuple(t.shape[g:])
    )


def _clin(mm, state: CArray, m: CArray, shape) -> CArray:
    from qfedx_tpu_torch.ops.batched import _clin as clin

    return clin(mm, state, m.re, m.im, shape)


def _cast_gate(gate: CArray, state: CArray) -> CArray:
    """The gate in the state's dtype and on its device: a bf16 state
    times an f32 gate would promote to f32, so the state would leave
    bf16; parameter gradients flow back through the cast to f32."""
    dt, dev = state.re.dtype, state.re.device
    if gate.re.dtype == dt and gate.re.device == dev:
        return gate
    return CArray(
        gate.re.to(dev, dt), None if gate.im is None else gate.im.to(dev, dt)
    )


def zero_state(n_qubits: int, lead: tuple = (), device=None) -> CArray:
    """|0…0⟩ of shape (*lead, 2, …, 2) in the state dtype (real)."""
    re = torch.zeros(tuple(lead) + (1 << n_qubits,), dtype=state_dtype(),
                     device=pins.resolve_device(device))
    re[..., 0] = 1.0
    return CArray(re.reshape(tuple(lead) + (2,) * n_qubits), None)


def product_state(amps: CArray) -> CArray:
    """Tensor product of per-qubit 2-vectors: (*lead, n, 2) → (*lead, 2,
    …, 2), by sequential outer products, qubit 0 first (the reference's
    order, so f32 amplitudes match to rounding)."""
    from qfedx_tpu_torch.ops.batched import bstate_product

    lead, n = tuple(amps.shape[:-2]), amps.shape[-2]
    flat = _creshape(amps, (math.prod(lead), n, 2))
    return _creshape(bstate_product(flat), lead + (2,) * n)


def _flip_1q(s: torch.Tensor, u: torch.Tensor, view) -> torch.Tensor:
    """out[i] = U[i,i]·s[i] + U[i,1−i]·s[1−i] on the halves of ``view``
    = (*lead, a, 2, c); ``u`` aligned to (…, 1, 1, 2, 2)."""
    v = s.reshape(view)
    s0, s1 = v[..., 0, :], v[..., 1, :]
    out0 = u[..., 0, 0] * s0 + u[..., 0, 1] * s1
    out1 = u[..., 1, 1] * s1 + u[..., 1, 0] * s0
    return torch.stack([out0, out1], dim=-2)


def apply_gate(state: CArray, gate: CArray, qubit: int,
               n: int | None = None) -> CArray:
    """A (*g, 2, 2) gate on ``qubit`` of a (*lead, 2, …, 2) state."""
    n = _width(state, n)
    lead = _lead(state, n)
    gate = _cast_gate(gate, state)
    view = lead + (1 << qubit, 2, 1 << (n - qubit - 1))

    def mm(s, g):
        return _flip_1q(s, _align(g, 2, len(lead), mid=2), view)

    return _clin(mm, state, gate, state.shape)


def _pair_axes(lead: tuple, q1: int, q2: int) -> tuple:
    return len(lead) + q1, len(lead) + q2


def _flip_2q(state: CArray, gate: CArray, n: int, q1: int, q2: int):
    """G·ψ = Σ_d C_d ⊙ flip_d(ψ) over the two target axes, with
    C_{dj,dk}[i, l] = G[i, l, i^dj, l^dk] (the reference's four-term
    form and term order)."""
    lead = _lead(state, n)
    ax1, ax2 = _pair_axes(lead, q1, q2)
    lo, hi = min(q1, q2), max(q1, q2)
    place = (1,) * lo + (2,) + (1,) * (hi - lo - 1) + (2,) + (1,) * (
        n - hi - 1)
    def grids(g):
        i, l = torch.meshgrid(torch.arange(2, device=g.device),
                              torch.arange(2, device=g.device), indexing="ij")
        out = []
        for dj, dk in ((0, 0), (0, 1), (1, 0), (1, 1)):
            c = g[..., i, l, i ^ dj, l ^ dk]
            if q1 > q2:
                c = c.transpose(-1, -2)
            c = _align(c, 2, len(lead))
            out.append(c.reshape(tuple(c.shape[:-2]) + place))
        return out

    def mm(s, g):
        cs = grids(g)
        f1 = torch.flip(s, (ax1,))
        fs = (s, torch.flip(s, (ax2,)), f1, torch.flip(f1, (ax2,)))
        return cs[0] * fs[0] + cs[1] * fs[1] + cs[2] * fs[2] + cs[3] * fs[3]

    return _clin(mm, state, gate, state.shape)


def apply_gate_2q(state: CArray, gate: CArray, q1: int, q2: int,
                  n: int | None = None) -> CArray:
    """A (*g, 2, 2, 2, 2) gate G[o1, o2, i1, i2] on qubits (q1, q2)."""
    return _flip_2q(state, _cast_gate(gate, state), _width(state, n), q1, q2)


def apply_cnot(state: CArray, ctrl: int, tgt: int,
               n: int | None = None) -> CArray:
    """CNOT: rows with the control bit set take the target-swapped halves
    (a select; no arithmetic)."""
    n = _width(state, n)
    ac, at = _pair_axes(_lead(state, n), ctrl, tgt)
    at_sub = at - 1 if at > ac else at  # the target axis once ac is gone

    def one(s):
        s1 = s.select(ac, 1)
        swapped = torch.stack([s1.select(at_sub, 1), s1.select(at_sub, 0)],
                              dim=at_sub)
        return torch.stack([s.select(ac, 0), swapped], dim=ac)

    return CArray(one(state.re), None if state.im is None else one(state.im))


def apply_lane_matrix(state: CArray, mt: CArray,
                      n: int | None = None) -> CArray:
    """A composed (*g, 128, 128) lane matrix Mt on the lane qubits
    n−7…n−1 (n ≥ 7): each state's (2^{n−7}, 128) view times Mt."""
    n = _width(state, n)
    if n < _LANE_BITS:
        raise ValueError(f"a lane matrix needs n ≥ {_LANE_BITS}, got {n}")
    lead = _lead(state, n)
    view = lead + (1 << (n - _LANE_BITS), _LANES)

    def mm(s, m):
        return s.reshape(view) @ _align(m, 2, len(lead))

    return _clin(mm, state, _cast_gate(mt, state), state.shape)


def apply_phase_mask(state: CArray, mask: CArray,
                     n: int | None = None) -> CArray:
    """Multiply by a precomputed (*g, 2^n) diagonal in one pass (the
    fusion pass's diagonal chain)."""
    from qfedx_tpu_torch.ops.cpx import cmul

    n = _width(state, n)
    lead = _lead(state, n)
    mask = _cast_gate(mask, state)
    m = CArray(_align(mask.re, 1, len(lead)),
               None if mask.im is None else _align(mask.im, 1, len(lead)))
    flat = _creshape(state, lead + (1 << n,))
    return _creshape(cmul(flat, m), state.shape)


def to_slab(state: CArray, n: int) -> CArray:
    """The dense state as the batched engine's (prod(lead), 2^n) slab."""
    return _creshape(state, (-1, 1 << n))


def from_slab(slab: CArray, lead: tuple, n: int) -> CArray:
    return _creshape(slab, tuple(lead) + (2,) * n)


def probabilities(state: CArray, n: int | None = None) -> torch.Tensor:
    """|ψ|² as (*lead, 2^n) f32, big-endian qubit order. Squared in the
    state's dtype, as the reference's ``cabs2`` (a bf16 state's |ψ|² is
    rounded to bf16); the readouts then sum in f32."""
    n = _width(state, n)
    p = torch.square(state.re)
    if state.im is not None:
        p = p + torch.square(state.im)
    return p.float().reshape(_lead(state, n) + (1 << n,))


def expect_z(state: CArray, qubit: int, n: int | None = None
             ) -> torch.Tensor:
    """⟨Z_qubit⟩ = P(0) − P(1) per state, (*lead,) f32."""
    n = _width(state, n)
    lead = _lead(state, n)
    probs = probabilities(state, n).reshape(
        lead + (1 << qubit, 2, 1 << (n - qubit - 1)))
    marg = probs.sum(dim=(-3, -1))
    return marg[..., 0] - marg[..., 1]


def expect_z_all(state: CArray, n: int | None = None) -> torch.Tensor:
    """⟨Z_k⟩ for every qubit, (*lead, n) f32. At the slab widths the
    batched engine's two-pass slab reduction (the reference's
    ``_slab_z_all``); below it one marginal per qubit."""
    n = _width(state, n)
    lead = _lead(state, n)
    probs = probabilities(state, n)
    if n >= _SLAB_MIN:
        from qfedx_tpu_torch.ops.batched import z_all_slab

        return z_all_slab(probs.reshape(-1, 1 << n), n).reshape(lead + (n,))
    probs = probs.reshape(lead + (2,) * n)
    lo = len(lead)
    out = []
    for k in range(n):
        axes = tuple(lo + i for i in range(n) if i != k)
        marg = probs.sum(dim=axes) if axes else probs
        out.append(marg[..., 0] - marg[..., 1])
    return torch.stack(out, dim=-1)


def fidelity(state_a: CArray, state_b: CArray, n: int | None = None
             ) -> torch.Tensor:
    """|⟨a|b⟩|² per state pair, (*lead,) f32 (sums accumulate in f32)."""
    n = _width(state_a, n)
    dims = tuple(range(-n, 0))

    def dot(x, y):
        return torch.sum(x * y, dim=dims, dtype=torch.float32)

    re = dot(state_a.re, state_b.re)
    if state_a.im is None and state_b.im is None:
        return torch.square(re)
    a_im, b_im = state_a.imag_or_zeros(), state_b.imag_or_zeros()
    re = re + dot(a_im, b_im)
    im = dot(state_a.re, b_im) - dot(a_im, state_b.re)
    return torch.square(re) + torch.square(im)
