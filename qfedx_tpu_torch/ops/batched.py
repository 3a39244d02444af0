"""Batched slab statevector engine — batch folded into slab rows.

Counterpart of ``qfedx_tpu/ops/batched.py``. The canonical state is
``(B, 2^n)`` and every view keeps the 128-lane register as its minor
dim: ``(B·a, 2, c, 128)`` row splits, ``(B, R, 128)`` slabs. Gate
coefficients come shared ``(…gate)``, or grouped ``(G, …gate)`` with
G | B — group g's coefficients apply to its contiguous block of B/G rows
(per-client stacks of the folded federated path; G == B is per-sample).

These executors are the scan route's per-op bodies (``fuse._exec_stacked``)
and therefore also the arithmetic of the scan-body kernel's plain
version (``ops/scan_body.scan_body_plain``).
"""

from __future__ import annotations

import torch

from qfedx_tpu_torch.ops.cpx import CArray
from qfedx_tpu_torch.utils import pins
from qfedx_tpu_torch.ops.statevector import (
    _LANE_BITS,
    _LANES,
    _SLAB_MIN,
    _lane_mt,
    _lane_perm_cnot,
    _lane_perm_flip,
    _row_split,
    _slab_pos,
)


def batched_enabled(n_qubits: int) -> bool:
    """Route whole-batch applies through this engine?  Slab widths only;
    QFEDX_BATCHED pins, default on (the card's program)."""
    if n_qubits < _SLAB_MIN:
        return False
    return pins.bool_pin("QFEDX_BATCHED", True)


def _check_width(n: int):
    if n < _SLAB_MIN:
        raise ValueError(f"batched engine needs n ≥ {_SLAB_MIN}, got {n}")


def _cmap(c: CArray, f) -> CArray:
    return CArray(f(c.re), None if c.im is None else f(c.im))


def _cast_parts(gate: CArray, dtype):
    gre = gate.re.to(dtype)
    gim = None if gate.im is None else gate.im.to(dtype)
    return gre, gim


def _clin(mm, state: CArray, m_re, m_im, shape) -> CArray:
    """Complex-resolve a map ``mm(s, m)`` linear in s and m, with the
    known-real shortcuts (4 real products at most)."""
    rr = mm(state.re, m_re)
    if m_im is None and state.im is None:
        return CArray(rr.reshape(shape), None)
    if m_im is None:
        return CArray(rr.reshape(shape), mm(state.im, m_re).reshape(shape))
    if state.im is None:
        return CArray(rr.reshape(shape), mm(state.re, m_im).reshape(shape))
    return CArray(
        (rr - mm(state.im, m_im)).reshape(shape),
        (mm(state.im, m_re) + mm(state.re, m_im)).reshape(shape),
    )


def bstate_product(amps: CArray) -> CArray:
    """Product state from per-qubit 2-vectors: (B, n, 2) → (B, 2^n), by
    n−1 sequential outer products (the scan-off encoder)."""
    b, n, _ = amps.shape
    state = CArray(
        amps.re[:, 0, :], None if amps.im is None else amps.im[:, 0, :]
    )
    for q in range(1, n):
        a = CArray(
            amps.re[:, q, :], None if amps.im is None else amps.im[:, q, :]
        )
        state = _outer_flat(state, a)
    return state


def _outer_flat(a: CArray, b: CArray) -> CArray:
    """(B,s)·(B,t) → (B,s·t) outer-product rows, complex-shortcutted."""

    def k(x, y):
        return (x[:, :, None] * y[:, None, :]).reshape(x.shape[0], -1)

    rr = k(a.re, b.re)
    if a.im is None and b.im is None:
        return CArray(rr, None)
    a_im = a.imag_or_zeros()
    b_im = b.imag_or_zeros()
    return CArray(rr - k(a_im, b_im), k(a.re, b_im) + k(a_im, b.re))


def bstate_product_tree(amps: CArray) -> CArray:
    """``bstate_product`` in log-depth: qubit factors pair level-wise —
    (B,k,s) → (B,⌊k/2⌋,s²) in one vectorized multiply per level. Odd
    leftovers join a trailing carry (qubit 0 stays the slowest axis).
    Reassociates the product; the scan route uses it."""

    def pair(cur: CArray) -> CArray:
        def k(x, y):
            z = x[..., :, None] * y[..., None, :]
            return z.reshape(z.shape[0], z.shape[1], -1)

        def halves(s):
            v = s.reshape(s.shape[0], s.shape[1] // 2, 2, s.shape[2])
            return v[:, :, 0], v[:, :, 1]

        x_re, y_re = halves(cur.re)
        rr = k(x_re, y_re)
        if cur.im is None:
            return CArray(rr, None)
        x_im, y_im = halves(cur.im)
        return CArray(rr - k(x_im, y_im), k(x_re, y_im) + k(x_im, y_re))

    cur = amps
    carry: CArray | None = None
    while cur.re.shape[1] > 1:
        if cur.re.shape[1] % 2:
            last = _cmap(cur, lambda s: s[:, -1])
            # The leftover block precedes every earlier carry.
            carry = last if carry is None else _outer_flat(last, carry)
            cur = _cmap(cur, lambda s: s[:, :-1])
        cur = pair(cur)
    out = _cmap(cur, lambda s: s[:, 0])
    return out if carry is None else _outer_flat(out, carry)


def bstate_amplitude(x, dtype) -> CArray:
    """ℓ2-normalised amplitudes: (B, 2^n) features → real (B, 2^n) state
    of ``dtype`` (normalised in f32), the uniform state for an all-zero
    row; a feature count that is not 2^n raises."""
    x = torch.as_tensor(x, dtype=torch.float32)
    size = x.shape[-1]
    n = size.bit_length() - 1
    if size <= 0 or (1 << n) != size:
        raise ValueError(f"amplitude encoding needs 2^n features, got {size}")
    norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    uniform = torch.full_like(x, 1.0 / size ** 0.5)
    safe = torch.where(
        norm > 0, x / torch.where(norm > 0, norm, torch.ones_like(norm)),
        uniform,
    )
    return CArray(safe.to(dtype), None)


def _row_view(s: torch.Tensor, b: int, n: int, qubit: int,
              groups: int | None):
    """Row view splitting the row index at ``qubit``: (B·a, 2, c, 128)
    shared, or (G, S·a, 2, c, 128) for grouped coefficients."""
    a, two, c, lanes = _row_split(n, qubit)
    if groups is None:
        return s.reshape(b * a, two, c, lanes)
    return s.reshape(groups, (b // groups) * a, two, c, lanes)


def _diag_coeffs(gre, gim, groups: int | None):
    """Diagonal/off-diagonal gate coefficients broadcast for the row view:
    (1,2,1,1) shared, (G,1,2,1,1) grouped."""
    idx = torch.arange(2, device=gre.device)
    shp = (1, 2, 1, 1) if groups is None else (-1, 1, 2, 1, 1)

    def split(g):
        if g is None:
            return None, None
        return (g[..., idx, idx].reshape(shp),
                g[..., idx, 1 - idx].reshape(shp))

    ud_re, uo_re = split(gre)
    ud_im, uo_im = split(gim)
    return ud_re, uo_re, ud_im, uo_im


def _row_gate(state: CArray, b: int, n: int, gate: CArray, qubit: int,
              groups: int | None) -> CArray:
    """Row-qubit gate in flip/select form on the batched slab."""
    gre, gim = _cast_parts(gate, state.re.dtype)
    axis = 1 if groups is None else 2
    ud_re, uo_re, ud_im, uo_im = _diag_coeffs(gre, gim, groups)
    shape = state.re.shape

    def lin(ud, uo, s):
        v = _row_view(s, b, n, qubit, groups)
        return (ud * v + uo * torch.flip(v, (axis,))).reshape(shape)

    if gim is None and state.im is None:
        return CArray(lin(ud_re, uo_re, state.re), None)
    if gim is None:
        return CArray(lin(ud_re, uo_re, state.re), lin(ud_re, uo_re, state.im))
    if state.im is None:
        return CArray(lin(ud_re, uo_re, state.re), lin(ud_im, uo_im, state.re))
    return CArray(
        lin(ud_re, uo_re, state.re) - lin(ud_im, uo_im, state.im),
        lin(ud_re, uo_re, state.im) + lin(ud_im, uo_im, state.re),
    )


def _lane_matmul(state: CArray, mt_re, mt_im, groups: int | None) -> CArray:
    """s @ Mt on the (…, 128) lane dim; grouped coefficients use a batched
    (G, S·R, 128) × (G, 128, 128) product."""
    if groups is not None:
        def mm(s, m):
            return s.reshape(groups, -1, _LANES) @ m
    else:
        def mm(s, m):
            return s.reshape(-1, _LANES) @ m

    return _clin(mm, state, mt_re, mt_im, state.re.shape)


def _coeff_groups(b: int, coeffs: CArray, gate_ndim: int) -> int | None:
    """Group count of a coefficient stack with ``gate_ndim`` trailing gate
    axes (None = shared), validated against the batch (G must divide B)."""
    lead = coeffs.re.ndim - gate_ndim
    if lead == 0:
        return None
    if lead != 1:
        raise ValueError(
            f"coefficient stack has {lead} leading axes; expected ≤ 1"
        )
    groups = coeffs.re.shape[0]
    if groups <= 0 or b % groups != 0:
        raise ValueError(
            f"grouped coefficients have {groups} groups but the batch is "
            f"{b} rows — G must divide B"
        )
    return groups


def apply_gate_b(state: CArray, n: int, gate: CArray, qubit: int) -> CArray:
    """1-qubit gate on a batched (B, 2^n) state: (2,2) shared or (G,2,2)
    grouped with G | B. Lane qubits go through a structured 128×128
    product, row qubits through flip/select."""
    _check_width(n)
    b = state.re.shape[0]
    groups = _coeff_groups(b, gate, 2)
    if qubit >= n - _LANE_BITS:
        gre, gim = _cast_parts(gate, state.re.dtype)
        p = _slab_pos(n, qubit)
        mt_im = None if gim is None else _lane_mt(gim, p)
        return _lane_matmul(state, _lane_mt(gre, p), mt_im, groups)
    return _row_gate(state, b, n, gate, qubit, groups)


def apply_lane_matrix_b(state: CArray, n: int, mt: CArray) -> CArray:
    """Composed (…,128,128) lane matrix on the batched slab in one
    (grouped) product: (128,128) shared or (G,128,128) grouped."""
    _check_width(n)
    groups = _coeff_groups(state.re.shape[0], mt, 2)
    mt_re, mt_im = _cast_parts(mt, state.re.dtype)
    return _lane_matmul(state, mt_re, mt_im, groups)


def apply_row_matrix_b(state: CArray, n: int, mt: CArray) -> CArray:
    """Composed (…,R,R) row operator on the batched slab: (R,R) shared or
    (G,R,R) grouped, left-multiplied into each (R,128) block."""
    _check_width(n)
    b = state.re.shape[0]
    groups = _coeff_groups(b, mt, 2)
    mt_re, mt_im = _cast_parts(mt, state.re.dtype)
    r = 1 << (n - _LANE_BITS)
    if groups is None:
        def mm(s, m):
            return m @ s.reshape(b, r, _LANES)
    else:
        def mm(s, m):
            return m[:, None] @ s.reshape(groups, b // groups, r, _LANES)

    return _clin(mm, state, mt_re, mt_im, state.re.shape)


def apply_row_perm_b(state: CArray, n: int, perm) -> CArray:
    """Static row-index permutation on the batched slab in one gather
    (out[r] = in[perm[r]]); every row block permutes identically."""
    _check_width(n)
    b = state.re.shape[0]
    shape = state.re.shape
    idx = torch.as_tensor(perm, dtype=torch.long, device=state.re.device)
    r = 1 << (n - _LANE_BITS)
    return _cmap(state, lambda s: s.reshape(b, r, _LANES)[:, idx]
                 .reshape(shape))


def apply_lane_matrix_ctrl_b(
    state: CArray, n: int, mt: CArray, ctrl: int
) -> CArray:
    """Row-qubit-selected lane-matrix pair: rows with bit ``ctrl`` = x go
    through ``mt[…,x]``. ``mt``: (2,128,128) shared or (G,2,128,128)."""
    _check_width(n)
    if not 0 <= ctrl < n - _LANE_BITS:
        raise ValueError(f"ctrl must be a row qubit, got {ctrl} (n={n})")
    b = state.re.shape[0]
    groups = _coeff_groups(b, mt, 3)
    mt_re, mt_im = _cast_parts(mt, state.re.dtype)
    if groups is None:
        def mm(s, m):
            return _row_view(s, b, n, ctrl, None) @ m[None]
    else:
        def mm(s, m):
            return _row_view(s, b, n, ctrl, groups) @ m[:, None]

    return _clin(mm, state, mt_re, mt_im, state.re.shape)


def apply_row_matrix_ctrl_b(
    state: CArray, n: int, mt: CArray, ctrl: int
) -> CArray:
    """Lane-qubit-selected row-matrix pair: lanes with bit ``ctrl`` = x
    push their rows through ``mt[…,x]``. ``mt``: (2,R,R) shared or
    (G,2,R,R) grouped."""
    _check_width(n)
    if not n - _LANE_BITS <= ctrl < n:
        raise ValueError(f"ctrl must be a lane qubit, got {ctrl} (n={n})")
    b = state.re.shape[0]
    groups = _coeff_groups(b, mt, 3)
    mt_re, mt_im = _cast_parts(mt, state.re.dtype)
    r = 1 << (n - _LANE_BITS)
    p = _slab_pos(n, ctrl)
    h, w = 1 << (_LANE_BITS - p - 1), 1 << p
    if groups is None:
        def mm(s, m):
            return torch.einsum(
                "xrs,bshxw->brhxw", m, s.reshape(b, r, h, 2, w)
            )
    else:
        def mm(s, m):
            return torch.einsum(
                "gxrs,gzshxw->gzrhxw",
                m,
                s.reshape(groups, b // groups, r, h, 2, w),
            )

    return _clin(mm, state, mt_re, mt_im, state.re.shape)


def apply_rowpair_b(
    state: CArray, n: int, gate: CArray, q1: int, q2: int
) -> CArray:
    """Merged 4×4 super-gate ``G[…,o1,o2,i1,i2]`` on two ROW qubits
    q1 < q2, one four-flip pass through the (B·a,2,c,2,e,128) view
    ((G,S·a,2,c,2,e,128) for grouped stacks)."""
    _check_width(n)
    rbits = n - _LANE_BITS
    if not 0 <= q1 < q2 < rbits:
        raise ValueError(
            f"rowpair needs row qubits q1 < q2 < {rbits}, got ({q1}, {q2})"
        )
    b = state.re.shape[0]
    groups = _coeff_groups(b, gate, 4)
    gre, gim = _cast_parts(gate, state.re.dtype)
    shape = state.re.shape
    a = 1 << q1
    c = 1 << (q2 - q1 - 1)
    e = 1 << (rbits - q2 - 1)
    if groups is None:
        view = (b * a, 2, c, 2, e, _LANES)
        ax1, ax2 = 1, 3
        gshape = (1, 2, 1, 2, 1, 1)
    else:
        view = (groups, (b // groups) * a, 2, c, 2, e, _LANES)
        ax1, ax2 = 2, 4
        gshape = (groups, 1, 2, 1, 2, 1, 1)

    # The four flip-combination grids C_{dj,dk}[i,l] = G[…,i,l,i^dj,l^dk].
    i, l = torch.meshgrid(
        torch.arange(2, device=gre.device),
        torch.arange(2, device=gre.device),
        indexing="ij",
    )

    def grids(part):
        return [
            part[..., i, l, i ^ dj, l ^ dk].reshape(gshape)
            for dj, dk in ((0, 0), (0, 1), (1, 0), (1, 1))
        ]

    def flips(s):
        v = s.reshape(view)
        f2 = torch.flip(v, (ax2,))
        f1 = torch.flip(v, (ax1,))
        return v, f2, f1, torch.flip(f1, (ax2,))

    def lin(cs, fs):
        return (
            cs[0] * fs[0] + cs[1] * fs[1] + cs[2] * fs[2] + cs[3] * fs[3]
        ).reshape(shape)

    re_c = grids(gre)
    fs_re = flips(state.re)
    if gim is None and state.im is None:
        return CArray(lin(re_c, fs_re), None)
    if gim is None:
        return CArray(lin(re_c, fs_re), lin(re_c, flips(state.im)))
    im_c = grids(gim)
    if state.im is None:
        return CArray(lin(re_c, fs_re), lin(im_c, fs_re))
    fs_im = flips(state.im)
    return CArray(
        lin(re_c, fs_re) - lin(im_c, fs_im),
        lin(re_c, fs_im) + lin(im_c, fs_re),
    )


def apply_phase_mask_b(state: CArray, n: int, mask: CArray) -> CArray:
    """Precomputed (…,2^n) phase mask on the batched slab in one multiply:
    (2^n,) shared or (G,2^n) grouped."""
    _check_width(n)
    b = state.re.shape[0]
    groups = _coeff_groups(b, mask, 1)
    shape = state.re.shape
    m_re, m_im = _cast_parts(mask, state.re.dtype)
    if groups is None:
        view = shape
        m_re = m_re[None, :]
        m_im = None if m_im is None else m_im[None, :]
    else:
        view = (groups, b // groups, 1 << n)
        m_re = m_re[:, None, :]
        m_im = None if m_im is None else m_im[:, None, :]

    def mul(s, m):
        return (s.reshape(view) * m).reshape(shape)

    if m_im is None:
        return CArray(
            mul(state.re, m_re),
            None if state.im is None else mul(state.im, m_re),
        )
    if state.im is None:
        return CArray(mul(state.re, m_re), mul(state.re, m_im))
    return CArray(
        mul(state.re, m_re) - mul(state.im, m_im),
        mul(state.re, m_im) + mul(state.im, m_re),
    )


def apply_cnot_b(state: CArray, n: int, ctrl: int, tgt: int) -> CArray:
    """CNOT on a batched (B, 2^n) state: four row/lane cases."""
    _check_width(n)
    b = state.re.shape[0]
    dtype = state.re.dtype
    dev = state.re.device
    shape = state.re.shape
    row_limit = n - _LANE_BITS
    c_row, t_row = ctrl < row_limit, tgt < row_limit
    if c_row and t_row:
        lo, hi = (ctrl, tgt) if ctrl < tgt else (tgt, ctrl)
        a = 1 << lo
        m = 1 << (hi - lo - 1)
        c = 1 << (row_limit - hi - 1)
        view = (b * a, 2, m, 2, c, _LANES)
        ax_c, ax_t = (1, 3) if ctrl < tgt else (3, 1)
        mask_shape = [1] * 6
        mask_shape[ax_c] = 2
        mask = torch.arange(2, device=dev).reshape(mask_shape) == 1

        def one(s):
            v = s.reshape(view)
            return torch.where(mask, torch.flip(v, (ax_t,)), v).reshape(shape)

        return _cmap(state, one)
    if not c_row and not t_row:
        mt = _lane_perm_cnot(
            _slab_pos(n, ctrl), _slab_pos(n, tgt), dtype, dev
        )
        return _cmap(state, lambda s: (s.reshape(-1, _LANES) @ mt)
                     .reshape(shape))
    if c_row:  # control in rows, target in lanes
        mask = torch.arange(2, device=dev).reshape(1, 2, 1, 1) == 1
        p = _lane_perm_flip(_slab_pos(n, tgt), dtype, dev)

        def one(s):
            v = _row_view(s, b, n, ctrl, groups=None)
            return torch.where(mask, v @ p, v).reshape(shape)

        return _cmap(state, one)
    # control in lanes, target in rows
    lane_bit = (torch.arange(_LANES, device=dev) >> _slab_pos(n, ctrl)) & 1
    mask = (lane_bit == 1).reshape(1, 1, 1, _LANES)

    def one(s):
        v = _row_view(s, b, n, tgt, groups=None)
        return torch.where(mask, torch.flip(v, (1,)), v).reshape(shape)

    return _cmap(state, one)


def probabilities_b(state: CArray) -> torch.Tensor:
    """|ψ|² per sample, (B, 2^n) f32."""
    p = torch.square(state.re.float())
    if state.im is not None:
        p = p + torch.square(state.im.float())
    return p


def expect_z_all_b(state: CArray, n: int) -> torch.Tensor:
    """⟨Z_k⟩ ∀k per sample: (B, 2^n) → (B, n) f32 via the two-pass slab
    reduction (row sums + lane sums)."""
    return z_all_slab(probabilities_b(state), n)


def z_all_slab(probs: torch.Tensor, n: int) -> torch.Tensor:
    """The two-pass slab reduction of (B, 2^n) f32 probabilities to the
    (B, n) ⟨Z_k⟩ (the reference's ``_slab_z_all``)."""
    b = probs.shape[0]
    rbits = n - _LANE_BITS
    slab = probs.reshape(b, 1 << rbits, _LANES)
    row_sums = slab.sum(dim=2)  # (B, R)
    lane_sums = slab.sum(dim=1)  # (B, 128)
    out = []
    for k in range(rbits):
        a, c = 1 << k, 1 << (rbits - k - 1)
        marg = row_sums.reshape(b, a, 2, c).sum(dim=(1, 3))
        out.append(marg[:, 0] - marg[:, 1])
    lane = torch.arange(_LANES, device=probs.device)[:, None]
    bitpos = (_LANE_BITS - 1) - torch.arange(
        _LANE_BITS, device=probs.device
    )[None, :]
    zmat = 1.0 - 2.0 * ((lane >> bitpos) & 1).float()
    return torch.cat([torch.stack(out, dim=1), lane_sums @ zmat], dim=1)
