"""Gate library as real-pair (CArray) tensors.

Counterpart of ``qfedx_tpu/ops/gates.py``: the rotations, their
per-group stacks, the diagonal coefficient forms the fusion pass chains
(``rz_diag``, ``cphase_diag``, ``CZ_DIAG``) and the two-qubit tensors.
Convention as there: a single-qubit gate is a (…,2,2) CArray
``G[out, in]``, a two-qubit one ``G[out1, out2, in1, in2]`` (index 1 the
control); leading axes are layer/group stacks.
"""

from __future__ import annotations

import torch

from qfedx_tpu_torch.ops.cpx import CArray, RDTYPE


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=RDTYPE)


def ry(theta) -> CArray:
    """RY(θ) = [[c, -s], [s, c]] — purely real."""
    theta = _f32(theta)
    c, s = torch.cos(theta / 2), torch.sin(theta / 2)
    return CArray(torch.stack([torch.stack([c, -s]), torch.stack([s, c])]))


def rot_zx(theta, phi) -> CArray:
    """RZ(φ)·RX(θ) fused into one 2×2 gate (a=cos φ/2, b=sin φ/2,
    c=cos θ/2, s=sin θ/2): re [[ac, −bs],[bs, ac]], im [[−bc, −as],
    [−as, bc]]."""
    return rot_zx_batched(theta, phi)


def rot_zx_batched(theta, phi) -> CArray:
    """RZ(φ)·RX(θ) fused, per group: angles (…,) → (…, 2, 2) CArray —
    the layer-stacked (L,) and client-grouped (L, C) rotation stacks of
    the scan route share this one builder."""
    theta, phi = _f32(theta), _f32(phi)
    c, s = torch.cos(theta / 2), torch.sin(theta / 2)
    a, b = torch.cos(phi / 2), torch.sin(phi / 2)
    re = torch.stack(
        [torch.stack([a * c, -b * s], dim=-1),
         torch.stack([b * s, a * c], dim=-1)],
        dim=-2,
    )
    im = torch.stack(
        [torch.stack([-b * c, -a * s], dim=-1),
         torch.stack([-a * s, b * c], dim=-1)],
        dim=-2,
    )
    return CArray(re, im)


# --- the rest of the reference's gate library -------------------------------


def rx(theta) -> CArray:
    """RX(θ) = exp(-i θ X / 2) = [[c, -is], [-is, c]]."""
    theta = _f32(theta)
    c, s = torch.cos(theta / 2), torch.sin(theta / 2)
    zero = torch.zeros_like(c)
    re = torch.stack([torch.stack([c, zero]), torch.stack([zero, c])])
    im = torch.stack([torch.stack([zero, -s]), torch.stack([-s, zero])])
    return CArray(re, im)


def rz(theta) -> CArray:
    """RZ(θ) = diag(e^{-iθ/2}, e^{iθ/2})."""
    theta = _f32(theta)
    c, s = torch.cos(theta / 2), torch.sin(theta / 2)
    zero = torch.zeros_like(c)
    re = torch.stack([torch.stack([c, zero]), torch.stack([zero, c])])
    im = torch.stack([torch.stack([-s, zero]), torch.stack([zero, s])])
    return CArray(re, im)


def ry_batched(theta) -> CArray:
    """RY per group: angles (…,) → (…, 2, 2) real gate stack."""
    theta = _f32(theta)
    c, s = torch.cos(theta / 2), torch.sin(theta / 2)
    re = torch.stack(
        [torch.stack([c, -s], dim=-1), torch.stack([s, c], dim=-1)], dim=-2
    )
    return CArray(re, None)


def rz_diag(theta) -> CArray:
    """RZ(θ) as diagonal entries [e^{-iθ/2}, e^{iθ/2}], shape (…,2)."""
    theta = _f32(theta)
    c, s = torch.cos(theta / 2), torch.sin(theta / 2)
    return CArray(torch.stack([c, c], dim=-1), torch.stack([-s, s], dim=-1))


def cphase_diag(theta) -> CArray:
    """Controlled-phase diag(1,1,1,e^{iθ}) as (…,2,2) entries d[b1,b2]."""
    theta = _f32(theta)
    one, zero = torch.ones_like(theta), torch.zeros_like(theta)
    re = torch.stack(
        [torch.stack([one, one], dim=-1),
         torch.stack([one, torch.cos(theta)], dim=-1)],
        dim=-2,
    )
    im = torch.stack(
        [torch.stack([zero, zero], dim=-1),
         torch.stack([zero, torch.sin(theta)], dim=-1)],
        dim=-2,
    )
    return CArray(re, im)


def crz(theta) -> CArray:
    """Controlled-RZ as a (2,2,2,2) tensor (control = first index pair)."""
    theta = _f32(theta)
    c, s = torch.cos(theta / 2), torch.sin(theta / 2)
    one, zero = torch.ones_like(c), torch.zeros_like(c)
    # diag over (ctrl, tgt) = 00, 01, 10, 11; (4,4) → G[o1,o2,i1,i2].
    re = torch.diag(torch.stack([one, one, c, c])).reshape(2, 2, 2, 2)
    im = torch.diag(torch.stack([zero, zero, -s, s])).reshape(2, 2, 2, 2)
    return CArray(re, im)


def _perm_tensor(entries) -> torch.Tensor:
    t = torch.zeros((2, 2, 2, 2), dtype=RDTYPE)
    for idx, val in entries:
        t[idx] = val
    return t


# G[out1, out2, in1, in2]; index 1 is the control. CPU tensors: the
# engine moves a gate to the state's device where it applies it.
CNOT = CArray(_perm_tensor(
    ((c, t ^ c, c, t), 1.0) for c in range(2) for t in range(2)), None)
CZ = CArray(_perm_tensor(
    ((c, t, c, t), -1.0 if c == t == 1 else 1.0)
    for c in range(2) for t in range(2)), None)
CZ_DIAG = CArray(torch.tensor([[1.0, 1.0], [1.0, -1.0]], dtype=RDTYPE), None)
"""CZ as (2,2) diagonal entries d[b_ctrl, b_tgt] (real)."""
