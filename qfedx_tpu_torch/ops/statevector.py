"""Slab-layout constants and the lane-matrix builders.

Counterpart of the slab section of ``qfedx_tpu/ops/statevector.py``.
States with n ≥ ``_SLAB_MIN`` qubits are (R, 128) = (2^{n-7}, 2^7)
row-major views: qubits n−7…n−1 live in the 128-lane minor dim, qubits
0…n−8 in the row dim. Lane-qubit gates are (R,128)×(128,128) products
against small structured matrices built here; row-qubit gates flip and
select along leading axes (``ops/batched.py``). The dense ``(2,)*n``
engine is not ported: the port's slice runs the batched slab engine.
"""

from __future__ import annotations

import torch

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
