"""Rotation gates as real-pair (CArray) tensors.

Counterpart of ``qfedx_tpu/ops/gates.py`` — the rotations the HEA and
its encoder need. Convention as there: a single-qubit gate is a (…,2,2)
CArray ``G[out, in]``; leading axes are layer/group stacks.
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
