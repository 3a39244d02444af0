"""Data encoders: classical feature vector → per-qubit amplitudes.

Counterpart of ``qfedx_tpu/circuits/encoders.py`` (``angle_amplitudes``,
``angle_encode``, ``amplitude_encode``). Angle encoding is one rotation
per qubit on |0…0⟩, i.e. a product state: the dense engine builds it
from these 2-vectors by sequential outer products
(``ops/statevector.product_state``), the batched engine by
``ops/batched.bstate_product`` or its log-depth tree. Amplitude encoding
takes the ℓ2-normalised features as the state itself (its batched twin
is ``ops/batched.bstate_amplitude``).
"""

from __future__ import annotations

import math

import torch

from qfedx_tpu_torch.ops.cpx import CArray, state_dtype
from qfedx_tpu_torch.ops.statevector import product_state


def angle_amplitudes(angles: torch.Tensor, basis: str = "ry") -> CArray:
    """Per-qubit 2-vectors for R_basis(angle)|0⟩: angles (…, n) →
    (…, n, 2). cos/sin in f32, cast to the state dtype."""
    half = angles / 2.0
    dt = state_dtype()
    c = torch.cos(half).to(dt)
    s = torch.sin(half).to(dt)
    if basis == "ry":
        # RY(θ)|0⟩ = [cos θ/2, sin θ/2] — real.
        return CArray(torch.stack([c, s], dim=-1), None)
    zero = torch.zeros_like(c)
    if basis == "rx":
        # RX(θ)|0⟩ = [cos θ/2, −i sin θ/2].
        return CArray(
            torch.stack([c, zero], dim=-1), torch.stack([zero, -s], dim=-1)
        )
    if basis == "rz":
        # RZ(θ)|0⟩ = e^{−iθ/2}|0⟩ — a pure phase.
        return CArray(
            torch.stack([c, zero], dim=-1), torch.stack([-s, zero], dim=-1)
        )
    raise ValueError(f"unknown basis {basis!r}")


def angle_encode(features: torch.Tensor, basis: str = "ry") -> CArray:
    """Features in [0,1], shape (*lead, n) → dense state (*lead, 2, …, 2)
    via R_basis(π·f_k) on each qubit."""
    return product_state(angle_amplitudes(features * math.pi, basis))


def amplitude_encode(x) -> CArray:
    """Features of length 2^n, shape (*lead, 2^n) → real dense state
    (*lead, 2, …, 2): ``bstate_amplitude``'s ℓ2-normalised rows (the
    uniform state for an all-zero row) in the state dtype."""
    from qfedx_tpu_torch.ops.batched import bstate_amplitude

    x = torch.as_tensor(x, dtype=torch.float32)
    lead, size = tuple(x.shape[:-1]), x.shape[-1]
    slab = bstate_amplitude(x.reshape(math.prod(lead), size), state_dtype())
    return CArray(slab.re.reshape(lead + (2,) * (size.bit_length() - 1)),
                  None)
