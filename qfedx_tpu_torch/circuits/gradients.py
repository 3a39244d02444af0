"""Parameter-shift gradients: the cross-check of the port's autograd.

Counterpart of ``qfedx_tpu/circuits/gradients.py``. The rule
``d⟨O⟩/dθ = ½(⟨O⟩_{θ+π/2} − ⟨O⟩_{θ−π/2})`` is exact for every parameter
that enters the circuit only as the angle of a rotation generated by a
Pauli (RX, RY, RZ): the ``rx``/``rz`` leaves of both ansätze and the
reupload circuit's ``enc_b``. The port differentiates with torch
autograd through the statevector (and the scan-body kernel's
``ScanBodyFn``); these functions are its oracle.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from qfedx_tpu_torch.utils import trees


def param_shift_grad(
    fn: Callable[[torch.Tensor], torch.Tensor], theta, shift: float = math.pi / 2
) -> torch.Tensor:
    """Gradient of scalar ``fn(theta)`` with respect to the parameter
    tensor ``theta``: fn at θ ± s·e_i for each coordinate, 2·P circuit
    runs, each ½(f₊ − f₋)."""
    theta = torch.as_tensor(theta)
    flat = theta.detach().reshape(-1)
    out = torch.empty_like(flat)
    with torch.no_grad():
        for i in range(flat.numel()):
            e = torch.zeros_like(flat)
            e[i] = shift
            plus = fn((flat + e).reshape(theta.shape))
            minus = fn((flat - e).reshape(theta.shape))
            out[i] = 0.5 * (plus - minus)
    return out.reshape(theta.shape)


def param_shift_grad_pytree(fn: Callable, params: dict,
                            shift: float = math.pi / 2) -> dict:
    """Parameter-shift gradient for a (nested) dict of rotation-angle
    tensors: the leaves flattened into one vector in ``trees.tree_leaves``
    order, shifted one coordinate at a time, and split back."""
    leaves = trees.tree_leaves(params)
    flat = torch.cat([t.detach().reshape(-1) for t in leaves])

    def unflatten(v):
        parts = iter(torch.split(v, [t.numel() for t in leaves]))
        return trees.tree_map(lambda t: next(parts).reshape(t.shape), params)

    return unflatten(param_shift_grad(lambda v: fn(unflatten(v)), flat,
                                      shift))
