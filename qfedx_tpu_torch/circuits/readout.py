"""Measurement readout parameters: logit_c = scale_c · ⟨Z_c⟩ + bias_c.

Counterpart of ``qfedx_tpu/circuits/readout.py`` (``init_readout_params``,
``z_logits``). Class c reads qubit c.
"""

from __future__ import annotations

import torch

from qfedx_tpu_torch.ops.statevector import _align, expect_z_all


def init_readout_params(num_classes: int, device) -> dict:
    """Deterministic init: unit scale, zero bias."""
    return {
        "scale": torch.ones(num_classes, dtype=torch.float32, device=device),
        "bias": torch.zeros(num_classes, dtype=torch.float32, device=device),
    }


def z_logits(state, params: dict, n: int | None = None) -> torch.Tensor:
    """logit_c = scale_c · ⟨Z_c⟩ + bias_c for c < num_classes on a dense
    (*lead, 2, …, 2) state → (*lead, k). Per-client (C, k) readouts
    left-align with a (C, B, …) state's leading axes."""
    n = state.ndim if n is None else n
    k = params["scale"].shape[-1]
    if k > n:
        raise ValueError(f"{k} classes need ≥{k} qubits, have {n}")
    z = expect_z_all(state, n)[..., :k]
    lead_nd = z.ndim - 1
    return (_align(params["scale"], 1, lead_nd) * z
            + _align(params["bias"], 1, lead_nd))
