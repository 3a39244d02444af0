"""Measurement readout parameters: logit_c = scale_c · ⟨Z_c⟩ + bias_c.

Counterpart of ``qfedx_tpu/circuits/readout.py`` (``init_readout_params``).
"""

from __future__ import annotations

import torch


def init_readout_params(num_classes: int, device) -> dict:
    """Deterministic init: unit scale, zero bias."""
    return {
        "scale": torch.ones(num_classes, dtype=torch.float32, device=device),
        "bias": torch.zeros(num_classes, dtype=torch.float32, device=device),
    }
