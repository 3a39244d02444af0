"""MPS-simulated real-amplitudes VQC classifier — the model past 20 qubits.

Counterpart of ``qfedx_tpu/models/vqc_mps.py`` (``_ry_mats``,
``make_mps_classifier``). The circuit, simulated as an MPS
(``ops/mps.py``, memory O(n·χ²)):

    angle encoding RY(π·f_k) per qubit (a product MPS)
    L × [ RY(θ_{l,k}) on every qubit → CNOT line (k→k+1) ]
    normalized ⟨Z_k⟩ → scale·z + bias logits

χ (``bond_dim``) is the accuracy/cost knob: χ ≥ 2^{n/2} is exact; a
smaller χ truncates after every CNOT. One forward runs L·(n−1) batched
SVDs (``torch.linalg.svd`` over the B samples). The splits zero their
null space, where the reference keeps an arbitrary basis of it
(``ops/mps.py``): the logits equal the reference's wherever its result
does not depend on that basis (χ = 2^{n/2}), and the gradients equal
the dense engine's at L ≤ 2. The model has no ``apply_clients``: it
trains one client at a time (``fed/client.make_local_update``), as the
reference's vmap path does.
"""

from __future__ import annotations

import math

import torch

from qfedx_tpu_torch.circuits.readout import init_readout_params
from qfedx_tpu_torch.models.api import (  # noqa: F401 — re-exported
    Model,
    params_from_jax,
)
from qfedx_tpu_torch.models.vqc import wrap_angle
from qfedx_tpu_torch.ops import mps
from qfedx_tpu_torch.utils import pins


def _ry_mats(angles: torch.Tensor) -> torch.Tensor:
    """(…, n) angles → (…, n, 2, 2) RY matrices (real)."""
    c, s = torch.cos(angles / 2), torch.sin(angles / 2)
    row0 = torch.stack([c, -s], dim=-1)
    row1 = torch.stack([s, c], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def make_mps_classifier(
    n_qubits: int,
    n_layers: int = 2,
    num_classes: int = 2,
    bond_dim: int = 16,
    init_scale: float = 0.1,
    device=None,
) -> Model:
    """Build the MPS VQC Model on ``device`` (None = the card). Inputs:
    (B, n_qubits) features in [0, 1]."""
    if num_classes > n_qubits:
        raise ValueError(f"need n_qubits ≥ num_classes ({num_classes})")
    if bond_dim < 2:
        raise ValueError("bond_dim must be ≥ 2")
    dev = pins.resolve_device(device)

    def init(seed) -> dict:
        """Small-angle init: init_scale·N(0,1) RY angles (L, n), unit
        readout scale, zero bias. ``seed`` is an int or a
        ``torch.Generator`` (CPU draws)."""
        gen = (seed if isinstance(seed, torch.Generator)
               else torch.Generator().manual_seed(int(seed)))
        ry = init_scale * torch.randn((n_layers, n_qubits), generator=gen)
        return {"ansatz": {"ry": ry.to(dev)},
                "readout": init_readout_params(num_classes, dev)}

    def forward_z(params: dict, x: torch.Tensor) -> torch.Tensor:
        """(B, n) features → (B, n) normalized ⟨Z⟩."""
        amps = _ry_mats(x * math.pi)[..., 0]  # RY(πf)|0⟩ columns (B, n, 2)
        sites = mps.product_mps(amps, bond_dim)
        for layer in range(n_layers):
            sites = mps.apply_1q_all(
                sites, _ry_mats(params["ansatz"]["ry"][layer]))
            sites = mps.apply_cnot_chain(sites)
        return mps.expect_z_all(sites)

    def apply(params: dict, x) -> torch.Tensor:
        x = torch.as_tensor(x, dtype=torch.float32,
                            device=params["ansatz"]["ry"].device)
        z = forward_z(params, x)[:, :num_classes]
        return params["readout"]["scale"] * z + params["readout"]["bias"]

    def wrap_delta(delta: dict) -> dict:
        return {"ansatz": {"ry": wrap_angle(delta["ansatz"]["ry"])},
                "readout": delta["readout"]}

    return Model(
        init=init,
        apply=apply,
        wrap_delta=wrap_delta,
        name=f"mps{n_qubits}q{n_layers}l-chi{bond_dim}",
    )
