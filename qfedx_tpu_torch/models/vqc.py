"""Variational quantum circuit classifier on the batched slab engine.

Counterpart of ``qfedx_tpu/models/vqc.py`` (``make_vqc_classifier``'s
batched route for angle encoding, and its ``init``/``apply``/``name``):
encoder → hardware-efficient ansatz → ⟨Z⟩ readout → logits. The forward
is the reference's batched-slab route — log-depth product state on the
scan route, the HEA as one stacked fused program (the scan-body kernel
on the card), ``expect_z_all_b``, then the affine readout.

Not ported yet: the vmap (dense) route below the slab widths or with
QFEDX_BATCHED=0, amplitude and reupload encodings, noise, remat and the
client-folded ``apply_clients`` — each raises NotImplementedError.

``params_from_jax`` carries the reference's parameter pytree across.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from qfedx_tpu_torch.circuits.ansatz import (
    hardware_efficient_b,
    init_ansatz_params,
)
from qfedx_tpu_torch.circuits.encoders import angle_amplitudes
from qfedx_tpu_torch.circuits.readout import init_readout_params
from qfedx_tpu_torch.models.api import Model
from qfedx_tpu_torch.ops import fuse
from qfedx_tpu_torch.ops.batched import (
    batched_enabled,
    bstate_product,
    bstate_product_tree,
    expect_z_all_b,
)
from qfedx_tpu_torch.utils import pins


def make_vqc_classifier(
    n_qubits: int,
    n_layers: int = 2,
    num_classes: int = 2,
    encoding: str = "angle",
    basis: str = "ry",
    init_scale: float = 0.1,
    device=None,
) -> Model:
    """Build the VQC classifier Model. Input features: (B, n_qubits) in
    [0,1]. ``device=None`` means the card and raises without one."""
    if num_classes > n_qubits:
        raise ValueError(f"need n_qubits ≥ num_classes ({num_classes})")
    if encoding not in ("angle", "amplitude", "reupload"):
        raise ValueError(f"unknown encoding {encoding!r}")
    if encoding != "angle":
        raise NotImplementedError(
            f"encoding={encoding!r} is not ported yet; the port runs angle"
        )
    dev = pins.resolve_device(device)

    def init(seed) -> dict:
        """Parameters on the model's device; ``seed`` as in
        ``circuits.ansatz.init_ansatz_params``."""
        return {
            "ansatz": init_ansatz_params(
                seed, n_qubits, n_layers, init_scale, dev
            ),
            "readout": init_readout_params(num_classes, dev),
        }

    def apply(params: dict, x) -> torch.Tensor:
        if not batched_enabled(n_qubits):
            raise NotImplementedError(
                "the vmap (dense) route is not ported yet: the port runs "
                f"the batched engine at n ≥ 10 with QFEDX_BATCHED on "
                f"(n_qubits={n_qubits})"
            )
        a = params["ansatz"]
        x = torch.as_tensor(x, dtype=torch.float32, device=a["rx"].device)
        # The scan route pairs with the log-depth product state; scan-off
        # keeps the sequential encoder, as the reference does.
        enc_fn = (
            bstate_product_tree
            if fuse.scan_active(n_qubits, n_layers)
            else bstate_product
        )
        state = enc_fn(angle_amplitudes(x * math.pi, basis))
        state = hardware_efficient_b(state, n_qubits, a)
        k = params["readout"]["scale"].shape[0]
        z = expect_z_all_b(state, n_qubits)[:, :k]
        return params["readout"]["scale"] * z + params["readout"]["bias"]

    return Model(
        init=init,
        apply=apply,
        name=f"vqc{n_qubits}q{n_layers}l-{encoding}",
    )


def params_from_jax(tree, device=None) -> dict:
    """The reference's parameter pytree ``{"ansatz": {"rx": (L,n), "rz":
    (L,n)}, "readout": {"scale": (k,), "bias": (k,)}}`` (numpy or
    array-likes) → the port's dict of f32 tensors on ``device``."""
    dev = pins.resolve_device(device)
    return {
        group: {
            key: torch.as_tensor(np.array(val, dtype=np.float32), device=dev)
            for key, val in leaves.items()
        }
        for group, leaves in tree.items()
    }
