"""Quantum-kernel classifier head (BASELINE.md config 5).

Counterpart of ``qfedx_tpu/models/kernel.py``: a fidelity kernel
k(x, x′) = |⟨φ(x)|φ(x′)⟩|² over the angle-encoded feature map φ, with a
trainable linear head on the kernel features against M landmark points:
logits = K(x, landmarks)·W + b. The parameters (``landmarks`` (M, n),
``w`` (M, K), ``b`` (K,)) ride the same federated harness as the VQC.

The angle-encoded feature map is a product state, so ``kernel_matrix``
computes the Gram matrix in closed form — a per-qubit cos² product,
O(n) per pair, no statevector anywhere; ``kernel_matrix_dense`` builds
the 2^n statevectors (``circuits/encoders.angle_encode``,
``ops/statevector.fidelity``) as the general-basis path and the
exactness oracle.

``apply_clients`` broadcasts the closed form over a client axis —
(C, B, n) features with (C, …) parameters → (C, B, K) logits — so
config 5's 256 clients train as one folded program (``fed/client.
make_local_update_clients``); the reference vmaps one client's update.
"""

from __future__ import annotations

import math

import torch

from qfedx_tpu_torch.circuits.encoders import angle_encode
from qfedx_tpu_torch.models.api import (  # noqa: F401 — re-exported
    Model,
    params_from_jax,
)
from qfedx_tpu_torch.ops.cpx import CArray
from qfedx_tpu_torch.ops.statevector import fidelity
from qfedx_tpu_torch.utils import pins


def _unsqueeze(state: CArray, dim: int) -> CArray:
    return CArray(state.re.unsqueeze(dim),
                  None if state.im is None else state.im.unsqueeze(dim))


def kernel_matrix_dense(xs: torch.Tensor, ys: torch.Tensor,
                        basis: str = "ry") -> torch.Tensor:
    """Gram matrix through explicit statevectors, (…, B, n)×(…, M, n) →
    (…, B, M): each side encoded once (O((B+M)·2^n)), every pair's
    fidelity by broadcasting the two sets against each other."""
    n = xs.shape[-1]
    sx = _unsqueeze(angle_encode(xs, basis), -n - 1)  # (…, B, 1, 2, …)
    sy = _unsqueeze(angle_encode(ys, basis), -n - 2)  # (…, 1, M, 2, …)
    return fidelity(sx, sy, n)


def kernel_matrix(xs: torch.Tensor, ys: torch.Tensor,
                  basis: str = "ry") -> torch.Tensor:
    """Gram matrix K[…, i, j] = |⟨φ(xs_i)|φ(ys_j)⟩|², (…, B, n)×(…, M, n)
    → (…, B, M). For RY (and RX) encoding the fidelity of two product
    states factorizes per qubit: Π_k cos²(π(x_k − y_k)/2). Other bases
    take the statevectors (``kernel_matrix_dense``)."""
    if basis not in ("ry", "rx"):
        return kernel_matrix_dense(xs, ys, basis)
    half = 0.5 * math.pi * (xs[..., :, None, :] - ys[..., None, :, :])
    return torch.prod(torch.square(torch.cos(half)), dim=-1)


def make_quantum_kernel_classifier(
    n_qubits: int,
    n_landmarks: int = 16,
    num_classes: int = 2,
    basis: str = "ry",
    landmark_scale: float = 1.0,
    device=None,
) -> Model:
    """Kernel head Model on ``device`` (None = the card). Landmarks are
    trainable, initialized U[0,1)·landmark_scale in the feature cube
    (``init_landmarks_from_data`` seeds them with samples); w = 0.1·N(0,1),
    b = 0. Input features: (B, n_qubits) in [0,1]."""
    dev = pins.resolve_device(device)

    def init(seed) -> dict:
        """``seed`` is an int or a ``torch.Generator`` (CPU draws)."""
        gen = (seed if isinstance(seed, torch.Generator)
               else torch.Generator().manual_seed(int(seed)))
        landmarks = landmark_scale * torch.rand((n_landmarks, n_qubits),
                                                generator=gen)
        w = 0.1 * torch.randn((n_landmarks, num_classes), generator=gen)
        return {"landmarks": landmarks.to(dev), "w": w.to(dev),
                "b": torch.zeros(num_classes, dtype=torch.float32,
                                 device=dev)}

    def _features(params, x):
        return torch.as_tensor(x, dtype=torch.float32,
                               device=params["w"].device)

    def apply(params: dict, x) -> torch.Tensor:
        k = kernel_matrix(_features(params, x), params["landmarks"], basis)
        return k @ params["w"] + params["b"]

    def apply_clients(cparams: dict, x) -> torch.Tensor:
        """(C, B, n) features, (C, M, n)/(C, M, K)/(C, K) parameters →
        (C, B, K) logits: the closed form with a leading client axis."""
        k = kernel_matrix(_features(cparams, x), cparams["landmarks"], basis)
        return k @ cparams["w"] + cparams["b"][:, None, :]

    return Model(
        init=init,
        apply=apply,
        apply_clients=apply_clients,
        name=f"qkernel{n_qubits}q{n_landmarks}m",
    )


def init_landmarks_from_data(params: dict, x) -> dict:
    """Replace random landmarks with the first M training samples."""
    m = params["landmarks"].shape[0]
    if x.shape[0] < m:
        raise ValueError(f"need ≥{m} samples to seed {m} landmarks")
    return {**params, "landmarks": torch.as_tensor(
        x[:m], dtype=torch.float32, device=params["landmarks"].device)}
