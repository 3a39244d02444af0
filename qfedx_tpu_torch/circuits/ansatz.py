"""Hardware-efficient ansatz on the batched slab engine.

Counterpart of ``qfedx_tpu/circuits/ansatz.py`` (``init_ansatz_params``,
``_ring_ops``, ``hea_scan_ops``, ``hardware_efficient_b``): per-qubit
RZ(φ)·RX(θ) rotations followed by a CNOT entangler ring, L layers deep.
On the scan route the L layers are ONE layer-stacked IR trace, fused by
``fuse.fuse_ops_stacked`` and run by ``fuse.apply_scan`` (the scan-body
kernel on the card). With the scan route off (QFEDX_FUSE/QFEDX_SCAN_LAYERS
off, or a single layer) the layers run gate by gate.
"""

from __future__ import annotations

import numpy as np
import torch

from qfedx_tpu_torch.ops import fuse, gates


def _ring_ops(n_qubits: int) -> list:
    """IR trace of the CNOT entangler ring (0→1), …, (n−2→n−1), (n−1→0)."""
    if n_qubits < 2:
        return []
    ops = [fuse.Op("cnot", (q, q + 1)) for q in range(n_qubits - 1)]
    if n_qubits > 2:
        ops.append(fuse.Op("cnot", (n_qubits - 1, 0)))
    return ops


def hea_scan_ops(n_qubits: int, rx_stack, rz_stack) -> list:
    """Layer-STACKED IR trace of the HEA: ``rx_stack``/``rz_stack`` carry
    a leading layer axis — (L, n) shared, (L, C, n) client-folded — so
    each qubit's rotation is a (L[,C],2,2) stack."""
    return [
        fuse.Op(
            "g1",
            (q,),
            gates.rot_zx_batched(rx_stack[..., q], rz_stack[..., q]),
        )
        for q in range(n_qubits)
    ] + _ring_ops(n_qubits)


def init_ansatz_params(
    seed, n_qubits: int, n_layers: int, scale: float, device
) -> dict:
    """Small-angle init: scale·N(0,1) angles of shape (L, n). ``seed`` is
    an int or ``np.random.Generator`` (numpy draws), or a
    ``torch.Generator`` (torch draws on the CPU)."""
    shape = (n_layers, n_qubits)
    if isinstance(seed, torch.Generator):
        rx = scale * torch.randn(shape, generator=seed)
        rz = scale * torch.randn(shape, generator=seed)
    else:
        rng = np.random.default_rng(seed)
        rx = torch.as_tensor(scale * rng.standard_normal(shape))
        rz = torch.as_tensor(scale * rng.standard_normal(shape))
    return {
        "rx": rx.to(dtype=torch.float32, device=device),
        "rz": rz.to(dtype=torch.float32, device=device),
    }


def _entangle_ring_b(state, n_qubits: int):
    from qfedx_tpu_torch.ops.batched import apply_cnot_b

    for op in _ring_ops(n_qubits):
        state = apply_cnot_b(state, n_qubits, *op.qubits)
    return state


def hardware_efficient_b(state, n_qubits: int, params: dict):
    """The L-layer HEA on a batched (B, 2^n) slab state. params:
    {"rx": (L, n), "rz": (L, n)}."""
    from qfedx_tpu_torch.ops.batched import apply_gate_b

    n_layers = params["rx"].shape[0]
    if fuse.scan_active(n_qubits, n_layers):
        ops = hea_scan_ops(n_qubits, params["rx"], params["rz"])
        return fuse.apply_scan(
            state,
            n_qubits,
            fuse.fuse_ops_stacked(ops, n_qubits, n_layers),
            batched=True,
        )
    for layer in range(n_layers):
        for q in range(n_qubits):
            gate = gates.rot_zx(params["rx"][layer, q], params["rz"][layer, q])
            state = apply_gate_b(state, n_qubits, gate, q)
        state = _entangle_ring_b(state, n_qubits)
    return state
