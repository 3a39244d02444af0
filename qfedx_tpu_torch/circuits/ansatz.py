"""Hardware-efficient ansatz on the dense and the batched slab engines.

Counterpart of ``qfedx_tpu/circuits/ansatz.py`` (``init_ansatz_params``,
``_ring_ops``, ``hea_layer_ops``, ``hea_scan_ops``, ``ansatz_layer``,
``hardware_efficient`` and their ``_b``/``_cb`` twins): per-qubit
RZ(φ)·RX(θ) rotations followed by a CNOT entangler ring, L layers deep.

Angles come as ``{"rx": (*g, L, n), "rz": (*g, L, n)}``: g = () shared,
g = (C,) per client (the layer axis is always second to last), so one
function serves the reference's shared and client-folded twins. Three
routes, as there:
- scan: the L layers as ONE layer-stacked IR trace, fused by
  ``fuse.fuse_ops_stacked`` and run by ``fuse.apply_scan`` (the
  scan-body kernel on the card), where ``fuse.scan_active``;
- per-layer fused: each layer's trace through ``fuse.fuse_ops`` and
  ``fuse.apply_fused_b``, where ``fuse.fuse_active`` (slab widths) but
  not the scan;
- gate by gate below the slab widths or with QFEDX_FUSE off.
A dense state at the slab widths runs as its batched slab (one reshape
each way). ``remat`` (the dense route's option, as in the reference)
checkpoints each layer (``torch.utils.checkpoint``, non-reentrant):
autograd keeps one state per layer and recomputes the layer in the
backward; it keeps the per-layer loop and never enters the scan.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from qfedx_tpu_torch.ops import fuse, gates
from qfedx_tpu_torch.ops import statevector as sv


def _ring_ops(n_qubits: int) -> list:
    """IR trace of the CNOT entangler ring (0→1), …, (n−2→n−1), (n−1→0)."""
    if n_qubits < 2:
        return []
    ops = [fuse.Op("cnot", (q, q + 1)) for q in range(n_qubits - 1)]
    if n_qubits > 2:
        ops.append(fuse.Op("cnot", (n_qubits - 1, 0)))
    return ops


def hea_layer_ops(n_qubits: int, rx_angles, rz_angles) -> list:
    """IR trace of one layer: angles (*g, n) — shared (n,) or per client
    (C, n), the reference's ``hea_layer_ops``/``_hea_layer_ops_b``/
    ``_hea_layer_ops_cb`` in one — so each rotation is a (*g, 2, 2)
    stack, then the CNOT ring."""
    return [
        fuse.Op("g1", (q,), gates.rot_zx_batched(rx_angles[..., q],
                                                 rz_angles[..., q]))
        for q in range(n_qubits)
    ] + _ring_ops(n_qubits)


def hea_scan_ops(n_qubits: int, rx_stack, rz_stack) -> list:
    """Layer-STACKED IR trace of the HEA: ``rx_stack``/``rz_stack`` carry
    a leading layer axis — (L, n) shared, (L, C, n) client-folded — so
    each qubit's rotation is a (L[,C],2,2) stack."""
    return hea_layer_ops(n_qubits, rx_stack, rz_stack)


def _scan_program(n_qubits: int, params: dict) -> fuse.ScanProgram:
    """The stacked program of (*g, L, n) angles: the layer axis leads the
    stack and a client axis stays a coefficient group (G = C)."""
    n_layers = params["rx"].shape[-2]
    ops = hea_scan_ops(n_qubits, params["rx"].movedim(-2, 0),
                       params["rz"].movedim(-2, 0))
    return fuse.fuse_ops_stacked(ops, n_qubits, n_layers)


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


def _layers(layer_fn, state, n_qubits: int, params: dict, remat: bool):
    """The per-layer loop; ``remat`` checkpoints each layer."""
    for layer in range(params["rx"].shape[-2]):
        rx, rz = params["rx"][..., layer, :], params["rz"][..., layer, :]
        if remat:
            state = checkpoint(layer_fn, state, n_qubits, rx, rz,
                               use_reentrant=False)
        else:
            state = layer_fn(state, n_qubits, rx, rz)
    return state


# --- dense (*lead, 2, …, 2) states -------------------------------------------


def ansatz_layer(state, n_qubits: int, rx_angles, rz_angles):
    """One layer on a dense state, gate by gate (the slab widths run
    as the batched slab: ``hardware_efficient``)."""
    for q in range(n_qubits):
        gate = gates.rot_zx_batched(rx_angles[..., q], rz_angles[..., q])
        state = sv.apply_gate(state, gate, q, n_qubits)
    for op in _ring_ops(n_qubits):
        state = sv.apply_cnot(state, *op.qubits, n=n_qubits)
    return state


def hardware_efficient(state, n_qubits: int, params: dict,
                       remat: bool = False):
    """The L-layer HEA on a dense (*lead, 2, …, 2) state; per-client
    (C, L, n) angles left-align with a (C, B, …) state. At the slab
    widths the state is reshaped once to its (prod(lead), 2^n) slab and
    runs ``hardware_efficient_b`` (scan, fused or gate by gate, as
    there); below them gate by gate. ``remat`` checkpoints each layer
    and keeps the per-layer loop."""
    if n_qubits >= sv._SLAB_MIN:
        lead = tuple(state.shape[: state.ndim - n_qubits])
        out = hardware_efficient_b(sv.to_slab(state, n_qubits), n_qubits,
                                   params, remat)
        return sv.from_slab(out, lead, n_qubits)
    return _layers(ansatz_layer, state, n_qubits, params, remat)


# --- batched (B, 2^n) slabs ---------------------------------------------------


def ansatz_layer_b(state, n_qubits: int, rx_angles, rz_angles):
    """One layer on the batched slab: angles (n,) shared or (C, n) per
    client (the slab client-major, G = C). Through the fusion pass with
    QFEDX_FUSE on, gate by gate otherwise."""
    from qfedx_tpu_torch.ops.batched import apply_cnot_b, apply_gate_b

    if fuse.fuse_active(n_qubits):
        ops = hea_layer_ops(n_qubits, rx_angles, rz_angles)
        return fuse.apply_fused_b(state, n_qubits,
                                  fuse.fuse_ops(ops, n_qubits))
    for q in range(n_qubits):
        gate = gates.rot_zx_batched(rx_angles[..., q], rz_angles[..., q])
        state = apply_gate_b(state, n_qubits, gate, q)
    for op in _ring_ops(n_qubits):
        state = apply_cnot_b(state, n_qubits, *op.qubits)
    return state


def hardware_efficient_b(state, n_qubits: int, params: dict,
                         remat: bool = False):
    """The L-layer HEA on a batched (B, 2^n) slab: params (L, n) shared,
    or (C, L, n) per client on the (C·B, 2^n) client-major slab, each
    client's coefficients a group of its rows (the kernel's G = C).
    ``remat`` (the dense route's option) keeps the per-layer loop."""
    n_layers = params["rx"].shape[-2]
    if not remat and fuse.scan_active(n_qubits, n_layers):
        return fuse.apply_scan(state, n_qubits,
                               _scan_program(n_qubits, params), batched=True)
    return _layers(ansatz_layer_b, state, n_qubits, params, remat)
