"""Hardware-efficient and data-reuploading ansätze on the dense and the
batched slab engines.

Counterpart of ``qfedx_tpu/circuits/ansatz.py`` (``init_ansatz_params``,
``_ring_ops``, ``hea_layer_ops``, ``hea_scan_ops``, ``ansatz_layer``,
``hardware_efficient``, ``init_reuploading_params``,
``data_reuploading`` and their ``_b``/``_cb`` twins): per-qubit
RZ(φ)·RX(θ) rotations followed by a CNOT entangler ring, L layers deep;
the reupload circuit re-encodes the input before every layer but the
first as a bank of per-sample RY(w_l·π·x + b_l) rotations.

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

Reupload on the scan route (``fuse.scan_active(n, L − 1)``): layer 0
encodes |0…0⟩ alone (the log-depth product state, then one fused
layer), and the L − 1 [RY bank + layer] blocks share one stacked
program built from per-sample (L−1, B, 2, 2) bank stacks and shared or
per-client rotation stacks — the kernel's body with per-sample groups
(G = B) beside per-client ones (G = C).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from qfedx_tpu_torch.circuits.encoders import angle_amplitudes
from qfedx_tpu_torch.ops import fuse, gates
from qfedx_tpu_torch.ops import statevector as sv
from qfedx_tpu_torch.ops.statevector import product_state


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
    """One layer on a dense state: gate by gate below the slab widths; at
    them the state runs as its batched slab through ``ansatz_layer_b``
    (the fusion pass where it is on), as the reference's layer takes its
    fusion pass there."""
    if n_qubits >= sv._SLAB_MIN:
        lead = tuple(state.shape[: state.ndim - n_qubits])
        out = ansatz_layer_b(sv.to_slab(state, n_qubits), n_qubits,
                             rx_angles, rz_angles)
        return sv.from_slab(out, lead, n_qubits)
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


def ansatz_layer_b(state, n_qubits: int, rx_angles, rz_angles,
                   pre_ops=()):
    """One layer on the batched slab: angles (n,) shared or (C, n) per
    client (the slab client-major, G = C). Through the fusion pass with
    QFEDX_FUSE on, gate by gate otherwise. ``pre_ops``: IR ops run before
    the layer (the reupload encoder bank), fused into the same super-gates
    with it."""
    from qfedx_tpu_torch.ops.batched import apply_cnot_b, apply_gate_b

    if fuse.fuse_active(n_qubits):
        ops = list(pre_ops) + hea_layer_ops(n_qubits, rx_angles, rz_angles)
        return fuse.apply_fused_b(state, n_qubits,
                                  fuse.fuse_ops(ops, n_qubits))
    for op in pre_ops:
        state = apply_gate_b(state, n_qubits, op.coeffs, op.qubits[0])
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


# --- data reuploading ---------------------------------------------------------


def init_reuploading_params(
    seed, n_qubits: int, n_layers: int, scale: float, device
) -> dict:
    """``init_ansatz_params`` plus the per-layer affine re-encoding
    (w·x + b) of the input: enc_w = 1 + scale·N(0,1), enc_b =
    scale·N(0,1), each (L, n), drawn after rx and rz from one stream."""
    if not isinstance(seed, torch.Generator):
        seed = np.random.default_rng(seed)
    out = init_ansatz_params(seed, n_qubits, n_layers, scale, device)
    shape = (n_layers, n_qubits)
    if isinstance(seed, torch.Generator):
        w = torch.randn(shape, generator=seed)
        b = torch.randn(shape, generator=seed)
    else:
        w = torch.as_tensor(seed.standard_normal(shape))
        b = torch.as_tensor(seed.standard_normal(shape))
    out["enc_w"] = (1.0 + scale * w).to(dtype=torch.float32, device=device)
    out["enc_b"] = (scale * b).to(dtype=torch.float32, device=device)
    return out


def _reupload_angles(features, params: dict):
    """RY angles w_l·(π·x) + b_l of every layer: features (*lead, n) with
    params (*g, L, n), g a prefix of lead → (L, *lead, n)."""
    lead_nd = features.ndim - 1
    w = sv._align(params["enc_w"].movedim(-2, 0), 1, lead_nd + 1)
    b = sv._align(params["enc_b"].movedim(-2, 0), 1, lead_nd + 1)
    return w * (features * math.pi)[None] + b


def _bank_ops(angles) -> list:
    """The RY encoder bank as IR ops: angles (*stack, n) → one (*stack,
    2, 2) gate stack per qubit."""
    return [
        fuse.Op("g1", (q,), gates.ry_batched(angles[..., q]))
        for q in range(angles.shape[-1])
    ]


def data_reuploading(features, params: dict, remat: bool = False):
    """[encode(w_l·π·x + b_l) → variational layer] × L on the dense
    engine: features (*lead, n) in [0,1], params (*g, L, n) with g a
    prefix of lead (per-client parameters left-align with a (C, B, n)
    batch) → state (*lead, 2, …, 2). Layer 0 starts from the product
    state; later encodings are RY banks. At the slab widths the batch
    runs as its slab (``data_reuploading_b``); ``remat`` checkpoints each
    block."""
    n_qubits = features.shape[-1]
    lead = tuple(features.shape[:-1])
    if n_qubits >= sv._SLAB_MIN:
        # The leading axes flatten client-major: per-client parameters
        # group the slab's rows as data_reuploading_b expects.
        out = data_reuploading_b(features.reshape(-1, n_qubits), params,
                                 remat=remat)
        return sv.from_slab(out, lead, n_qubits)

    angles = _reupload_angles(features, params)

    def block(state, angles_l, rx_l, rz_l):
        for op in _bank_ops(angles_l):
            state = sv.apply_gate(state, op.coeffs, op.qubits[0], n_qubits)
        return ansatz_layer(state, n_qubits, rx_l, rz_l)

    state = product_state(angle_amplitudes(angles[0], "ry"))
    for layer in range(params["rx"].shape[-2]):
        rx, rz = params["rx"][..., layer, :], params["rz"][..., layer, :]
        if layer == 0:
            args, fn = (state, n_qubits, rx, rz), ansatz_layer
        else:
            args, fn = (state, angles[layer], rx, rz), block
        state = (checkpoint(fn, *args, use_reentrant=False) if remat
                 else fn(*args))
    return state


def data_reuploading_b(features, params: dict, remat: bool = False):
    """``data_reuploading`` on the batched slab: features (B, n), params
    (L, n) shared or (C, L, n) per client (B = C·S client-major rows) →
    (B, 2^n). Scan route (``fuse.scan_active(n, L − 1)``, not remat):
    layer 0 alone, then the L − 1 [bank + layer] blocks as one stacked
    program; otherwise a per-layer loop whose bank fuses into the layer
    (``ansatz_layer_b``'s ``pre_ops``); ``remat`` checkpoints each
    block."""
    from qfedx_tpu_torch.ops.batched import bstate_product, bstate_product_tree

    n_qubits = features.shape[-1]
    n_layers = params["rx"].shape[-2]
    g = params["rx"].ndim - 2
    if g:
        # (C, L, n) parameters: each client's rows are one contiguous
        # block of the slab, so the angles are (L, C, S, n) → (L, B, n).
        c = params["rx"].shape[0]
        angles = _reupload_angles(features.reshape(c, -1, n_qubits), params)
        angles = angles.reshape(n_layers, -1, n_qubits)
    else:
        angles = _reupload_angles(features, params)
    if not remat and fuse.scan_active(n_qubits, n_layers - 1):
        state = bstate_product_tree(angle_amplitudes(angles[0], "ry"))
        state = ansatz_layer_b(state, n_qubits, params["rx"][..., 0, :],
                               params["rz"][..., 0, :])
        rest = {k: params[k][..., 1:, :] for k in ("rx", "rz")}
        ops = _bank_ops(angles[1:]) + hea_scan_ops(
            n_qubits, rest["rx"].movedim(-2, 0), rest["rz"].movedim(-2, 0))
        program = fuse.fuse_ops_stacked(ops, n_qubits, n_layers - 1)
        return fuse.apply_scan(state, n_qubits, program, batched=True)

    def block(state, angles_l, rx_l, rz_l):
        return ansatz_layer_b(state, n_qubits, rx_l, rz_l,
                              pre_ops=_bank_ops(angles_l))

    state = bstate_product(angle_amplitudes(angles[0], "ry"))
    for layer in range(n_layers):
        rx, rz = params["rx"][..., layer, :], params["rz"][..., layer, :]
        if layer == 0:
            args, fn = (state, n_qubits, rx, rz), ansatz_layer_b
        else:
            args, fn = (state, angles[layer], rx, rz), block
        state = (checkpoint(fn, *args, use_reentrant=False) if remat
                 else fn(*args))
    return state


def data_reuploading_cb(features, params: dict, remat: bool = False):
    """Client-folded ``data_reuploading``: features (C, B, n), params
    (C, L, n) → the (C·B, 2^n) client-major slab; the banks are
    per-sample (G = C·B), the variational layers per client (G = C)."""
    c, b, n_qubits = features.shape
    return data_reuploading_b(features.reshape(c * b, n_qubits), params,
                              remat=remat)
