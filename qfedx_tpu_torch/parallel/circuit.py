"""The sharded VQC forward: encoder → hardware-efficient ansatz → ⟨Z⟩ on
the slot-sharded state.

Counterpart of ``qfedx_tpu/parallel/circuit.py``: the circuit is the
dense path's (``circuits/ansatz.hea_layer_ops``, gate for gate); only
the gate application changes. The reference's ``lax.scan`` over layers
is the layer loop here, the same ops in the same order. No route of
this module reaches the scan-body kernel: runs of local ops go through
the torch fused engine (``ops/fuse.fuse_ops`` and ``apply_fused``) on
each shard, as the reference's go through ``fuse.apply_fused``, never
``fuse.apply_scan``.
"""

from __future__ import annotations

import math

from qfedx_tpu_torch import obs
from qfedx_tpu_torch.circuits.ansatz import hea_layer_ops
from qfedx_tpu_torch.circuits.encoders import angle_amplitudes
from qfedx_tpu_torch.ops import fuse
from qfedx_tpu_torch.ops.statevector import _LANE_BITS
from qfedx_tpu_torch.parallel.mesh import is_member, sv_process_groups
from qfedx_tpu_torch.parallel.sharded import (
    ShardCtx,
    amplitude_encode_local,
    apply_channel_all_sharded,
    apply_op_sharded,
    expect_z_all_sharded,
    pmean_grad,
    product_state_local,
    shard_ctx,
)


def _apply_ops_sharded(ctx: ShardCtx, state: list, ops: list) -> list:
    """Run an IR segment on the sharded state. With the fusion pass
    active (QFEDX_FUSE, and at least one lane register of local qubits)
    maximal runs of fully LOCAL ops are remapped to local axes, fused and
    applied to every shard; an op on a GLOBAL qubit is a barrier, applied
    per gate through the exchange primitives in its original order (and
    counted as ``sharded.global_barrier_ops``). Off the fused route this
    is the per-gate loop."""
    fused_route = fuse.fuse_active(ctx.n_local, min_width=_LANE_BITS)
    with obs.span("engine.trace", engine="sharded", ops=len(ops)):
        if not fused_route:
            for op in ops:
                state = apply_op_sharded(ctx, state, op)
            return state
        run: list = []

        def flush(state):
            if run:
                local = [fuse.Op(o.kind,
                                 tuple(ctx.local_axis(q) for q in o.qubits),
                                 o.coeffs) for o in run]
                program = fuse.fuse_ops(local, ctx.n_local)
                state = [None if s is None
                         else fuse.apply_fused(s, program, ctx.n_local)
                         for s in state]
                run.clear()
            return state

        for op in ops:
            if min(op.qubits) >= ctx.n_global:
                run.append(op)
            else:
                obs.counter("sharded.global_barrier_ops")
                state = flush(state)
                state = apply_op_sharded(ctx, state, op)
        return flush(state)


def sharded_encoded_state(ctx: ShardCtx, features, encoding: str) -> list:
    """Encoder → shards. angle: the product state, no exchange;
    amplitude: each slot's slice of the normalised features."""
    if encoding == "angle":
        return product_state_local(ctx, angle_amplitudes(features * math.pi,
                                                         "ry"))
    if encoding == "amplitude":
        return amplitude_encode_local(ctx, features)
    raise ValueError(f"unknown sharded encoding {encoding!r}")


def sharded_hea_state(ctx: ShardCtx, features, params: dict,
                      encoding: str = "angle", channels: tuple = (),
                      gumbel=None) -> list:
    """Encode ``features`` (*lead, feat) and run the HEA on the sharded
    state, gate for gate as ``circuits.ansatz.hardware_efficient``; with
    ``channels`` (stacked Kraus sets) every channel acts on every qubit
    after every layer, its branches from ``gumbel`` (*lead, L,
    channels, n, ≥k), as ``models.vqc``'s trajectory forward."""
    state = sharded_encoded_state(ctx, features, encoding)
    for layer in range(params["rx"].shape[-2]):
        state = _apply_ops_sharded(ctx, state, hea_layer_ops(
            ctx.n_qubits, params["rx"][..., layer, :],
            params["rz"][..., layer, :]))
        for ci, kraus in enumerate(channels):
            state = apply_channel_all_sharded(ctx, state, kraus,
                                              gumbel[..., layer, ci, :, :])
    return state


def make_sharded_forward(n_qubits: int, mesh, axis: str = "sv"):
    """Build ``forward(params, x) -> ⟨Z⟩ per qubit`` on the first of the
    mesh's sv groups that this process is a member of, with ``ctx``
    (every rank calls this: the groups' process subgroups are made
    here). ``x``: features (*lead, n_qubits); the axis size must be a
    power of two leaving ≥ 2 local qubits."""
    size = mesh.shape[axis]
    n_global = (size - 1).bit_length()
    if 1 << n_global != size:
        raise ValueError(f"mesh axis {axis} size {size} is not a power of two")
    if n_qubits - n_global < 2:
        raise ValueError("need ≥2 local qubits (mesh too large for qubit count)")
    groups = mesh.sv_groups(axis)
    sv_process_groups(groups)
    ctx = shard_ctx(axis, n_qubits, n_global,
                    next(g for g in groups if is_member(g)))

    def forward(params, x):
        params = pmean_grad(params, ctx)
        return expect_z_all_sharded(ctx, sharded_hea_state(ctx, x, params))

    return forward, ctx
