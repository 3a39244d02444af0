"""Slot-sharded statevector engine, run in lockstep.

Counterpart of ``qfedx_tpu/parallel/sharded.py``. The 2^n-amplitude
state is split over D = 2^d slots of an sv group: qubits 0..d−1 are
*global* (their bits select the slot), qubits d..n−1 are *local* (the
axes of each slot's shard). Memory per slot is 2^(n−d) amplitudes, so
8 slots extend one device's qubit ceiling by 3.

The reference runs one program per device inside ``shard_map``; here
one process drives every slot of the group in lockstep. A state is a
LIST of per-slot shards, one ``CArray`` of shape (*lead, 2, …, 2)
(n − d qubit axes after any batch axes) on its slot's device, and:

- a gate on a global qubit reads the partner's shard as
  ``shards[j ^ mask].to(dev_j)``; every partner is read before any
  shard is replaced, so nothing happens in place;
- ``psum`` is a sum of per-slot partials moved to slot 0's device, in
  slot order, and copied back where a slot needs it;
- ``device_bit(q, j)`` is a Python int per slot.

Autograd runs through the ``.to()`` copies, so a replicated parameter's
gradient comes out as the plain sum of its per-slot paths: the
reference's ``pmean_grad``, which repairs ``shard_map``'s transpose of
its psum, has no counterpart here (``tests/test_torch_sharded.py``
holds the gradient against the dense engine and against the
reference's sharded gradient).

The trajectory channels take the dense noisy model's draws: a (*lead,
≥k) Gumbel draw per channel and qubit, the branch argmax(log p + g)
with the Born weights p summed over the slots first, so every slot
picks the same branch and a sharded trajectory equals the dense one
sample for sample.

Device-bit convention: slot j = Σ_q bit_q << (d−1−q), qubit 0 the most
significant slot bit, so a dense (2,)*n state splits into shards by a
reshape (``from_dense``).

``sv_group(devices)`` names the slots a sharded model's ``apply`` runs
on (``models/vqc_sharded.py``); the mesh round and ``host_apply`` set
it.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import NamedTuple

import torch

from qfedx_tpu_torch.noise import trajectory
from qfedx_tpu_torch.ops import statevector as sv
from qfedx_tpu_torch.ops.cpx import CArray, state_dtype

_GROUP: contextvars.ContextVar = contextvars.ContextVar("qfedx_sv_group",
                                                       default=None)


@contextlib.contextmanager
def sv_group(devices):
    """Run sharded models' forwards inside the block on ``devices`` (one
    entry per slot of the sv group: torch devices or mesh ``Slot``s)."""
    devs = tuple(torch.device(getattr(d, "device", d)) for d in devices)
    token = _GROUP.set(devs)
    try:
        yield devs
    finally:
        _GROUP.reset(token)


def current_group() -> tuple | None:
    """The slots ``sv_group`` named, or None outside one."""
    return _GROUP.get()


class ShardCtx(NamedTuple):
    """Sharding geometry: the sv axis name, n qubits, d global qubits
    and the 2^d slots' devices."""

    axis: str
    n_qubits: int
    n_global: int
    devices: tuple

    @property
    def n_local(self) -> int:
        return self.n_qubits - self.n_global

    @property
    def n_devices(self) -> int:
        return 1 << self.n_global

    def local_axis(self, qubit: int) -> int:
        """Axis of ``qubit`` among a shard's qubit axes (qubit local)."""
        return qubit - self.n_global

    def device_mask(self, qubit: int) -> int:
        """Bitmask selecting ``qubit``'s bit in the slot index."""
        return 1 << (self.n_global - 1 - qubit)

    def device_bit(self, qubit: int, slot: int) -> int:
        """Slot ``slot``'s value of global ``qubit``."""
        return (slot >> (self.n_global - 1 - qubit)) & 1

    def device(self, slot: int) -> torch.device:
        return torch.device(self.devices[slot])


def _move(c: CArray, dev) -> CArray:
    return CArray(c.re.to(dev), None if c.im is None else c.im.to(dev))


def _lead_nd(ctx: ShardCtx, shard: CArray) -> int:
    return shard.ndim - ctx.n_local


def psum(parts: list) -> torch.Tensor:
    """Σ over slots of per-slot tensors, in slot order, on slot 0's
    device."""
    dev = parts[0].device
    total = parts[0]
    for p in parts[1:]:
        total = total + p.to(dev)
    return total


# --- state constructors ----------------------------------------------------


def zero_state_local(ctx: ShardCtx, lead: tuple = ()) -> list:
    """Shards of |0…0⟩: amplitude 1 lives on slot 0."""
    out = []
    for j in range(ctx.n_devices):
        re = torch.zeros(tuple(lead) + (1 << ctx.n_local,),
                         dtype=state_dtype(), device=ctx.device(j))
        if j == 0:
            re[..., 0] = 1.0
        out.append(CArray(re.reshape(tuple(lead) + (2,) * ctx.n_local),
                          None))
    return out


def product_state_local(ctx: ShardCtx, amps: CArray) -> list:
    """Shards of ⊗_q (amps[…, q, 0]|0⟩ + amps[…, q, 1]|1⟩); amps
    (*lead, n, 2). Local qubits tensor-product as in the dense engine;
    each global qubit contributes the scalar amps[…, q, bit_q(slot)] —
    the angle encoder at sharded widths with no exchange."""
    g = ctx.n_global
    out = []
    for j in range(ctx.n_devices):
        a = _move(amps, ctx.device(j))
        local = sv.product_state(CArray(
            a.re[..., g:, :], None if a.im is None else a.im[..., g:, :]))
        scale_re, scale_im = None, None
        for q in range(g):
            b = ctx.device_bit(q, j)
            a_re = a.re[..., q, b]
            a_im = None if a.im is None else a.im[..., q, b]
            if scale_re is None:
                scale_re, scale_im = a_re, a_im
            elif a_im is None:
                scale_re = scale_re * a_re
                scale_im = None if scale_im is None else scale_im * a_re
            elif scale_im is None:
                scale_re, scale_im = scale_re * a_re, scale_re * a_im
            else:
                scale_re, scale_im = (scale_re * a_re - scale_im * a_im,
                                      scale_re * a_im + scale_im * a_re)
        if scale_re is None:
            out.append(local)
            continue
        view = tuple(scale_re.shape) + (1,) * ctx.n_local
        s_re = scale_re.reshape(view)
        if scale_im is None:
            out.append(CArray(local.re * s_re,
                              None if local.im is None else local.im * s_re))
            continue
        s_im = scale_im.reshape(view)
        l_im = local.imag_or_zeros()
        out.append(CArray(local.re * s_re - l_im * s_im,
                          local.re * s_im + l_im * s_re))
    return out


def from_dense(ctx: ShardCtx, state: CArray) -> list:
    """Dense (*lead, 2, …, 2) CArray → the slots' shards."""
    lead = tuple(state.shape[:state.ndim - ctx.n_qubits])
    view = lead + (ctx.n_devices,) + (2,) * ctx.n_local

    def part(t, j):
        return t.reshape(view).select(len(lead), j).to(ctx.device(j))

    return [CArray(part(state.re, j),
                   None if state.im is None else part(state.im, j))
            for j in range(ctx.n_devices)]


def gather_dense(ctx: ShardCtx, state: list) -> CArray:
    """The slots' shards → one dense (*lead, 2, …, 2) CArray on slot 0's
    device (a readback for tests and checks)."""
    dev = state[0].re.device
    lead_nd = _lead_nd(ctx, state[0])
    lead = tuple(state[0].shape[:lead_nd])

    def cat(parts):
        t = torch.stack([p.to(dev) for p in parts], dim=lead_nd)
        return t.reshape(lead + (2,) * ctx.n_qubits)

    im = (None if all(s.im is None for s in state)
          else cat([s.imag_or_zeros() for s in state]))
    return CArray(cat([s.re for s in state]), im)


def amplitude_encode_local(ctx: ShardCtx, x) -> list:
    """Shards of the amplitude-encoded state of features ``x`` (*lead,
    2^n): ℓ2-normalised in f32 (the uniform state for an all-zero row,
    as ``ops/batched.bstate_amplitude``), each slot taking its 2^(n−d)
    contiguous amplitudes."""
    x = torch.as_tensor(x, dtype=torch.float32)
    size = x.shape[-1]
    if size != (1 << ctx.n_qubits):
        raise ValueError(
            f"amplitude encoding needs {1 << ctx.n_qubits} features, got {size}"
        )
    lead = tuple(x.shape[:-1])
    norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    uniform = torch.full_like(x, 1.0 / size ** 0.5)
    safe = torch.where(
        norm > 0, x / torch.where(norm > 0, norm, torch.ones_like(norm)),
        uniform).to(state_dtype())
    block = 1 << ctx.n_local
    return [CArray(safe[..., j * block:(j + 1) * block].reshape(
                lead + (2,) * ctx.n_local).to(ctx.device(j)), None)
            for j in range(ctx.n_devices)]


# --- gate application ------------------------------------------------------


def _gate_elem(gate: CArray, r: int, c: int) -> CArray:
    return CArray(gate.re[..., r, c],
                  None if gate.im is None else gate.im[..., r, c])


def _scale_add(a: CArray, sa: CArray, b: CArray, sb: CArray) -> CArray:
    """sa·a + sb·b for shards a, b and scalar CArrays sa, sb."""

    def mul(t: CArray, s: CArray) -> CArray:
        if s.im is None:
            return CArray(t.re * s.re, None if t.im is None else t.im * s.re)
        ti = t.imag_or_zeros()
        return CArray(t.re * s.re - ti * s.im, t.re * s.im + ti * s.re)

    x, y = mul(a, sa), mul(b, sb)
    if x.im is None and y.im is None:
        return CArray(x.re + y.re, None)
    return CArray(x.re + y.re, x.imag_or_zeros() + y.imag_or_zeros())


def apply_gate_sharded(ctx: ShardCtx, state: list, gate: CArray,
                       qubit: int) -> list:
    """A (2, 2) gate on any qubit. Local: the dense engine on every
    shard. Global: slot j holds the bit = b half of each amplitude pair
    and its partner j ^ mask the other, so out_j = gate[b, b]·mine +
    gate[b, 1−b]·theirs."""
    n_l = ctx.n_local
    if qubit >= ctx.n_global:
        return [sv.apply_gate(s, gate, ctx.local_axis(qubit), n_l)
                for s in state]
    mask = ctx.device_mask(qubit)
    out = []
    for j, mine in enumerate(state):
        theirs = _move(state[j ^ mask], mine.re.device)
        g = sv._cast_gate(gate, mine)
        b = ctx.device_bit(qubit, j)
        out.append(_scale_add(mine, _gate_elem(g, b, b), theirs,
                              _gate_elem(g, b, 1 - b)))
    return out


def swap_global_local(ctx: ShardCtx, state: list, g: int, l: int) -> list:
    """SWAP of global qubit ``g`` and local qubit ``l``: slot j keeps its
    l = b slice (b its g-bit) and takes its partner's l = b slice, which
    lands at l = 1 − b — half a shard exchanged."""
    assert g < ctx.n_global <= l < ctx.n_qubits
    mask = ctx.device_mask(g)

    def swap_real(j: int, parts: list) -> torch.Tensor:
        x = parts[j]
        ax = x.ndim - ctx.n_local + ctx.local_axis(l)
        b = ctx.device_bit(g, j)
        keep = x.select(ax, b)
        recv = parts[j ^ mask].select(ax, b).to(x.device)
        pair = [keep, recv] if b == 0 else [recv, keep]
        return torch.stack(pair, dim=ax)

    res = [s.re for s in state]
    ims = None if state[0].im is None else [s.im for s in state]
    return [CArray(swap_real(j, res),
                   None if ims is None else swap_real(j, ims))
            for j in range(len(state))]


def apply_gate_2q_sharded(ctx: ShardCtx, state: list, gate: CArray,
                          q1: int, q2: int) -> list:
    """A (2, 2, 2, 2) gate on any qubit pair: global qubits are swapped
    into scratch local positions, the gate applied locally, then swapped
    back."""
    assert q1 != q2

    def local_apply(s, a1, a2):
        return [sv.apply_gate_2q(x, gate, ctx.local_axis(a1),
                                 ctx.local_axis(a2), ctx.n_local) for x in s]

    return _sharded_2q(ctx, state, q1, q2, local_apply)


def apply_cnot_sharded(ctx: ShardCtx, state: list, ctrl: int,
                       tgt: int) -> list:
    """CNOT with ``apply_gate_2q_sharded``'s choreography, applied
    locally through ``sv.apply_cnot`` (a select, no arithmetic)."""
    assert ctrl != tgt

    def local_apply(s, a1, a2):
        return [sv.apply_cnot(x, ctx.local_axis(a1), ctx.local_axis(a2),
                              n=ctx.n_local) for x in s]

    return _sharded_2q(ctx, state, ctrl, tgt, local_apply)


def _sharded_2q(ctx: ShardCtx, state: list, q1: int, q2: int, local_apply):
    globals_ = [q for q in (q1, q2) if q < ctx.n_global]
    if not globals_:
        return local_apply(state, q1, q2)
    if ctx.n_local < 2:
        raise ValueError("need ≥2 local qubits for sharded 2q gates")
    # Scratch local qubits not otherwise involved in the gate.
    in_use = {q1, q2}
    scratch = [q for q in range(ctx.n_global, ctx.n_qubits) if q not in in_use]
    mapping = {}  # global qubit → borrowed local position
    for g in globals_:
        mapping[g] = scratch.pop()
        state = swap_global_local(ctx, state, g, mapping[g])
    a1, a2 = mapping.get(q1, q1), mapping.get(q2, q2)
    state = local_apply(state, a1, a2)
    for g, l in reversed(list(mapping.items())):
        state = swap_global_local(ctx, state, g, l)
    return state


def apply_op_sharded(ctx: ShardCtx, state: list, op) -> list:
    """One IR op (``ops/fuse.Op``) through the sharded primitives — the
    per-gate path of ops that touch a global qubit; runs of fully local
    ops are fused on the shards instead
    (``parallel/circuit._apply_ops_sharded``)."""
    from qfedx_tpu_torch.ops import fuse

    if op.kind == "g1":
        return apply_gate_sharded(ctx, state, op.coeffs, op.qubits[0])
    if op.kind == "cnot":
        return apply_cnot_sharded(ctx, state, *op.qubits)
    if op.kind == "g2":
        return apply_gate_2q_sharded(ctx, state, op.coeffs, *op.qubits)
    if op.kind == "diag1":
        return apply_gate_sharded(ctx, state, fuse.diag1_gate(op.coeffs),
                                  op.qubits[0])
    if op.kind == "diag2":
        return apply_gate_2q_sharded(ctx, state, fuse.diag2_gate(op.coeffs),
                                     *op.qubits)
    raise ValueError(f"unknown IR op kind {op.kind!r}")


# --- noise channels (sampled Kraus trajectories) ----------------------------


def apply_channel_sharded(ctx: ShardCtx, state: list, kraus: CArray,
                          qubit: int, gumbel: torch.Tensor) -> list:
    """One sampled Kraus branch of a single-qubit channel on the sharded
    state (``noise/trajectory.apply_channel`` at sharded widths).
    ``kraus``: (k, 2, 2); ``gumbel``: (*lead, ≥k). Every branch is
    applied, the Born weights summed over the slots (f32), one branch
    picked per state by argmax(log p + g) — the same on every slot —
    and renormalised."""
    n_k = kraus.re.shape[0]
    outs = [apply_gate_sharded(ctx, state, trajectory._kraus_op(kraus, i),
                               qubit) for i in range(n_k)]
    probs = psum([
        torch.stack([sv.probabilities(o[j], ctx.n_local).sum(dim=-1)
                     for o in outs])
        for j in range(len(state))])
    with torch.no_grad():
        logits = torch.log(torch.clamp(probs, min=1e-30))
        g = torch.as_tensor(gumbel, device=probs.device)[..., :n_k]
        idx = torch.argmax(logits + torch.movedim(g, -1, 0), dim=0)
    if trajectory._branch_log is not None:
        trajectory._branch_log.append(idx)
    norm = torch.sqrt(torch.clamp(trajectory._select(probs, idx),
                                  min=1e-30))
    any_im = any(o[0].im is not None for o in outs)
    out = []
    for j in range(len(state)):
        dev = state[j].re.device
        idx_j = idx.to(dev)
        lead = tuple(state[j].shape[:_lead_nd(ctx, state[j])])
        re = trajectory._select(torch.stack([o[j].re for o in outs]), idx_j)
        im = (trajectory._select(
            torch.stack([o[j].imag_or_zeros() for o in outs]), idx_j)
            if any_im else None)
        nrm = norm.to(dev, re.dtype).reshape(lead + (1,) * ctx.n_local)
        out.append(CArray(re / nrm, None if im is None else im / nrm))
    return out


def apply_channel_all_sharded(ctx: ShardCtx, state: list, kraus: CArray,
                              gumbel: torch.Tensor) -> list:
    """The channel on every qubit, global and local, qubit 0 first;
    ``gumbel``: (*lead, n, ≥k), row q for qubit q — the dense
    ``apply_channel_all``'s layout, so both consume the same draws."""
    for q in range(ctx.n_qubits):
        state = apply_channel_sharded(ctx, state, kraus, q, gumbel[..., q, :])
    return state


# --- observables -----------------------------------------------------------


def _sign(ctx: ShardCtx, qubit: int, slot: int) -> float:
    return 1.0 - 2.0 * ctx.device_bit(qubit, slot)


def expect_z_sharded(ctx: ShardCtx, state: list, qubit: int) -> torch.Tensor:
    """⟨Z_qubit⟩, (*lead,) f32 on slot 0's device."""
    parts = []
    for j, s in enumerate(state):
        if qubit >= ctx.n_global:
            parts.append(sv.expect_z(s, ctx.local_axis(qubit), ctx.n_local))
        else:
            parts.append(_sign(ctx, qubit, j)
                         * sv.probabilities(s, ctx.n_local).sum(dim=-1))
    return psum(parts)


def expect_z_all_sharded(ctx: ShardCtx, state: list) -> torch.Tensor:
    """⟨Z_k⟩ for every qubit, (*lead, n) f32 on slot 0's device: one sum
    over the slots for all qubits."""
    parts = []
    for j, s in enumerate(state):
        total = sv.probabilities(s, ctx.n_local).sum(dim=-1)
        glob = [_sign(ctx, q, j) * total for q in range(ctx.n_global)]
        local = sv.expect_z_all(s, ctx.n_local)
        parts.append(torch.cat([torch.stack(glob, dim=-1), local], dim=-1)
                     if glob else local)
    return psum(parts)


def norm_sq_sharded(ctx: ShardCtx, state: list) -> torch.Tensor:
    """‖ψ‖² (should be 1) — a correctness probe across all shards."""
    return psum([sv.probabilities(s, ctx.n_local).sum(dim=-1)
                      for s in state])
