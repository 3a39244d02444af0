"""Slot-sharded statevector engine, run in lockstep.

Counterpart of ``qfedx_tpu/parallel/sharded.py``. The 2^n-amplitude
state is split over D = 2^d slots of an sv group: qubits 0..d−1 are
*global* (their bits select the slot), qubits d..n−1 are *local* (the
axes of each slot's shard). Memory per slot is 2^(n−d) amplitudes, so
8 slots extend one device's qubit ceiling by 3.

The reference runs one program per device inside ``shard_map``; here
each process drives its own slots of the group in lockstep, and every
process of the group runs the same program. A state is a LIST of
per-slot shards, one ``CArray`` of shape (*lead, 2, …, 2) (n − d qubit
axes after any batch axes) on its slot's device for this process's
slots, None for another process's. Then:

- a gate on a global qubit reads each slot's partner shard through one
  helper (``_exchange``): ``.to()`` from a slot of this process, one
  ``torch.distributed.batch_isend_irecv`` per gate for every partner in
  another process (``_PairExchange``, whose backward is the same pair
  exchange of the cotangents: the pair permutation is its own
  inverse). Every partner is read before any shard is replaced, so
  nothing happens in place;
- ``psum`` sums this process's per-slot partials in slot order, then,
  when the group spans processes, one ``all_reduce`` over the group's
  process subgroup (``_GroupSum``; its backward is the same all-reduce
  of the cotangent, psum's own transpose);
- ``device_bit(q, j)`` is a Python int per slot.

Gradients. Inside one process autograd runs through the ``.to()``
copies, so a replicated parameter's gradient is the plain sum of its
per-slot paths and ``pmean_grad`` is the identity. Across processes
each member backpropagates its own copy of the same replicated loss:
a circuit parameter's path crosses the psum and comes out as the group
size times this process's partial, a readout parameter applied after
the sum comes out exact. ``pmean_grad``, the reference's, averages the
cotangents over the subgroup and repairs both at once; the model
applies it where the reference does (``models/vqc_sharded.py``).

The trajectory channels take the dense noisy model's draws: a (*lead,
≥k) Gumbel draw per channel and qubit, the branch argmax(log p + g)
with the Born weights p from ONE ``psum``, whose result every member
uses, so every slot picks the same branch and a sharded trajectory
equals the dense one sample for sample.

Device-bit convention: slot j = Σ_q bit_q << (d−1−q), qubit 0 the most
significant slot bit, so a dense (2,)*n state splits into shards by a
reshape (``from_dense``).

``sv_group(slots)`` names the slots a sharded model's ``apply`` runs
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
from qfedx_tpu_torch.utils import trees

_GROUP: contextvars.ContextVar = contextvars.ContextVar("qfedx_sv_group",
                                                       default=None)


@contextlib.contextmanager
def sv_group(slots):
    """Run sharded models' forwards inside the block on ``slots`` (one
    entry per slot of the sv group: mesh ``Slot``s, whose ranks say
    which process owns each, or torch devices, all this process's)."""
    from qfedx_tpu_torch.parallel.mesh import Slot, process_index

    me = process_index()
    group = tuple(s if isinstance(s, Slot) else Slot(torch.device(s), me)
                  for s in slots)
    token = _GROUP.set(group)
    try:
        yield group
    finally:
        _GROUP.reset(token)


def current_group() -> tuple | None:
    """The ``Slot``s ``sv_group`` named, or None outside one."""
    return _GROUP.get()


class ShardCtx(NamedTuple):
    """Sharding geometry: the sv axis name, n qubits, d global qubits,
    the 2^d slots' devices, and who owns them: each slot's rank
    (``ranks``, None: every slot this process's), this process's rank
    and the group's process subgroup (None inside one process)."""

    axis: str
    n_qubits: int
    n_global: int
    devices: tuple
    ranks: tuple | None = None
    rank: int = 0
    group: object = None

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

    def owns(self, slot: int) -> bool:
        """Is ``slot`` this process's?"""
        return self.ranks is None or self.ranks[slot] == self.rank

    @property
    def local_slots(self) -> list:
        """This process's slots, in slot order."""
        return [j for j in range(self.n_devices) if self.owns(j)]

    @property
    def home(self) -> torch.device:
        """This process's first slot's device: where sums land."""
        return self.device(self.local_slots[0])


def shard_ctx(axis: str, n_qubits: int, n_global: int, slots) -> ShardCtx:
    """The ``ShardCtx`` of an sv group of ``slots`` (mesh ``Slot``s), its
    process subgroup looked up when the slots span processes."""
    from qfedx_tpu_torch.parallel.mesh import process_index, process_subgroup

    return ShardCtx(axis, n_qubits, n_global,
                    tuple(s.device for s in slots),
                    tuple(s.rank for s in slots), process_index(),
                    process_subgroup(slots))


def _each(fn, state: list) -> list:
    """``fn`` on every shard this process holds; None stays None."""
    return [None if s is None else fn(s) for s in state]


def _first(state: list):
    return next(s for s in state if s is not None)


def _lead_nd(ctx: ShardCtx, shard: CArray) -> int:
    return shard.ndim - ctx.n_local


# --- the transport -----------------------------------------------------------


def _p2p(ctx: ShardCtx, mask: int, slots: list, tensors, k: int) -> list:
    """One ``batch_isend_irecv``: this process's slot ``slots[i]`` sends
    its ``k`` tensors ``tensors[i·k:(i+1)·k]`` to its partner slot
    ``slots[i] ^ mask`` in another process and receives the partner's,
    returned in the same order. NCCL matches a rank pair's messages in
    the order posted (sends by destination slot, receives by own slot,
    so both ends agree), gloo by tag (the sending slot's)."""
    import torch.distributed as dist

    from qfedx_tpu_torch.parallel.mesh import check_backend

    sends, recvs, bufs = [], [], []
    for i, j in enumerate(slots):
        p = j ^ mask
        for m in range(k):
            t = tensors[i * k + m].contiguous()
            check_backend(t, ctx.group)
            buf = torch.empty_like(t)
            sends.append((p, dist.P2POp(dist.isend, t, ctx.ranks[p],
                                        ctx.group, tag=j * k + m)))
            recvs.append((j, dist.P2POp(dist.irecv, buf, ctx.ranks[p],
                                        ctx.group, tag=p * k + m)))
            bufs.append(buf)
    ops = [op for _, op in sorted(sends, key=lambda e: e[0])]
    ops += [op for _, op in sorted(recvs, key=lambda e: e[0])]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return bufs


class _PairExchange(torch.autograd.Function):
    """Partner shards from other processes; backward: the cotangents go
    back over the same pairs."""

    @staticmethod
    def forward(fctx, plan, *tensors):
        fctx.plan = plan
        return tuple(_p2p(*plan, tensors, len(tensors) // len(plan[2])))

    @staticmethod
    def backward(fctx, *grads):
        plan = fctx.plan
        return (None, *_p2p(*plan, grads, len(grads) // len(plan[2])))


def _exchange(ctx: ShardCtx, sends: list, mask: int) -> list:
    """``out[j] = sends[j ^ mask]`` on slot j's device for this process's
    slots j: ``sends[j]`` a tuple of tensors per own slot (None for
    another process's). Partners in this process come by ``.to()``, all
    partners in other processes by one ``_PairExchange``, posted before
    any shard is replaced."""
    out = [None] * len(sends)
    remote = []
    for j in ctx.local_slots:
        p = j ^ mask
        if ctx.owns(p):
            dev = sends[j][0].device
            out[j] = tuple(t.to(dev) for t in sends[p])
        else:
            remote.append(j)
    if remote:
        k = len(sends[remote[0]])
        got = _PairExchange.apply((ctx, mask, remote),
                                  *(t for j in remote for t in sends[j]))
        for i, j in enumerate(remote):
            out[j] = tuple(got[i * k:(i + 1) * k])
    return out


class _GroupSum(torch.autograd.Function):
    """Σ over the subgroup's processes: one ``all_reduce``, whose result
    every member uses; backward: the same all-reduce of the cotangent."""

    @staticmethod
    def forward(fctx, group, x):
        import torch.distributed as dist

        from qfedx_tpu_torch.parallel.mesh import check_backend

        fctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        check_backend(y, group)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(fctx, g):
        import torch.distributed as dist

        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=fctx.group)
        return None, g


class _GroupMeanGrad(torch.autograd.Function):
    """Identity whose backward averages the cotangents over the subgroup,
    every leaf in one flat all-reduce."""

    @staticmethod
    def forward(fctx, group, *leaves):
        fctx.group = group
        return tuple(t.clone() for t in leaves)

    @staticmethod
    def backward(fctx, *grads):
        import torch.distributed as dist

        from qfedx_tpu_torch.parallel.mesh import check_backend

        flat = torch.cat([g.reshape(-1).float() for g in grads])
        check_backend(flat, fctx.group)
        dist.all_reduce(flat, group=fctx.group)
        flat = flat / dist.get_world_size(fctx.group)
        out, i = [], 0
        for g in grads:
            out.append(flat[i:i + g.numel()].reshape(g.shape).to(g.dtype))
            i += g.numel()
        return (None, *out)


def pmean_grad(tree, ctx: ShardCtx):
    """Identity on ``tree``'s leaves whose backward averages each
    cotangent over the sv group's processes (the reference's
    ``pmean_grad``): a circuit parameter, used before the psum, comes
    back as the group size times this process's partial and leaves as
    the sum of the partials; a readout parameter, used after it, is the
    same on every member and stays. Inside one process: ``tree``
    unchanged."""
    if ctx.group is None:
        return tree
    leaves = trees.tree_leaves(tree)
    it = iter(_GroupMeanGrad.apply(ctx.group, *leaves))
    return trees.tree_map(lambda _: next(it), tree)


def psum(parts: list, ctx: ShardCtx | None = None) -> torch.Tensor:
    """Σ over slots of per-slot tensors: this process's (the non-None
    entries) in slot order on its first slot's device, then over the
    group's processes (``ctx.group``) in one all-reduce."""
    local = [p for p in parts if p is not None]
    dev = local[0].device
    total = local[0]
    for p in local[1:]:
        total = total + p.to(dev)
    if ctx is not None and ctx.group is not None:
        total = _GroupSum.apply(ctx.group, total)
    return total


# --- state constructors ----------------------------------------------------


def zero_state_local(ctx: ShardCtx, lead: tuple = ()) -> list:
    """Shards of |0…0⟩: amplitude 1 lives on slot 0."""
    out = [None] * ctx.n_devices
    for j in ctx.local_slots:
        re = torch.zeros(tuple(lead) + (1 << ctx.n_local,),
                         dtype=state_dtype(), device=ctx.device(j))
        if j == 0:
            re[..., 0] = 1.0
        out[j] = CArray(re.reshape(tuple(lead) + (2,) * ctx.n_local), None)
    return out


def product_state_local(ctx: ShardCtx, amps: CArray) -> list:
    """Shards of ⊗_q (amps[…, q, 0]|0⟩ + amps[…, q, 1]|1⟩); amps
    (*lead, n, 2). Local qubits tensor-product as in the dense engine;
    each global qubit contributes the scalar amps[…, q, bit_q(slot)] —
    the angle encoder at sharded widths with no exchange."""
    g = ctx.n_global
    out = [None] * ctx.n_devices
    for j in ctx.local_slots:
        dev = ctx.device(j)
        a = CArray(amps.re.to(dev), None if amps.im is None
                   else amps.im.to(dev))
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
            out[j] = local
            continue
        view = tuple(scale_re.shape) + (1,) * ctx.n_local
        s_re = scale_re.reshape(view)
        if scale_im is None:
            out[j] = CArray(local.re * s_re,
                            None if local.im is None else local.im * s_re)
            continue
        s_im = scale_im.reshape(view)
        l_im = local.imag_or_zeros()
        out[j] = CArray(local.re * s_re - l_im * s_im,
                        local.re * s_im + l_im * s_re)
    return out


def from_dense(ctx: ShardCtx, state: CArray) -> list:
    """Dense (*lead, 2, …, 2) CArray → this process's slots' shards."""
    lead = tuple(state.shape[:state.ndim - ctx.n_qubits])
    view = lead + (ctx.n_devices,) + (2,) * ctx.n_local

    def part(t, j):
        return t.reshape(view).select(len(lead), j).to(ctx.device(j))

    return [CArray(part(state.re, j),
                   None if state.im is None else part(state.im, j))
            if ctx.owns(j) else None for j in range(ctx.n_devices)]


def gather_dense(ctx: ShardCtx, state: list) -> CArray:
    """The slots' shards → one dense (*lead, 2, …, 2) CArray on slot 0's
    device (a readback for tests and checks, inside one process: under
    a group across processes no process holds every shard)."""
    if any(s is None for s in state):
        raise ValueError("gather_dense reads every shard; this sv group "
                         "spans processes and each holds only its own")
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
            if ctx.owns(j) else None for j in range(ctx.n_devices)]


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
        return _each(lambda s: sv.apply_gate(s, gate, ctx.local_axis(qubit),
                                             n_l), state)
    mask = ctx.device_mask(qubit)
    has_im = _first(state).im is not None
    theirs = _exchange(ctx, [None if s is None else (
        (s.re, s.im) if has_im else (s.re,)) for s in state], mask)
    out = [None] * len(state)
    for j in ctx.local_slots:
        mine = state[j]
        g = sv._cast_gate(gate, mine)
        b = ctx.device_bit(qubit, j)
        out[j] = _scale_add(mine, _gate_elem(g, b, b), CArray(*theirs[j])
                            if has_im else CArray(theirs[j][0], None),
                            _gate_elem(g, b, 1 - b))
    return out


def swap_global_local(ctx: ShardCtx, state: list, g: int, l: int) -> list:
    """SWAP of global qubit ``g`` and local qubit ``l``: slot j keeps its
    l = b slice (b its g-bit) and takes its partner's l = b slice, which
    lands at l = 1 − b — half a shard exchanged: each slot sends its
    l = 1 − b slice."""
    assert g < ctx.n_global <= l < ctx.n_qubits
    mask = ctx.device_mask(g)

    def parts(s: CArray) -> tuple:
        return (s.re,) if s.im is None else (s.re, s.im)

    def axis(x: torch.Tensor) -> int:
        return x.ndim - ctx.n_local + ctx.local_axis(l)

    sends = [None] * len(state)
    for j in ctx.local_slots:
        b = ctx.device_bit(g, j)
        sends[j] = tuple(x.select(axis(x), 1 - b) for x in parts(state[j]))
    recv = _exchange(ctx, sends, mask)
    out = [None] * len(state)
    for j in ctx.local_slots:
        b = ctx.device_bit(g, j)
        halves = []
        for x, r in zip(parts(state[j]), recv[j]):
            keep = x.select(axis(x), b)
            halves.append(torch.stack([keep, r] if b == 0 else [r, keep],
                                      dim=axis(x)))
        out[j] = CArray(halves[0], halves[1] if len(halves) > 1 else None)
    return out


def apply_gate_2q_sharded(ctx: ShardCtx, state: list, gate: CArray,
                          q1: int, q2: int) -> list:
    """A (2, 2, 2, 2) gate on any qubit pair: global qubits are swapped
    into scratch local positions, the gate applied locally, then swapped
    back."""
    assert q1 != q2

    def local_apply(s, a1, a2):
        return _each(lambda x: sv.apply_gate_2q(
            x, gate, ctx.local_axis(a1), ctx.local_axis(a2), ctx.n_local), s)

    return _sharded_2q(ctx, state, q1, q2, local_apply)


def apply_cnot_sharded(ctx: ShardCtx, state: list, ctrl: int,
                       tgt: int) -> list:
    """CNOT with ``apply_gate_2q_sharded``'s choreography, applied
    locally through ``sv.apply_cnot`` (a select, no arithmetic)."""
    assert ctrl != tgt

    def local_apply(s, a1, a2):
        return _each(lambda x: sv.apply_cnot(
            x, ctx.local_axis(a1), ctx.local_axis(a2), n=ctx.n_local), s)

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
    picked per state by argmax(log p + g) — the same on every slot, the
    weights from one sum whose result every process of the group uses —
    and renormalised."""
    n_k = kraus.re.shape[0]
    outs = [apply_gate_sharded(ctx, state, trajectory._kraus_op(kraus, i),
                               qubit) for i in range(n_k)]
    probs = psum([
        torch.stack([sv.probabilities(o[j], ctx.n_local).sum(dim=-1)
                     for o in outs]) if ctx.owns(j) else None
        for j in range(len(state))], ctx)
    with torch.no_grad():
        logits = torch.log(torch.clamp(probs, min=1e-30))
        g = torch.as_tensor(gumbel, device=probs.device)[..., :n_k]
        idx = torch.argmax(logits + torch.movedim(g, -1, 0), dim=0)
    if trajectory._branch_log is not None:
        trajectory._branch_log.append(idx)
    norm = torch.sqrt(torch.clamp(trajectory._select(probs, idx),
                                  min=1e-30))
    any_im = any(_first(o).im is not None for o in outs)
    out = [None] * len(state)
    for j in ctx.local_slots:
        dev = state[j].re.device
        idx_j = idx.to(dev)
        lead = tuple(state[j].shape[:_lead_nd(ctx, state[j])])
        re = trajectory._select(torch.stack([o[j].re for o in outs]), idx_j)
        im = (trajectory._select(
            torch.stack([o[j].imag_or_zeros() for o in outs]), idx_j)
            if any_im else None)
        nrm = norm.to(dev, re.dtype).reshape(lead + (1,) * ctx.n_local)
        out[j] = CArray(re / nrm, None if im is None else im / nrm)
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
    """⟨Z_qubit⟩, (*lead,) f32 on this process's first slot's device."""
    parts = [None] * len(state)
    for j in ctx.local_slots:
        s = state[j]
        if qubit >= ctx.n_global:
            parts[j] = sv.expect_z(s, ctx.local_axis(qubit), ctx.n_local)
        else:
            parts[j] = (_sign(ctx, qubit, j)
                        * sv.probabilities(s, ctx.n_local).sum(dim=-1))
    return psum(parts, ctx)


def expect_z_all_sharded(ctx: ShardCtx, state: list) -> torch.Tensor:
    """⟨Z_k⟩ for every qubit, (*lead, n) f32 on this process's first
    slot's device: one sum over the slots for all qubits."""
    parts = [None] * len(state)
    for j in ctx.local_slots:
        s = state[j]
        total = sv.probabilities(s, ctx.n_local).sum(dim=-1)
        glob = [_sign(ctx, q, j) * total for q in range(ctx.n_global)]
        local = sv.expect_z_all(s, ctx.n_local)
        parts[j] = (torch.cat([torch.stack(glob, dim=-1), local], dim=-1)
                    if glob else local)
    return psum(parts, ctx)


def norm_sq_sharded(ctx: ShardCtx, state: list) -> torch.Tensor:
    """‖ψ‖² (should be 1) — a correctness probe across all shards."""
    return psum(_each(lambda s: sv.probabilities(s, ctx.n_local).sum(dim=-1),
                      state), ctx)
