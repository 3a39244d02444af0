"""Meshes of slots, inside one process and across processes.

Counterpart of ``qfedx_tpu/parallel/mesh.py`` (``distributed_init``,
``fed_mesh``, ``hybrid_device_array``, ``hybrid_fed_mesh``), with the
axis policy kept:

- ``sv`` (statevector sharding) exchanges half a state per gate on a
  global qubit, so an sv group is a contiguous run of slots and never
  crosses a node (``hybrid_device_array``);
- ``clients`` (federated data parallelism) communicates once per round
  (one all-reduce of |θ| floats), so it may cross processes, outermost.

A ``Mesh`` is a 2-D array ``(clients, sv)`` of ``Slot``s. A slot is a
``torch.device`` plus the rank of the process that owns it, and a device
may repeat inside one process: the CPU tests put eight slots on
``"cpu"``, the card's smoke eight on ``cuda:0``. Each process runs its
own slots in lockstep (``parallel/sharded.py``). An sv group may span
processes, as a reference sv group spans the hosts of a slice: its
members run the same program, each on its own slots, and
``torch.distributed`` carries the exchanges and sums between them over
the group's process subgroup (``sv_process_groups``; NCCL for CUDA
slots, gloo for CPU ones). The clients axis meets in ``fed/round.py``.

``devices=`` always lists THIS process's slots. With a process group of
more than one rank, ``global_slots`` gathers every rank's list once
(one ``all_gather`` of host and device index), so every process builds
the same mesh, and refuses two ranks on one GPU. Under a multi-rank
NCCL group a process's own slots default to the GPU it is bound to
(``distributed_init`` binds it), as a reference process's local devices
are its own chips.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from qfedx_tpu_torch.utils import pins

class Slot(NamedTuple):
    """One mesh position: the ``torch.device`` it runs on, the rank of
    the process that owns it, its node (``rank // local_world_size``,
    where JAX has ``slice_index``) and its global enumeration ``id``."""

    device: torch.device
    rank: int = 0
    node_index: int = 0
    id: int = 0


def process_index() -> int:
    """``torch.distributed.get_rank()`` while a process group is up, else
    0."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return int(dist.get_rank())
    return 0


def process_count() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return int(dist.get_world_size())
    return 1


def _nccl_world() -> bool:
    """Is a process group of more than one rank up on NCCL?"""
    import torch.distributed as dist

    return process_count() > 1 and dist.get_backend() == "nccl"


def local_devices(device=None) -> list[torch.device]:
    """This process's devices of ``device``'s kind (None = the card, which
    raises without CUDA): on CUDA every visible GPU, or under a
    multi-rank NCCL group the one this rank is bound to; the one CPU
    device otherwise."""
    dev = pins.resolve_device(device)
    if dev.type == "cuda":
        if _nccl_world():
            return [torch.device("cuda", torch.cuda.current_device())]
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device(dev.type)]


def _indexed(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def check_distinct_gpus(ranks_slots: list) -> None:
    """``ranks_slots[r]`` = (host, [(device type, index), …]) of rank r:
    raise when two ranks name the same GPU of one host (NCCL takes one
    rank per GPU; a process may repeat its own device)."""
    seen: dict = {}
    for r, (host, devs) in enumerate(ranks_slots):
        for kind, index in devs:
            if kind != "cuda":
                continue
            other = seen.setdefault((host, index), r)
            if other != r:
                raise ValueError(
                    f"ranks {other} and {r} both hold cuda:{index} on host "
                    f"{host!r}: a mesh takes one process per GPU. Bind each "
                    "rank to its own card (parallel.mesh.distributed_init "
                    "binds LOCAL_RANK, else process_id % device_count) or "
                    "list that rank's own devices")


def global_slots(devices=None, local_world_size: int | None = None
                 ) -> list[Slot]:
    """Every process's slots, rank-major: each rank's ``devices``
    (default ``local_devices()``), gathered from every rank under a
    process group of more than one rank (every rank calls this), on
    node ``rank // local_world_size`` (default: every process on one
    node)."""
    local = [_indexed(d) for d in
             (local_devices() if devices is None else devices)]
    world = process_count()
    per_node = world if local_world_size is None else int(local_world_size)
    per_rank = [local]
    if world > 1:
        import socket

        import torch.distributed as dist

        gathered = [None] * world
        dist.all_gather_object(gathered, (socket.gethostname(), [
            (d.type, d.index) for d in local]))
        check_distinct_gpus(gathered)
        per_rank = [[torch.device(kind) if index is None
                     else torch.device(kind, index) for kind, index in devs]
                    for _, devs in gathered]
    slots = []
    for r, devs in enumerate(per_rank):
        for d in devs:
            slots.append(Slot(d, r, r // per_node, len(slots)))
    return slots


def group_ranks(group) -> tuple:
    """The ranks that own ``group``'s slots, ascending."""
    return tuple(sorted({s.rank for s in group}))


def group_lead(group) -> int:
    """The group's lead rank: its lowest. It alone enters the group's
    results into a sum over the world (``fed/round._aggregate``)."""
    return group_ranks(group)[0]


def is_member(group, rank: int | None = None) -> bool:
    """Does ``rank`` (default this process) own a slot of ``group``?"""
    me = process_index() if rank is None else rank
    return any(s.rank == me for s in group)


def home_slot(group, rank: int | None = None):
    """``rank``'s (default this process's) first slot of ``group``."""
    me = process_index() if rank is None else rank
    return next(s for s in group if s.rank == me)


# One torch.distributed subgroup per rank set of the sv groups that span
# processes, created under the world group stored beside them.
_SUBGROUPS: dict = {}


def sv_process_groups(groups) -> None:
    """Create, once per process group, the subgroup of every group in
    ``groups`` whose slots span processes. ``new_group`` is a collective
    of the WHOLE world: every rank calls this with the same groups in
    the same order, members or not (the mesh round, ``host_apply`` and
    ``make_sharded_forward`` do, as they are built)."""
    import torch.distributed as dist

    if process_count() == 1:
        return
    if _SUBGROUPS.get("world") is not dist.group.WORLD:
        _SUBGROUPS.clear()
        _SUBGROUPS["world"] = dist.group.WORLD
    for g in groups:
        ranks = group_ranks(g)
        if len(ranks) > 1 and ranks not in _SUBGROUPS:
            _SUBGROUPS[ranks] = dist.new_group(list(ranks))


def process_subgroup(group):
    """The subgroup of ``group``'s ranks (None when one process owns the
    whole group). Built by ``sv_process_groups`` beforehand: a member
    alone cannot create it."""
    import torch.distributed as dist

    ranks = group_ranks(group)
    if len(ranks) == 1:
        return None
    if (_SUBGROUPS.get("world") is not dist.group.WORLD
            or ranks not in _SUBGROUPS):
        raise RuntimeError(
            f"no process subgroup for ranks {ranks}: every rank calls "
            "parallel.mesh.sv_process_groups(mesh.sv_groups()) first")
    return _SUBGROUPS[ranks]


def check_backend(t: torch.Tensor, group=None) -> None:
    """A CUDA tensor never goes through gloo, a CPU tensor never through
    NCCL: no quiet staging through the host."""
    import torch.distributed as dist

    backend = dist.get_backend(group)
    if t.is_cuda and backend == "gloo":
        raise RuntimeError(
            "a CUDA tensor never goes through gloo: join the process "
            "group with the NCCL backend (parallel.mesh.distributed_init "
            "picks it for CUDA slots)")
    if not t.is_cuda and backend == "nccl":
        raise RuntimeError(
            "a CPU tensor never goes through NCCL: a mesh of CPU slots "
            "joins the process group with gloo (parallel.mesh."
            "distributed_init(devices=...) picks it for CPU slots)")


class Mesh:
    """Slots on named axes: ``devices`` is the slot array (one axis per
    name), ``shape`` maps each axis name to its size, as a JAX mesh's
    does. Only ``Slot`` entries run; any other object (the fake devices
    of the arrangement tests) only shapes."""

    def __init__(self, devices, axis_names=("clients", "sv")):
        arr = np.asarray(devices, dtype=object)
        if arr.ndim != len(axis_names):
            raise ValueError(f"a {arr.ndim}-D slot array for axes "
                             f"{tuple(axis_names)}")
        self.devices = arr
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def client_groups(self, axis: str = "clients") -> list[tuple]:
        """One tuple per position along the clients ``axis``: the slots
        there, its sv group (a 1-D mesh's groups are single slots)."""
        arr = np.moveaxis(self.devices, self.axis_names.index(axis), 0)
        return [tuple(row) for row in arr.reshape(arr.shape[0], -1)]

    def sv_groups(self, axis: str = "sv") -> list[tuple]:
        """The runs of slots along the sv ``axis``, one per position of
        the other axes."""
        arr = np.moveaxis(self.devices, self.axis_names.index(axis), -1)
        return [tuple(row) for row in arr.reshape(-1, arr.shape[-1])]

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


def distributed_init(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    devices=None,
) -> None:
    """Join the process group: ``torch.distributed.init_process_group``
    at ``coordinator_address`` (``host:port`` or ``tcp://host:port``;
    None: the ``env://`` variables) with ``num_processes`` ranks, this
    one ``process_id``. The backend follows the slots' devices
    (``devices``, this process's slots; default ``local_devices()``, the
    card's, which raises without CUDA): NCCL for CUDA slots, gloo for
    CPU ones (``devices=["cpu"]``). Under NCCL the rank is bound to its
    GPU before the group starts (``torch.cuda.set_device``): the one
    indexed GPU ``devices`` names, else ``LOCAL_RANK`` (torchrun's),
    else ``process_id % device_count``. A repeat call is a no-op, so
    library code may call it defensively."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    if devices is None:
        devices = local_devices()
    types = {torch.device(d).type for d in devices}
    if len(types) != 1 or not types <= {"cuda", "cpu"}:
        raise ValueError(f"slots of one kind, CUDA or CPU; got {types}")
    backend = "nccl" if types == {"cuda"} else "gloo"
    if backend == "nccl" and torch.cuda.device_count():
        torch.cuda.set_device(_bound_gpu(devices, process_id))
    init = coordinator_address
    if init is not None and "://" not in init:
        init = f"tcp://{init}"
    if init is None:
        init = "env://"
    dist.init_process_group(
        backend=backend, init_method=init,
        world_size=-1 if num_processes is None else int(num_processes),
        rank=-1 if process_id is None else int(process_id),
    )


def _bound_gpu(devices, process_id: int | None) -> int:
    named = {torch.device(d).index for d in devices}
    if len(named) == 1 and None not in named:
        return named.pop()
    local = pins.str_pin("LOCAL_RANK")
    if local is not None:
        return int(local)
    rank = process_id if process_id is not None else int(
        pins.str_pin("RANK", "0"))
    return int(rank) % torch.cuda.device_count()


def fed_mesh(
    sv_size: int = 1,
    clients_axis: str = "clients",
    sv_axis: str = "sv",
    num_client_devices: int | None = None,
    devices=None,
) -> Mesh:
    """(clients, sv) mesh over every process's slots (``devices`` lists
    this process's; default ``local_devices()``). Each sv group is a
    contiguous run of slots, across processes where a process holds
    fewer than ``sv_size`` (its subgroup made here, every rank calling);
    ``num_client_devices`` keeps the first ``num_client_devices ×
    sv_size`` of them."""
    devs = global_slots(devices)
    n = len(devs)
    if num_client_devices is not None:
        need = num_client_devices * sv_size
        if n < need:
            raise ValueError(f"need {need} devices, have {n}")
        devs, n = devs[:need], need
    if n % sv_size != 0:
        raise ValueError(f"{n} devices not divisible by sv_size={sv_size}")
    mesh = Mesh(_slot_array(devs, (n // sv_size, sv_size)),
                (clients_axis, sv_axis))
    sv_process_groups(mesh.sv_groups(sv_axis))
    return mesh


def _slot_array(devs: list, shape: tuple) -> np.ndarray:
    arr = np.empty(len(devs), dtype=object)
    for i, d in enumerate(devs):
        arr[i] = d
    return arr.reshape(shape)


def hybrid_device_array(devs, sv_size: int) -> np.ndarray:
    """(clients, sv) slot array with every sv group inside one node:
    group by ``node_index`` (absent ⇒ 0), order nodes by index, arrange
    each node's slots in id order into (groups, sv) runs, and stack the
    groups of all nodes along the clients axis. Nodes must be
    equal-sized and divisible by ``sv_size``."""
    nodes: dict[int, list] = {}
    for d in devs:
        nodes.setdefault(getattr(d, "node_index", 0), []).append(d)
    sizes = {len(v) for v in nodes.values()}
    if len(sizes) > 1:
        raise ValueError(f"unequal slice sizes {sorted(sizes)}; cannot mesh")
    per_node = sizes.pop()
    if per_node % sv_size != 0:
        raise ValueError(
            f"sv groups must fit within a slice: {per_node} chips/slice, "
            f"sv_size={sv_size}"
        )

    def arrange(node_devs: list) -> np.ndarray:
        ordered = sorted(node_devs, key=lambda d: d.id)
        return _slot_array(ordered, (per_node // sv_size, sv_size))

    return np.concatenate([arrange(nodes[s]) for s in sorted(nodes)], axis=0)


def hybrid_fed_mesh(
    sv_size: int = 1,
    clients_axis: str = "clients",
    sv_axis: str = "sv",
    devices=None,
    local_world_size: int | None = None,
) -> Mesh:
    """Node-aware (clients, sv) mesh (``local_world_size`` processes a
    node, default all on one): on one node exactly ``fed_mesh``; across
    nodes the clients axis crosses them and the sv axis never does
    (``hybrid_device_array``)."""
    devs = global_slots(devices, local_world_size)
    if len({getattr(d, "node_index", 0) for d in devs}) <= 1:
        return fed_mesh(sv_size, clients_axis, sv_axis, devices=devices)
    mesh = Mesh(hybrid_device_array(devs, sv_size), (clients_axis, sv_axis))
    sv_process_groups(mesh.sv_groups(sv_axis))
    return mesh
