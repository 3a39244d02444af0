"""Meshes of slots, inside one process and across processes.

Counterpart of ``qfedx_tpu/parallel/mesh.py`` (``distributed_init``,
``fed_mesh``, ``hybrid_device_array``, ``hybrid_fed_mesh``), with the
axis policy kept:

- ``sv`` (statevector sharding) exchanges half a state per gate on a
  global qubit, so an sv group stays inside one process, contiguous;
- ``clients`` (federated data parallelism) communicates once per round
  (one all-reduce of |θ| floats), so it may cross processes, outermost.

A ``Mesh`` is a 2-D array ``(clients, sv)`` of ``Slot``s. A slot is a
``torch.device`` plus the rank of the process that owns it, and a device
may repeat: the CPU tests put eight slots on ``"cpu"``, the card's smoke
eight on ``cuda:0``, a multi-GPU host one per GPU. Each process runs
its own slots in lockstep (``parallel/sharded.py``); between processes
only the clients axis crosses, through ``torch.distributed``
(``fed/round.py``). An sv group that would span processes raises
NotImplementedError (ROADMAP Queue 1 item 16, ``Mesh.group_rank``).

``devices=`` always lists THIS process's slots; with a process group up
the global mesh repeats that list once per rank, rank-major, so every
process builds the same mesh with no communication.
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


def local_devices(device=None) -> list[torch.device]:
    """This process's devices of ``device``'s kind (None = the card, which
    raises without CUDA): every visible GPU on CUDA, the one CPU device
    otherwise."""
    dev = pins.resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device(dev.type)]


def global_slots(devices=None, local_world_size: int | None = None
                 ) -> list[Slot]:
    """Every process's slots, rank-major: ``devices`` (default
    ``local_devices()``) once per rank, on node ``rank //
    local_world_size`` (default: every process on one node)."""
    local = local_devices() if devices is None else list(devices)
    world = process_count()
    per_node = world if local_world_size is None else int(local_world_size)
    return [Slot(torch.device(d), r, r // per_node, r * len(local) + i)
            for r in range(world) for i, d in enumerate(local)]


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

    def group_rank(self, group: tuple) -> int:
        """The process that owns ``group``; NotImplementedError when its
        slots belong to more than one."""
        ranks = {s.rank for s in group}
        if len(ranks) != 1:
            raise NotImplementedError(
                "an sv group spans processes; the port keeps every sv group "
                "inside one process (ROADMAP Queue 1 item 16)")
        return ranks.pop()

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
    CPU ones (``devices=["cpu"]``). A repeat call is a no-op, so library
    code may call it defensively."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    if devices is None:
        devices = local_devices()
    types = {torch.device(d).type for d in devices}
    if len(types) != 1 or not types <= {"cuda", "cpu"}:
        raise ValueError(f"slots of one kind, CUDA or CPU; got {types}")
    backend = "nccl" if types == {"cuda"} else "gloo"
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


def fed_mesh(
    sv_size: int = 1,
    clients_axis: str = "clients",
    sv_axis: str = "sv",
    num_client_devices: int | None = None,
    devices=None,
) -> Mesh:
    """(clients, sv) mesh over every process's slots (``devices`` lists
    this process's; default ``local_devices()``). Each sv group is a
    contiguous run of slots; ``num_client_devices`` keeps the first
    ``num_client_devices × sv_size`` of them."""
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
    for group in mesh.client_groups(clients_axis):
        mesh.group_rank(group)
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
    for group in mesh.client_groups(clients_axis):
        mesh.group_rank(group)
    return mesh
