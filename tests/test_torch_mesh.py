"""The port's meshes of slots (``qfedx_tpu_torch/parallel/mesh.py``) held
against the reference's ``parallel/mesh.py``: the single-process paths
on eight CPU slots (the counterpart of the reference's virtual 8-device
CPU mesh), the multi-node arrangement policy with fake devices tagged
by node (the reference's by slice), each arrangement and error the
reference's."""

from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from qfedx_tpu.parallel import mesh as rmesh
from qfedx_tpu_torch.parallel.mesh import (
    Slot,
    fed_mesh,
    hybrid_device_array,
    hybrid_fed_mesh,
)

SLOTS = ["cpu"] * 8


def fake_devices(num_slices, per_slice, tag="node_index"):
    """Fake devices carrying a node (the port) or slice (the reference)
    tag, interleaved deterministically: the policy must not rely on the
    input order."""
    devs = [
        SimpleNamespace(id=s * per_slice + i, platform="tpu", **{tag: s})
        for s in range(num_slices)
        for i in range(per_slice)
    ]
    rng = np.random.default_rng(0)
    return [devs[i] for i in rng.permutation(len(devs))]


def _ids(arr):
    return [[d.id for d in row] for row in arr]


def test_fed_mesh_shapes():
    for sv in (1, 4):
        m = fed_mesh(sv_size=sv, devices=SLOTS)
        assert m.shape == dict(rmesh.fed_mesh(sv_size=sv).shape)
    m = fed_mesh(sv_size=4, devices=SLOTS)
    assert m.shape == {"clients": 2, "sv": 4}
    # sv groups are contiguous slot runs, in the reference's id order.
    assert _ids(m.devices) == _ids(np.array(
        rmesh.fed_mesh(sv_size=4).devices))
    assert all(isinstance(s, Slot) and s.device == torch.device("cpu")
               and s.rank == 0 for s in m.devices.reshape(-1))


def test_fed_mesh_divisibility():
    with pytest.raises(ValueError, match="divisible") as got:
        fed_mesh(sv_size=3, devices=SLOTS)
    with pytest.raises(ValueError) as want:
        rmesh.fed_mesh(sv_size=3)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="need 16 devices") as got:
        fed_mesh(sv_size=4, num_client_devices=4, devices=SLOTS)
    with pytest.raises(ValueError) as want:
        rmesh.fed_mesh(sv_size=4, num_client_devices=4)
    assert str(got.value) == str(want.value)


def test_hybrid_falls_back_on_single_slice():
    m = hybrid_fed_mesh(sv_size=2, devices=SLOTS)
    assert m.shape == {"clients": 4, "sv": 2}
    assert m.shape == dict(rmesh.hybrid_fed_mesh(sv_size=2).shape)


def test_hybrid_array_keeps_sv_groups_within_a_slice():
    """Every sv group sits inside one node (the sv axis exchanges half a
    state per gate); the clients axis spans the nodes, in node order —
    the reference's arrangement of the same fakes by slice."""
    arr = hybrid_device_array(fake_devices(4, 8), sv_size=4)
    want = rmesh.hybrid_device_array(fake_devices(4, 8, "slice_index"),
                                     sv_size=4)
    assert arr.shape == want.shape == (8, 4)
    assert _ids(arr) == _ids(want)
    for row in arr:
        assert len({d.node_index for d in row}) == 1
    assert [row[0].node_index for row in arr] == [0, 0, 1, 1, 2, 2, 3, 3]
    for row in arr:
        ids = [d.id for d in row]
        assert ids == list(range(min(ids), min(ids) + 4))


def test_hybrid_array_validates_fit_and_balance():
    cases = [(fake_devices(2, 4), 8, "fit within a slice"),
             (fake_devices(2, 4)[:-1], 2, "unequal slice")]
    for devs, sv, match in cases:
        with pytest.raises(ValueError, match=match) as got:
            hybrid_device_array(devs, sv_size=sv)
        ref_devs = [SimpleNamespace(id=d.id, platform="tpu",
                                    slice_index=d.node_index) for d in devs]
        with pytest.raises(ValueError) as want:
            rmesh.hybrid_device_array(ref_devs, sv_size=sv)
        assert str(got.value) == str(want.value)


def test_hybrid_fed_mesh_multi_slice_sv1_shape():
    """sv_size = 1 across nodes: pure client parallelism, one column."""
    arr = hybrid_device_array(fake_devices(2, 4), sv_size=1)
    assert arr.shape == (8, 1)
    assert [d.node_index for d in arr[:, 0]] == [0, 0, 0, 0, 1, 1, 1, 1]
    assert _ids(arr) == _ids(rmesh.hybrid_device_array(
        fake_devices(2, 4, "slice_index"), sv_size=1))


def test_reference_mesh_has_eight_devices():
    """The comparisons above stand on the reference's virtual 8-device
    CPU mesh (tests/conftest.py)."""
    assert len(jax.devices()) == 8


@pytest.mark.parametrize("devices,backend", [
    (["cpu"], "gloo"),
    ([torch.device("cuda", 0), torch.device("cuda", 1)], "nccl"),
])
def test_distributed_init_backend_follows_the_slots(monkeypatch, devices,
                                                     backend):
    """NCCL for CUDA slots, gloo for CPU ones, whatever the host has;
    slots of both kinds raise."""
    import torch.distributed as dist

    from qfedx_tpu_torch.parallel.mesh import distributed_init

    seen = {}
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda **kw: seen.update(kw))
    distributed_init("localhost:1234", 2, 1, devices=devices)
    assert seen == dict(backend=backend, init_method="tcp://localhost:1234",
                        world_size=2, rank=1)
    with pytest.raises(ValueError, match="one kind"):
        distributed_init("localhost:1234", 2, 1,
                         devices=["cpu", torch.device("cuda", 0)])


@pytest.mark.parametrize("backend", ["gloo", "nccl"])
def test_collectives_refuse_the_wrong_backend(monkeypatch, backend):
    """A CPU tensor never goes through NCCL; under gloo it does."""
    import torch.distributed as dist

    from qfedx_tpu_torch.fed.round import _collective_ok

    monkeypatch.setattr(dist, "get_backend", lambda *a: backend)
    if backend == "nccl":
        with pytest.raises(RuntimeError, match="never goes through NCCL"):
            _collective_ok(torch.zeros(2))
    else:
        _collective_ok(torch.zeros(2))
