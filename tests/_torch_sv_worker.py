"""The port's sv groups across processes: a worker and the cases it runs.

Run as ``python tests/_torch_sv_worker.py <host:port> <nproc> <pid>
<out_dir>``: the process joins a gloo process group through
``parallel.mesh.distributed_init``, runs every case of
``CASES[nproc]`` in turn, and writes each case's results to
``<out_dir>/<case>.<pid>.npz`` (every rank writes: the members of a
group must all hold the same numbers). ``<out_dir>/perms.npy`` holds
the rounds' (C, E, S) shuffles, drawn by the parent from the
reference's round key. The parent (tests/test_torch_sv_processes.py)
runs the same ``run_case`` in one process over the same number of CPU
slots and compares.

A case is a (clients, sv) mesh of ``fed_mesh(sv_size, devices=["cpu"]
* slots)`` over the world's slots:

- ``sv2`` (2 processes × 1 slot, sv 2): a (1, 2) mesh, its one group
  across both processes;
- ``mixed`` (2 processes × 2 slots, sv 4): a (1, 4) mesh whose group
  mixes both transports: global qubit 0 crosses the processes, qubit 1
  stays inside each;
- ``sv2x2`` (4 processes × 1 slot, sv 2): a (2, 2) mesh, both axes
  across processes;
- ``noise`` (4 processes × 1 slot, sv 4): a (1, 4) mesh under
  circuit-level Kraus trajectories.

Each case gives the forward's logits (``host_apply``), one step's
gradient leaf by leaf and a flat SGD round's θ and loss; the noise
case also its branch choices, the others a trimmed_mean round's θ and
the trainer's θ, losses and accuracies on its default mesh
(``default_mesh`` over the world's slots; with no mesh given where a
process holds its one default CPU slot). Under ``nproc`` 2 the worker
also names one GPU from both ranks and records the mesh's refusal.
"""

import os
import sys

N, LAYERS, CLIENTS, SAMPLES, BATCH = 10, 2, 4, 8, 4
CASES = {
    2: {"sv2": (1, 2), "mixed": (2, 4)},
    4: {"sv2x2": (1, 2), "noise": (1, 4)},
}


def case_slots(name: str) -> tuple:
    """(slots a process, sv size) of case ``name``."""
    for cases in CASES.values():
        if name in cases:
            return cases[name]
    raise KeyError(name)


def data():
    """The cases' seeded inputs: clients' data, held-out set, a batch and
    its labels, and the noise case's Gumbel draws."""
    import numpy as np

    rng = np.random.default_rng(18)
    cx = rng.uniform(0, 1, (CLIENTS, SAMPLES, N)).astype(np.float32)
    cy = rng.integers(0, 2, (CLIENTS, SAMPLES)).astype(np.int64)
    cm = np.ones((CLIENTS, SAMPLES), np.float32)
    tx = rng.uniform(0, 1, (16, N)).astype(np.float32)
    ty = rng.integers(0, 2, 16).astype(np.int64)
    gumbel = rng.gumbel(size=(6, LAYERS, 2, N, 4)).astype(np.float32)
    return cx, cy, cm, tx, ty, gumbel


def noise_model():
    from qfedx_tpu_torch.noise.channels import NoiseModel

    return NoiseModel(depolarizing_p=0.05, amp_damping_gamma=0.05,
                      circuit_level=True)


def fed_config(**kw):
    from qfedx_tpu_torch.fed.config import FedConfig

    return FedConfig(local_epochs=1, batch_size=BATCH, learning_rate=0.1,
                     momentum=0.0, optimizer="sgd", **kw)


def run_case(name: str, mesh, perms, trainer_devices=None) -> dict:
    """Case ``name`` over ``mesh`` → numpy arrays by key; the trainer on
    its default mesh over every process's slots (``trainer_devices``
    listing this process's, None: the one CPU slot)."""
    import numpy as np
    import torch

    from qfedx_tpu_torch.fed.round import (
        RoundDraws,
        make_fed_round,
        shard_client_data,
    )
    from qfedx_tpu_torch.models.vqc_sharded import (
        host_apply,
        make_sharded_vqc_classifier,
    )
    from qfedx_tpu_torch.noise.trajectory import record_branches
    from qfedx_tpu_torch.parallel.mesh import is_member
    from qfedx_tpu_torch.parallel.sharded import sv_group
    from qfedx_tpu_torch.run.trainer import default_mesh, train_federated
    from qfedx_tpu_torch.utils import trees

    _, sv = case_slots(name)
    noisy = name == "noise"
    model = make_sharded_vqc_classifier(
        N, sv, LAYERS, 2, init_scale=0.5, device="cpu",
        noise_model=noise_model() if noisy else None)
    params = model.init(5)
    cx, cy, cm, tx, ty, gumbel = data()
    x, y = tx[:6], torch.as_tensor(ty[:6])
    out = {"logits": host_apply(model, mesh)(params, x).numpy()}

    # One step's gradient on this process's group, leaf by leaf.
    group = next(g for g in mesh.sv_groups() if is_member(g))
    leaves = trees.tree_map(lambda p: p.detach().clone().requires_grad_(),
                            params)
    with sv_group(group), record_branches() as log:
        logits = (model.apply_train(leaves, x, {"branch_gumbel": torch.tensor(
            gumbel)}) if noisy else model.apply(leaves, x))
        loss = torch.nn.functional.cross_entropy(logits, y)
        grads = torch.autograd.grad(loss, trees.tree_leaves(leaves))
    keys = [f"{g}.{k}" for g in sorted(params) for k in sorted(params[g])]
    for k, g in zip(keys, grads):
        out[f"grad.{k}"] = g.numpy()
    out["train_logits"] = logits.detach().numpy()
    if noisy:
        out["branches"] = torch.stack(log).numpy()

    data_ = shard_client_data(mesh, cx, cy, cm)
    rounds = [("sgd", fed_config())]
    if not noisy:
        rounds.append(("trimmed", fed_config(aggregator="trimmed_mean",
                                             trim_fraction=0.25)))
    for tag, cfg in rounds:
        new, stats = make_fed_round(model, cfg, CLIENTS, mesh=mesh)(
            params, *data_, perms=perms, draws=RoundDraws(7, 0))
        for k, t in zip(keys, trees.tree_leaves(new)):
            out[f"{tag}.{k}"] = t.detach().numpy()
        for f in stats._fields:  # the counts see a group counted twice
            out[f"{tag}.{f}"] = np.asarray(float(getattr(stats, f)))
    if noisy:
        return out

    res = train_federated(model, fed_config(), cx, cy, cm, tx, ty,
                          num_rounds=2, seed=3, params=params,
                          mesh=None if trainer_devices is None else
                          default_mesh(model, CLIENTS,
                                       devices=trainer_devices))
    for k, t in zip(keys, trees.tree_leaves(res.params)):
        out[f"trainer.{k}"] = t.detach().numpy()
    out["trainer.losses"] = np.asarray(res.losses)
    out["trainer.accuracies"] = np.asarray(res.accuracies)
    return out


def main() -> None:
    addr, nproc, pid, out_dir = sys.argv[1:5]
    import numpy as np
    import torch

    torch.set_num_threads(1)
    from qfedx_tpu_torch.parallel.mesh import distributed_init, fed_mesh

    distributed_init(addr, int(nproc), int(pid), devices=["cpu"])
    import torch.distributed as dist

    perms = torch.as_tensor(np.load(os.path.join(out_dir, "perms.npy")))
    for name, (slots, sv) in CASES[int(nproc)].items():
        mesh = fed_mesh(sv_size=sv, devices=["cpu"] * slots)
        out = run_case(name, mesh, perms,
                       None if slots == 1 else ["cpu"] * slots)
        np.savez(os.path.join(out_dir, f"{name}.{pid}.npz"), **out)
    if int(nproc) == 2:
        # Both ranks name cuda:0 of one host: the mesh refuses.
        try:
            fed_mesh(devices=[torch.device("cuda", 0)])
            said = ""
        except ValueError as e:
            said = str(e)
        with open(os.path.join(out_dir, f"duplicate.{pid}.txt"), "w") as f:
            f.write(said)
    dist.barrier()
    dist.destroy_process_group()
    print(f"worker {pid} done", flush=True)


if __name__ == "__main__":
    main()
