"""The port's two-process round: a worker and the scenarios it runs.

Run as ``python tests/_torch_distributed_worker.py <host:port> <nproc>
<pid> <out_dir>``: the process joins a gloo process group through
``parallel.mesh.distributed_init`` (one CPU slot per process, so the
client axis crosses the process boundary), runs every mode of
``MODES`` in turn over the global client mesh, and rank 0 writes each
mode's θ and stats to ``<out_dir>/<mode>.npz``; under ``trace`` every
process writes its own trace shard to ``<out_dir>/trace/``. The parent
(tests/test_torch_distributed.py) runs the same ``run_mode`` in one
process over two CPU slots and compares.

The modes mirror the reference's worker (tests/_distributed_worker.py):

- ``round``: the flat ``make_fed_round`` (2 clients, Adam);
- ``hier``: a 4-client cohort in two waves of ``make_fed_round_partial``
  (one client per process per wave) under ring masks, accumulated and
  applied, so cross-wave mask cancellation crosses processes;
- ``dropout``: ``hier`` with the ``distributed.peer`` fault site: every
  process asks ``FaultPlan.dead_peers`` (deterministic, no
  communication) and folds the firing peer's wave-0 client into the
  survivor mask;
- ``byzantine``: ``hier`` with a ``scale:1000`` attacker on process 1
  and the ``clip_mean`` defense;
- ``trace``: ``round`` under QFEDX_TRACE, each process's registry a
  shard;
- ``stale``: QFEDX_STALE (per-wave pair graphs), wave 1 a round late
  through ``make_apply_partials(ages=…)``;
- ``trimmed`` (the port's own): the flat round under trimmed_mean, two
  clients per process, so the combine reads deltas gathered across the
  processes;
- ``trainer`` (the port's own): ``run.trainer.train_federated`` with no
  mesh given, so its default mesh spans both processes' slots (two
  client slots), 2 SGD rounds with evaluation; every rank writes its θ
  (``trainer.<rank>.npz``), and the parent compares both with the
  one-process run's default one-slot mesh.
"""

import os
import sys

MODES = ("round", "hier", "dropout", "byzantine", "trace", "stale",
         "trimmed", "trainer")


def _scenario(mode):
    import numpy as np

    from qfedx_tpu_torch.fed.config import FedConfig

    if mode in ("round", "trace"):
        clients, samples, n = 2, 8, 3
        cfg = FedConfig(local_epochs=2, batch_size=4, learning_rate=0.1,
                        optimizer="adam")
    elif mode == "trainer":
        clients, samples, n = 4, 8, 3
        cfg = FedConfig(local_epochs=1, batch_size=4, learning_rate=0.1,
                        momentum=0.9, optimizer="sgd")
    elif mode == "trimmed":
        clients, samples, n = 4, 8, 3
        cfg = FedConfig(local_epochs=2, batch_size=4, learning_rate=0.1,
                        optimizer="sgd", aggregator="trimmed_mean",
                        trim_fraction=0.25)
    else:
        clients, samples, n = 4, 8, 3
        extra = (dict(aggregator="clip_mean", clip_bound=0.5)
                 if mode == "byzantine" else {})
        cfg = FedConfig(local_epochs=2, batch_size=4, learning_rate=0.1,
                        optimizer="sgd", secure_agg=True,
                        secure_agg_mode="ring", **extra)
    rng = np.random.default_rng(0)
    cx = rng.uniform(0, 1, (clients, samples, n)).astype(np.float32)
    cy = rng.integers(0, 2, (clients, samples)).astype(np.int64)
    cm = np.ones((clients, samples), dtype=np.float32)
    return cfg, n, cx, cy, cm


def run_mode(mode, mesh, num_peers=2):
    """One scenario over ``mesh`` (one client slot per peer) → θ leaves
    and the round's stats as numpy arrays."""
    import numpy as np
    import torch

    from qfedx_tpu_torch import obs
    from qfedx_tpu_torch.fed.round import (
        RoundDraws,
        make_accumulate_partial,
        make_apply_partial,
        make_apply_partials,
        make_fed_round,
        make_fed_round_partial,
        stack_partials,
    )
    from qfedx_tpu_torch.models.vqc import make_vqc_classifier
    from qfedx_tpu_torch.utils import trees
    from qfedx_tpu_torch.utils.faults import FaultPlan

    cfg, n, cx, cy, cm = _scenario(mode)
    clients, samples = cx.shape[:2]
    model = make_vqc_classifier(n, 2, 2, device="cpu")
    params = model.init(0)
    perms = torch.stack([torch.stack([
        torch.randperm(samples,
                       generator=torch.Generator().manual_seed(10 * c + e))
        for e in range(cfg.local_epochs)]) for c in range(clients)])
    data = [torch.as_tensor(a) for a in (cx, cy, cm)]
    draws = RoundDraws(42, 0)
    if mode == "trainer":
        from qfedx_tpu_torch.run.trainer import train_federated

        rng = np.random.default_rng(1)
        tx = rng.uniform(0, 1, (16, n)).astype(np.float32)
        ty = rng.integers(0, 2, 16)
        res = train_federated(model, cfg, cx, cy, cm, tx, ty, num_rounds=2,
                              seed=3, params=params)
        out = {f"theta_{i}": t.detach().numpy()
               for i, t in enumerate(trees.tree_leaves(res.params))}
        out["losses"] = np.asarray(res.losses)
        out["accuracies"] = np.asarray(res.accuracies)
        return out
    if mode in ("round", "trace", "trimmed"):
        rf = make_fed_round(model, cfg, clients, mesh=mesh)
        with obs.span("round.dispatch", round=1):
            new, stats = rf(params, *data, perms=perms, draws=draws)
        with obs.span("round.fetch", round=1):
            float(stats.mean_loss)
    else:
        survivors = byz = None
        if mode == "dropout":
            plan = FaultPlan(seed=0, rules=[{
                "site": "distributed.peer", "rounds": [0], "waves": [1]}])
            survivors = np.ones(clients, np.float32)
            for peer in plan.dead_peers(0, num_peers):
                survivors[peer] = 0.0  # the peer's wave-0 client dies
        if mode == "byzantine":
            plan = FaultPlan(seed=0, rules=[{
                "site": "client.byzantine", "kind": "scale:1000",
                "clients": [1]}])
            byz = plan.byzantine_attack(0, np.arange(clients))
        wave = num_peers  # one client per process per wave
        pf = make_fed_round_partial(model, cfg, wave, clients, mesh=mesh)
        parts = []
        for w in range(clients // wave):
            sl = slice(w * wave, (w + 1) * wave)
            parts.append(pf(params, *(d[sl] for d in data), w * wave,
                            perms=perms[sl], survivors=survivors,
                            byzantine=byz, sa_seed=1234, draws=draws))
        if mode == "stale":
            new, stats = make_apply_partials(cfg, clients)(
                params, stack_partials(parts),
                ages=torch.tensor([0.0, 1.0]))
        else:
            acc = parts[0]
            for p in parts[1:]:
                acc = make_accumulate_partial()(acc, p)
            new, stats = make_apply_partial()(params, acc)
    out = {f"theta_{i}": t.detach().numpy()
           for i, t in enumerate(trees.tree_leaves(new))}
    for f in stats._fields:
        out[f] = np.asarray(float(getattr(stats, f)))
    return out


def main() -> None:
    addr, nproc, pid, out_dir = sys.argv[1:5]
    import numpy as np
    import torch

    torch.set_num_threads(1)
    from qfedx_tpu_torch.fed.round import client_mesh
    from qfedx_tpu_torch.models.vqc import make_vqc_classifier
    from qfedx_tpu_torch.parallel.mesh import distributed_init
    from qfedx_tpu_torch.run.trainer import default_mesh

    # CPU slots: gloo.
    distributed_init(addr, int(nproc), int(pid), devices=["cpu"])
    distributed_init(addr, int(nproc), int(pid))  # a repeat: a no-op
    import torch.distributed as dist

    from qfedx_tpu_torch import obs

    assert dist.get_backend() == "gloo"
    mesh = client_mesh(devices=["cpu"])
    assert mesh.shape == {"clients": int(nproc)}
    # The trainer's default mesh counts every process's slots.
    model = make_vqc_classifier(3, 1, 2, device="cpu")
    assert default_mesh(model, 4, device="cpu").shape == {
        "clients": int(nproc)}
    for mode in MODES:
        os.environ.pop("QFEDX_STALE", None)
        os.environ.pop("QFEDX_TRACE", None)
        if mode == "stale":
            os.environ["QFEDX_STALE"] = "1"
        if mode == "trace":
            os.environ["QFEDX_TRACE"] = "1"
            obs.reset()
        out = run_mode(mode, mesh, int(nproc))
        if mode == "trace":
            obs.write_trace_shard(os.path.join(out_dir, "trace"))
        if mode == "trainer":
            np.savez(os.path.join(out_dir, f"{mode}.{pid}.npz"), **out)
        elif int(pid) == 0:
            np.savez(os.path.join(out_dir, f"{mode}.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()
    print(f"worker {pid} done", flush=True)


if __name__ == "__main__":
    main()
