"""Experiment sweep harness: config grid × seeds → mean±std table + plots.

Counterpart of ``qfedx_tpu/run/sweep.py``: the same presets (``quick``,
``roadmap``, ``baseline``; the cells are data, copied as they are), the
same cell → ``ExperimentConfig`` mapping, the same 3→5 seed rule and the
same aggregates and table. Cells run sequentially through the port's
``build_data → build_model → train_federated`` path on ``device`` (None
= the card), so the sweep measures what the CLI runs.

One command: ``python -m qfedx_tpu_torch sweep --preset roadmap --seeds
3``. Writes ``<root>/sweep-<preset>/results.json`` (every cell, every
seed, the aggregates), ``results.md`` (the mean±std table) and the
summary PNGs. matplotlib is imported only by ``_plots``, with Agg
forced; where it is absent ``run_sweep`` raises ``ModuleNotFoundError``
after writing the JSON and the table. A cell with ``sv_size > 1`` (the
baseline preset's ``c5-svqc``) trains the sv-sharded model over the
trainer's default mesh on ``devices`` (``run/trainer.default_mesh``);
with too few slots for one sv group ``run_sweep`` raises that mesh's
ValueError before the first cell trains.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np

from qfedx_tpu_torch.fed.config import DPConfig, FedConfig
from qfedx_tpu_torch.run.config import (
    DataConfig,
    ExperimentConfig,
    ModelConfig,
    build_data,
    build_model,
)

# The cells are the reference's, as data (its comments give the
# measurements behind each cell's budget).
_COMMON = dict(rounds=8, local_epochs=1, batch_size=32, lr=0.1, optimizer="adam")


def _cell(name: str, **kw) -> dict:
    out = dict(_COMMON)
    out.update(kw)
    out["name"] = name
    return out


def preset_cells(preset: str) -> list[dict]:
    """The config grid for a preset. Each cell is a flat dict of knobs."""
    if preset == "quick":  # CI-sized: 2 cells
        return [
            _cell("q4-iid", qubits=4, clients=4, rounds=4),
            _cell("q4-dp", qubits=4, clients=4, rounds=4, dp_sigma=1.0, dp_clip=1.0),
        ]
    if preset == "roadmap":
        cells = []
        bi = {"classes": (0, 1)}
        for q in (2, 4, 8):
            cells.append(
                _cell(f"q{q}-iid", qubits=q, clients=8, rounds=16,
                      local_epochs=2, **bi)
            )
        for d in (1, 2, 3):
            cells.append(
                _cell(f"q4-d{d}", qubits=4, clients=8, layers=d, **bi)
            )
        for alpha in (0.1, 0.3, 1.0):
            cells.append(
                _cell(f"q4-a{alpha}", qubits=4, clients=8,
                      partition="dirichlet", alpha=alpha, **bi)
            )
        for p in (0.1, 0.3, 1.0):
            cells.append(
                _cell(f"q4-p{p}", qubits=4, clients=8, client_fraction=p, **bi)
            )
        for sigma in (0.5, 1.0, 2.0):
            cells.append(
                _cell(f"q4-dp{sigma}", qubits=4, clients=8,
                      dp_sigma=sigma, dp_clip=1.0, **bi)
            )
        for p_noise in (0.05, 0.15, 0.3):
            cells.append(
                _cell(f"q4-noise-dp{p_noise}", qubits=4, clients=8,
                      depolarizing_p=p_noise, noise_placement="circuit",
                      **bi)
            )
        cells.append(
            _cell("q4-noise-damp0.1", qubits=4, clients=8,
                  amp_damping_gamma=0.1, noise_placement="circuit", **bi)
        )
        cells.append(
            _cell("q4-noise-shots128", qubits=4, clients=8, shots=128, **bi)
        )
        cells.append(
            _cell("q4-dpsgd", qubits=4, clients=8, dp_sigma=1.4, dp_clip=1.0,
                  dp_mode="example", batch_size=64, local_epochs=2,
                  lr=0.2, rounds=10, synthetic_train=16384, **bi)
        )
        cells.append(
            _cell("iris-4q", dataset="iris", qubits=4, clients=4,
                  rounds=25, local_epochs=2, **bi)
        )
        cells.append(
            _cell("iris-4q-3c", dataset="iris", qubits=4, clients=4,
                  rounds=25, local_epochs=2, classes=(0, 1, 2))
        )
        for c in (2, 8, 32):
            cells.append(
                _cell(f"q4-c{c}", qubits=4, clients=c, scaling=True,
                      rounds=16, local_epochs=2, **bi)
            )
        return cells
    if preset == "baseline":
        return [
            _cell("c1-4q-2cli", qubits=4, clients=2, classes=(0, 1)),
            _cell("c2-8q-dpsgd", qubits=8, clients=10, partition="dirichlet",
                  alpha=1.0, classes=(0, 1), layers=3, dp_sigma=1.2,
                  dp_clip=1.0, dp_mode="example", lr=0.2, rounds=10,
                  batch_size=64, local_epochs=2, synthetic_train=16384),
            _cell("c3-cnn-fedprox", model="cnn", dataset="cifar10",
                  clients=32, algorithm="fedprox", prox_mu=0.01, rounds=10,
                  lr=0.01),
            _cell("c4-12q-reupload-secagg", qubits=12, clients=64,
                  encoding="reupload", secure_agg=True, rounds=24),
            _cell("c5-svqc", qubits=8, clients=32, sv_size=4, rounds=16,
                  classes=(0, 1), local_epochs=2, lr=0.2),
            _cell("c5-qkernel20", model="qkernel", qubits=20, clients=32,
                  rounds=4),
            _cell("iris-4q", dataset="iris", qubits=4, clients=4,
                  rounds=25, local_epochs=2, classes=(0, 1)),
        ]
    raise ValueError(f"unknown preset {preset!r}")


def _config_from_cell(cell: dict, seed: int) -> ExperimentConfig:
    dp = None
    if cell.get("dp_clip") is not None:
        dp = DPConfig(
            clip_norm=cell["dp_clip"],
            noise_multiplier=cell.get("dp_sigma", 1.0),
            mode=cell.get("dp_mode", "client"),
        )
    return ExperimentConfig(
        data=DataConfig(
            dataset=cell.get("dataset", "mnist"),
            classes=cell.get("classes", (0, 1, 2)),
            features=cell.get("features", "pca"),
            n_features=cell.get("n_features"),
            num_clients=cell.get("clients", 4),
            partition=cell.get("partition", "iid"),
            alpha=cell.get("alpha", 0.5),
            seed=seed,
            synthetic_train=cell.get("synthetic_train", 4096),
            synthetic_noise=cell.get("synthetic_noise", 0.25),
        ),
        model=ModelConfig(
            model=cell.get("model", "vqc"),
            n_qubits=cell.get("qubits", 4),
            n_layers=cell.get("layers", 2),
            encoding=cell.get("encoding", "angle"),
            init_scale=cell.get("init_scale", 0.1),
            sv_size=cell.get("sv_size", 1),
            depolarizing_p=cell.get("depolarizing_p", 0.0),
            amp_damping_gamma=cell.get("amp_damping_gamma", 0.0),
            readout_flip=cell.get("readout_flip", 0.0),
            shots=cell.get("shots"),
            noise_placement=cell.get("noise_placement", "readout"),
            scan_layers=cell.get("scan_layers"),
        ),
        fed=FedConfig(
            local_epochs=cell.get("local_epochs", 1),
            batch_size=cell.get("batch_size", 32),
            learning_rate=cell.get("lr", 0.1),
            optimizer=cell.get("optimizer", "adam"),
            algorithm=cell.get("algorithm", "fedavg"),
            prox_mu=cell.get("prox_mu", 0.0),
            client_fraction=cell.get("client_fraction", 1.0),
            dp=dp,
            secure_agg=cell.get("secure_agg", False),
        ),
        num_rounds=cell.get("rounds", 8),
        eval_every=max(1, cell.get("rounds", 8) // 2),
        seed=seed,
    )


def _run_cell(cell: dict, seed: int, device=None, devices=None) -> dict:
    """One (cell, seed) training run on ``device``, over the default mesh
    on ``devices`` → its summary metrics."""
    from qfedx_tpu_torch.run.trainer import default_mesh, train_federated

    cfg = _config_from_cell(cell, seed)
    data = build_data(cfg)
    model = build_model(cfg, data["num_classes"], device=device)
    mesh = default_mesh(model, data["cx"].shape[0], devices=devices,
                        device=device)
    test_x, test_y = data["test"]
    t0 = time.perf_counter()
    res = train_federated(
        model,
        cfg.fed,
        data["cx"],
        data["cy"],
        data["cmask"],
        test_x,
        test_y,
        num_rounds=cfg.num_rounds,
        seed=seed,
        eval_every=cfg.eval_every,
        rounds_per_call=cfg.rounds_per_call,
        pipeline_depth=cfg.pipeline_depth,
        mesh=mesh,
    )
    wall = time.perf_counter() - t0
    final = res.evaluate(res.params, test_x, test_y)
    return {
        "accuracy": final["accuracy"],
        "auc": final.get("auc"),
        "epsilon": res.epsilons[-1] if res.epsilons else None,
        "wall_s": wall,
        "round_s": float(np.mean(res.round_times_s)) if res.round_times_s else None,
        "comm_mb_per_round": res.comm_mb_per_round,
    }


def _aggregate(runs: list[dict]) -> dict:
    """Per-cell mean±std over seeds, plus accuracy_min — the worst seed. Means hide failing seeds (the
    r03 tables read 0.753±0.213 for a cell where 1-in-3 runs learned
    nothing); the min column makes that impossible."""
    out = {}
    for key in ("accuracy", "auc", "epsilon", "wall_s", "round_s"):
        vals = [r[key] for r in runs if r.get(key) is not None]
        if vals:
            out[f"{key}_mean"] = float(np.mean(vals))
            out[f"{key}_std"] = float(np.std(vals))
    accs = [r["accuracy"] for r in runs if r.get("accuracy") is not None]
    if accs:
        out["accuracy_min"] = float(np.min(accs))
    out["comm_mb_per_round"] = runs[0]["comm_mb_per_round"]
    out["n_seeds"] = len(runs)
    return out


def _env_tag(device=None) -> str:
    """The measurement environment for the results table: the device
    type and count the cells ran on (``cuda1``, ``cpu1``)."""
    import torch

    from qfedx_tpu_torch.utils.pins import resolve_device

    try:
        dev = resolve_device(device)
        count = torch.cuda.device_count() if dev.type == "cuda" else 1
        return f"{dev.type}{count}"
    except Exception:  # noqa: BLE001
        return "unknown"


def _markdown_table(cells: list[dict], aggs: dict, device=None) -> str:
    lines = [
        f"Environment: `{_env_tag(device)}` (timings are this "
        "environment's).",
        "",
        "| cell | accuracy | min(seed) | AUC | ε | seeds | round s | MB/round |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for c in cells:
        a = aggs[c["name"]]
        fmt = lambda k: (
            f"{a[f'{k}_mean']:.3f}±{a[f'{k}_std']:.3f}" if f"{k}_mean" in a else "—"
        )
        amin = f"{a['accuracy_min']:.3f}" if "accuracy_min" in a else "—"
        lines.append(
            f"| {c['name']} | {fmt('accuracy')} | {amin} | {fmt('auc')} "
            f"| {fmt('epsilon')} | {a['n_seeds']} | {fmt('round_s')} "
            f"| {a['comm_mb_per_round']:.4f} |"
        )
    return "\n".join(lines) + "\n"


def _plots(out_dir: Path, cells: list[dict], aggs: dict) -> None:
    """The summary plots, from whatever cells the preset has."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    def errbar(ax, xs, names, key="accuracy"):
        ys = [aggs[n][f"{key}_mean"] for n in names]
        es = [aggs[n][f"{key}_std"] for n in names]
        ax.errorbar(xs, ys, yerr=es, marker="o", capsize=3)

    # accuracy vs ε — DP cells only
    dp_cells = [c for c in cells if aggs[c["name"]].get("epsilon_mean") is not None]
    if dp_cells:
        fig, ax = plt.subplots(figsize=(5, 4))
        errbar(ax, [aggs[c["name"]]["epsilon_mean"] for c in dp_cells],
               [c["name"] for c in dp_cells])
        ax.set_xlabel("ε (δ=1e-5)")
        ax.set_ylabel("test accuracy")
        ax.set_title("privacy/utility")
        fig.savefig(out_dir / "accuracy_vs_epsilon.png", dpi=120,
                    bbox_inches="tight")
        plt.close(fig)

    # accuracy vs qubits — vqc cells grouped by qubit count
    q_cells = {}
    for c in cells:
        if c.get("model", "vqc") == "vqc" and not c.get("dp_clip"):
            q_cells.setdefault(c.get("qubits", 4), c["name"])
    if len(q_cells) >= 2:
        fig, ax = plt.subplots(figsize=(5, 4))
        qs = sorted(q_cells)
        errbar(ax, qs, [q_cells[q] for q in qs])
        ax.set_xlabel("qubits")
        ax.set_ylabel("test accuracy")
        ax.set_title("accuracy vs circuit width")
        fig.savefig(out_dir / "accuracy_vs_qubits.png", dpi=120,
                    bbox_inches="tight")
        plt.close(fig)

    # accuracy vs noise strength:
    # the circuit-level depolarizing axis, with q4-d2 (identical knobs,
    # zero noise) as the p=0 anchor when present.
    noise_cells = sorted(
        (c["depolarizing_p"], c["name"])
        for c in cells
        if c.get("noise_placement") == "circuit" and c.get("depolarizing_p")
    )
    if len(noise_cells) >= 2:
        xs = [p for p, _ in noise_cells]
        names = [n for _, n in noise_cells]
        if any(c["name"] == "q4-d2" for c in cells):
            xs, names = [0.0] + xs, ["q4-d2"] + names
        fig, ax = plt.subplots(figsize=(5, 4))
        errbar(ax, xs, names)
        ax.set_xlabel("depolarizing p (circuit-level, per layer)")
        ax.set_ylabel("test accuracy")
        ax.set_title("noise degrades accuracy")
        fig.savefig(out_dir / "accuracy_vs_noise.png", dpi=120,
                    bbox_inches="tight")
        plt.close(fig)

    # speedup vs clients: per-round time scaling, drawn ONLY from cells
    # explicitly marked scaling=True (same model/config, cohort size the
    # single varying knob) — mixing heterogeneous cells here would publish
    # apples-to-oranges throughput ratios as a scaling curve.
    cli_cells = sorted(
        ((c.get("clients", 4), c["name"]) for c in cells
         if c.get("scaling") and aggs[c["name"]].get("round_s_mean")),
    )
    if len(cli_cells) >= 2:
        base_c, base_name = cli_cells[0]
        base = aggs[base_name]["round_s_mean"] / base_c  # s per client-round
        fig, ax = plt.subplots(figsize=(5, 4))
        xs = [c for c, _ in cli_cells]
        ys = [base * c / aggs[n]["round_s_mean"] for c, n in cli_cells]
        ax.plot(xs, ys, marker="o", label="measured")
        ax.plot(xs, [x / xs[0] for x in xs], "--", label="ideal")
        ax.set_xlabel("clients")
        ax.set_ylabel("client-round throughput speedup")
        ax.set_title("scaling with cohort size")
        ax.legend()
        fig.savefig(out_dir / "speedup_vs_clients.png", dpi=120,
                    bbox_inches="tight")
        plt.close(fig)


def check_cells(cells: list[dict], device=None, devices=None) -> None:
    """Refuse a grid before any cell trains where a cell with ``sv_size >
    1`` finds fewer slots than one sv group: the trainer's mesh
    ValueError, raised up front."""
    from qfedx_tpu_torch.parallel.mesh import local_devices

    sharded = [c for c in cells if c.get("sv_size", 1) > 1]
    if not sharded:
        return
    n = len(local_devices(device) if devices is None else list(devices))
    for c in sharded:
        if n < c["sv_size"]:
            raise ValueError(
                f"model needs sv groups of {c['sv_size']} devices; "
                f"only {n} available (sweep cell {c['name']!r})"
            )


def run_sweep(
    preset: str = "quick",
    seeds: int = 3,
    root: str = "runs",
    cells: list[dict] | None = None,
    device=None,
    devices=None,
) -> dict:
    """Run the grid on ``device`` (None = the card), each cell over the
    trainer's default mesh on ``devices`` (None:
    ``parallel.mesh.local_devices(device)``); returns {"cells": ...,
    "aggregates": ..., "dir": ...}. Under a process group only the
    primary process prints and writes the results and plots."""
    from qfedx_tpu_torch.utils.host import is_primary

    say = print if is_primary() else (lambda *a, **k: None)
    cells = cells if cells is not None else preset_cells(preset)
    check_cells(cells, device, devices)
    out_dir = Path(root) / f"sweep-{preset}"
    if is_primary():
        out_dir.mkdir(parents=True, exist_ok=True)

    # 3–5 seeds: start at ``seeds``; if the accuracy spread over those is
    # wide (std > 0.1), run ALL the way to 5. The trigger is checked
    # once, after the base seeds — stopping the moment std dips back
    # under the bar would be data-dependent optional stopping.
    max_seeds = max(seeds, 5)
    all_runs: dict[str, list[dict]] = {}
    for ci, cell in enumerate(cells):
        runs = []
        s, target = 0, seeds
        while s < target:
            t0 = time.perf_counter()
            runs.append(_run_cell(cell, seed=42 + s, device=device,
                                  devices=devices))
            say(
                f"[sweep {ci + 1}/{len(cells)}] {cell['name']} seed {s}: "
                f"acc={runs[-1]['accuracy']:.3f} "
                f"({time.perf_counter() - t0:.1f}s)"
            )
            s += 1
            if (
                s == target
                and target < max_seeds
                and float(np.std([r["accuracy"] for r in runs])) > 0.1
            ):
                target = max_seeds
        all_runs[cell["name"]] = runs

    aggs = {name: _aggregate(runs) for name, runs in all_runs.items()}
    result = {
        "preset": preset,
        "env": _env_tag(device),
        "seeds": seeds,
        "cells": [dict(c) for c in cells],
        "runs": all_runs,
        "aggregates": aggs,
    }
    if is_primary():
        (out_dir / "results.json").write_text(json.dumps(result, indent=2))
        (out_dir / "results.md").write_text(
            _markdown_table(cells, aggs, device))
        _plots(out_dir, cells, aggs)
    result["dir"] = str(out_dir)
    say(f"[sweep] wrote {out_dir}/results.json, results.md, plots")
    return result
