"""Command-line entry point: ``python -m qfedx_tpu_torch <subcommand> ...``.

Counterpart of ``qfedx_tpu/run/cli.py``: ``build_parser`` takes the
reference's subcommands and flags, so the same argv parses the same way
and ``config_from_args`` gives the same ``ExperimentConfig``.
``main(argv, device=None, devices=None)`` runs on the card unless a
caller passes ``device="cpu"`` (the tests do); ``devices`` lists the
slots ``train``'s mesh takes (``run/trainer.default_mesh``; default
``parallel.mesh.local_devices()``: every visible GPU, or the one CPU
device), so ``--sv-size 4`` needs four of them — eight slots on one
device (``devices=["cpu"] * 8``) give the reference's virtual 8-device
mesh.

- ``train`` builds the data and the model, trains in a tracked run
  directory (``config.json``, ``metrics.jsonl``, ``summary.json``,
  checkpoints) and prints the summary. Every ``--model``, ``--encoding``,
  federation option of the resident round and noise flag runs; the
  staleness settings go into ``FedConfig`` as in the reference (the
  resident trainer ignores them; the streamed trainer,
  ``run/trainer.train_federated_streamed``, is a library entry).
  ``--trace`` writes ``trace.json`` and the summary's
  ``phase_breakdown``; ``--profile`` (or ``QFEDX_PROFILE``) captures a
  ``torch.profiler`` timeline into ``profile_summary.json``; ``--plots``
  saves the client-sample and class-distribution PNGs (``data/viz``,
  matplotlib needed); ``--tuned PATH`` replays a ``best_config.json``'s
  pins before the config is built (``config.json`` records
  ``tuned_from``).
- ``serve --run-dir`` restores a run's checkpoint and answers a JSONL
  request stream; ``--trace`` writes ``serve_trace.json``; ``--tuned
  [PATH]`` replays the sidecar's pins first (bare: the run directory's
  ``best_config.json``; explicit ``--buckets``/``--deadline-ms`` win).
- ``tune`` sweeps the serving lattice of a run (``tune/offline.py``) and
  writes ``best_config.json``.
- ``inspect <run-dir>`` summarizes a run directory; ``bench history``
  reads the ``BENCH_r*.json`` trajectory (exit 1 on a regression, 2 with
  no files); ``demo`` is the encoder walkthrough (``run/demo.py``);
  ``sweep`` the config grid × seeds harness (``run/sweep.py``).
- ``lint`` runs the static-analysis engine (``analysis/``,
  docs/TORCH_ANALYSIS.md) over the port's tree; exit 1 on a finding the
  baseline does not hold. It is dispatched before any other import and
  touches no device.

Every reference subcommand is ported: ``_UNPORTED`` is empty. Under a
process group only the primary process (``utils/host.is_primary``, rank
0) prints and writes the plots, traces and sweep results.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from qfedx_tpu_torch.fed.config import DPConfig, FedConfig
from qfedx_tpu_torch.run.config import (
    DataConfig,
    ExperimentConfig,
    ModelConfig,
    build_data,
    build_model,
)


# The reference's subcommands the port does not have yet, with the
# ROADMAP Queue 1 item that ports each (none left).
_UNPORTED: dict[str, str] = {}


def _say():
    """``print`` on the primary process (``utils/host.is_primary``: rank
    0 of a process group, or the only process), a no-op on the others."""
    from qfedx_tpu_torch.utils.host import is_primary

    return print if is_primary() else (lambda *a, **k: None)


def _parse_classes(s: str | None):
    if s is None or s == "all":
        return None
    return tuple(int(c) for c in s.split(","))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="qfedx_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("train", help="run federated training")
    # data
    t.add_argument("--dataset", default="mnist",
                   choices=["mnist", "fashion_mnist", "cifar10", "iris"])
    t.add_argument("--raw-folder", default=None,
                   help="folder with IDX/CIFAR files; synthetic fallback if absent")
    t.add_argument("--classes", default="0,1,2",
                   help="comma-separated class subset, or 'all'")
    t.add_argument("--features", default="pca",
                   choices=["image", "downsample", "pool", "pca"])
    t.add_argument("--clients", type=int, default=4)
    t.add_argument("--partition", default="iid", choices=["iid", "dirichlet"])
    t.add_argument("--alpha", type=float, default=0.5)
    # model
    t.add_argument("--model", default="vqc",
                   choices=["vqc", "cnn", "qkernel", "mps"])
    t.add_argument("--qubits", type=int, default=8)
    t.add_argument("--layers", type=int, default=2)
    t.add_argument("--bond-dim", type=int, default=16,
                   help="MPS bond dimension χ (model=mps; the tensor-network "
                        "path for qubit counts past the dense ~20q wall)")
    t.add_argument("--encoding", default="angle",
                   choices=["angle", "amplitude", "reupload"])
    t.add_argument("--landmarks", type=int, default=16)
    t.add_argument("--sv-size", type=int, default=1,
                   help="shard each statevector over this many devices "
                        "(power of two; the >20-qubit regime)")
    t.add_argument("--depolarizing", type=float, default=0.0)
    t.add_argument("--damping", type=float, default=0.0)
    t.add_argument("--readout-flip", type=float, default=0.0)
    t.add_argument("--shots", type=int, default=None)
    t.add_argument("--remat", action="store_true",
                   help="checkpoint each ansatz layer (rematerialization): "
                        "autodiff memory per sample O(layers)*2^n instead of "
                        "O(gates)*2^n - for deep/wide dense circuits")
    t.add_argument("--noise-placement", default="readout",
                   choices=["readout", "circuit"],
                   help="analytic readout maps vs sampled Kraus trajectories in-circuit")
    t.add_argument("--scan-layers", default=None, choices=["on", "off"],
                   help="scan-over-fused-layers: the L structurally-"
                        "identical fused ansatz layers run as ONE scanned "
                        "super-gate body (the scan-body kernel on the "
                        "card). Default follows QFEDX_SCAN_LAYERS (on); the "
                        "choice is recorded in config.json so `serve` "
                        "restores the same route")
    # federated
    t.add_argument("--rounds", type=int, default=30)
    t.add_argument("--local-epochs", type=int, default=5)
    t.add_argument("--batch-size", type=int, default=32)
    t.add_argument("--lr", type=float, default=0.01)
    t.add_argument("--optimizer", default="sgd", choices=["sgd", "adam", "spsa"])
    t.add_argument("--algorithm", default="fedavg", choices=["fedavg", "fedprox"])
    t.add_argument("--prox-mu", type=float, default=0.01)
    t.add_argument("--client-fraction", type=float, default=1.0)
    t.add_argument("--dp-clip", type=float, default=None,
                   help="enable DP with this L2 clip norm")
    t.add_argument("--dp-sigma", type=float, default=1.0)
    t.add_argument("--dp-mode", default="client", choices=["client", "example"],
                   help="client = DP-FedAvg (clip+noise each client update, "
                        "1 accountant step/round); example = DP-SGD "
                        "(per-example clipping inside local steps, "
                        "accountant composes per local step)")
    t.add_argument("--secure-agg", action="store_true")
    t.add_argument("--secure-agg-mode", default="ring", choices=["ring", "pairwise"],
                   help="pair graph: k-successor ring (O(k)/client) or complete (O(C)/client)")
    t.add_argument("--secure-agg-neighbors", type=int, default=1,
                   help="ring hops k; unmasking a client needs its 2k neighbors to collude")
    t.add_argument("--aggregator", default="mean",
                   choices=["mean", "clip_mean", "trimmed_mean", "median"],
                   help="Byzantine-robust aggregation rule (r12, "
                        "docs/ROBUSTNESS.md); mean = defense off, the "
                        "pre-r12 program bit-for-bit")
    t.add_argument("--clip-bound", type=float, default=float("inf"),
                   help="clip_mean L2 norm bound per client update "
                        "(inf compiles no clip ops)")
    t.add_argument("--trim-fraction", type=float, default=0.1,
                   help="trimmed_mean per-end trim fraction (< 0.5)")
    t.add_argument("--staleness-mode", default="constant",
                   choices=["constant", "poly"],
                   help="staleness discount family for buffered straggler "
                        "waves (r13, QFEDX_STALE; streamed rounds): "
                        "constant s(t)=alpha, poly s(t)=(1+t)^-alpha")
    t.add_argument("--staleness-alpha", type=float, default=0.5,
                   help="staleness discount parameter (see "
                        "--staleness-mode)")
    t.add_argument("--staleness-max-age", type=int, default=2,
                   help="rounds a buffered straggler partial may lag "
                        "before being discarded as dropouts")
    # run
    t.add_argument("--eval-every", type=int, default=1)
    t.add_argument("--rounds-per-call", type=int, default=None,
                   help="scan this many rounds inside one device dispatch "
                        "(bit-identical; amortizes host-device latency). "
                        "Evaluation rides INSIDE the scanned program "
                        "(per-round on-device accuracy, no --eval-every "
                        "trade-off) for host-callable models; only "
                        "--checkpoint-every still bounds a chunk. Default "
                        "10 (1 for --sv-size > 1, whose eval is host-side "
                        "and still paces chunks via --eval-every)")
    t.add_argument("--pipeline-depth", type=int, default=None,
                   help="software-pipeline depth of the round loop: issue "
                        "chunk k+1 before draining chunk k's stats so host "
                        "work (metrics/epsilon/JSONL/checkpoint) overlaps "
                        "device compute. 0 = sequential dispatch-drain loop; "
                        "default resolves QFEDX_PIPELINE, then 1. Training "
                        "is bit-identical at any depth")
    t.add_argument("--eval-batches", type=int, default=None,
                   help="cap per-round eval at this many 256-sample batches")
    t.add_argument("--checkpoint-every", type=int, default=10)
    t.add_argument("--seed", type=int, default=42)
    t.add_argument("--run-root", default="runs")
    t.add_argument("--name", default=None)
    t.add_argument("--resume", action="store_true",
                   help="reuse the --name run dir and resume from its latest checkpoint")
    t.add_argument("--plots", action="store_true",
                   help="save client-sample and class-distribution PNGs to "
                        "the run dir (needs matplotlib)")
    t.add_argument("--profile", action="store_true",
                   help="capture a torch.profiler device timeline into "
                        "<run-dir>/profile and parse it into "
                        "profile_summary.json (crash-safe)")
    t.add_argument("--trace", action="store_true",
                   help="record obs spans (QFEDX_TRACE=1): per-round "
                        "phases in metrics.jsonl, phase_breakdown in "
                        "summary.json, trace.json for Perfetto")
    t.add_argument("--tuned", default=None, metavar="PATH",
                   help="restore the pin set from a `tune` best_config.json "
                        "sidecar before building the run config; pins the "
                        "operator already set win")

    v = sub.add_parser(
        "serve",
        help="low-latency batched inference from a trained run's "
             "checkpoint (docs/SERVING.md)",
    )
    v.add_argument("--run-dir", required=True,
                   help="a tracked run directory (config.json + checkpoints/)")
    v.add_argument("--round", type=int, default=None,
                   help="restore this checkpointed round (default: newest "
                        "last-good checkpoint)")
    v.add_argument("--buckets", default=None,
                   help="comma-separated ascending batch buckets compiled "
                        "at warmup (default QFEDX_SERVE_BUCKETS, then 1,8,32)")
    v.add_argument("--deadline-ms", type=float, default=None,
                   help="micro-batcher latency budget: max ms a request "
                        "waits for its bucket to fill (default "
                        "QFEDX_SERVE_DEADLINE_MS, then 5)")
    v.add_argument("--max-queue", type=int, default=None,
                   help="bounded admission queue depth; past it requests "
                        "are shed (default QFEDX_SERVE_QUEUE, then 256)")
    v.add_argument("--input", default="-",
                   help="JSONL request stream ('-' = stdin): one "
                        '{"features": [...]} (or a bare array) per line')
    v.add_argument("--output", default="-",
                   help="JSONL response stream ('-' = stdout), in input order")
    v.add_argument("--trace", action="store_true",
                   help="record serve.* spans (QFEDX_TRACE=1) and write "
                        "serve_trace.json into the run dir")
    v.add_argument("--tuned", nargs="?", const="", default=None,
                   metavar="PATH",
                   help="restore the tuned pin set from a `tune` "
                        "best_config.json sidecar before resolving the "
                        "serve config (bare --tuned reads <run-dir>/"
                        "best_config.json); pins the operator already set "
                        "win, explicit --buckets/--deadline-ms flags "
                        "always win")

    tn = sub.add_parser(
        "tune",
        help="offline auto-tuner: sweep the serve bucket/deadline lattice "
             "against a trained run's checkpoint and write the winner as a "
             "best_config.json sidecar that `serve --tuned` / `train "
             "--tuned` restore through pins",
    )
    tn.add_argument("--run-dir", required=True,
                    help="a tracked run directory (config.json + "
                         "checkpoints/)")
    tn.add_argument("--round", type=int, default=None,
                    help="restore this checkpointed round (default: newest "
                         "last-good checkpoint)")
    tn.add_argument("--slo-ms", type=float, default=None,
                    help="latency SLO the score holds cells to (default: "
                         "the resolved serve SLO)")
    tn.add_argument("--buckets", default=None,
                    help="semicolon-separated bucket SETS, each a comma-"
                         "separated ascending list (e.g. '1,8;1,8,32'); "
                         "default: the resolved serve bucket set only")
    tn.add_argument("--deadlines", default=None,
                    help="comma-separated micro-batcher flush deadlines in "
                         "ms to sweep (e.g. '2.5,5,10'); default: the "
                         "resolved deadline only")
    tn.add_argument("--requests", type=int, default=96,
                    help="offered-load requests per (cell, rate) point")
    tn.add_argument("--out", default=None,
                    help="sidecar path (default <run-dir>/best_config.json)")

    i = sub.add_parser(
        "inspect",
        help="summarize a tracked run directory: metrics.jsonl trajectory "
             "+ ledger totals, alert and tune rows, summary.json, "
             "profile_summary.json, flight.json and best_config.json",
    )
    i.add_argument("run_dir",
                   help="a tracked run directory (metrics.jsonl inside)")

    d = sub.add_parser("demo", help="encoder walkthrough")
    d.add_argument("--dataset", default="mnist",
                   choices=["mnist", "fashion_mnist", "cifar10"])
    d.add_argument("--out", default="runs/demo")

    s = sub.add_parser("sweep",
                       help="config-grid × seeds benchmark harness "
                            "(mean±std table + plots)")
    s.add_argument("--preset", default="roadmap",
                   choices=["quick", "roadmap", "baseline"])
    s.add_argument("--seeds", type=int, default=3)
    s.add_argument("--run-root", default="runs")

    b = sub.add_parser(
        "bench",
        help="bench-trajectory tools over the committed BENCH_r*.json "
             "ledger",
    )
    bsub = b.add_subparsers(dest="bench_cmd", required=True)
    bh = bsub.add_parser(
        "history",
        help="parse the BENCH_r*.json trajectory (numeric sort, "
             "methodology-era tagging, provenance) into per-metric trend "
             "verdicts; exit 1 on a regression",
    )
    bh.add_argument("--dir", default=".",
                    help="directory holding BENCH_r*.json (default: cwd)")
    bh.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable report only (one JSON object)")
    bh.add_argument("--no-gate", action="store_true",
                    help="report but always exit 0 (advisory mode)")

    lnt = sub.add_parser(
        "lint",
        help="AST static analysis: pin discipline, span/lock hygiene, "
             "seeded draws, port isolation, no device fall-back, "
             "doc-taxonomy contracts (docs/TORCH_ANALYSIS.md); exit 1 on "
             "non-baselined findings",
    )
    lnt.add_argument("--json", action="store_true", dest="as_json",
                     help="machine-readable report on stdout (schema v1)")
    lnt.add_argument("--rules", default=None,
                     help="comma-separated rule IDs to run (default: all)")
    lnt.add_argument("--baseline", default=None,
                     help="override the [tool.qfedx_tpu_torch.lint] "
                          "baseline path")
    lnt.add_argument("--update-baseline", action="store_true",
                     help="rewrite the baseline from current findings "
                          "(grandfather them) instead of failing")
    lnt.add_argument("--show-baselined", action="store_true",
                     help="also print baselined findings in text mode")

    # Not ported yet: main() raises for each, whatever its arguments.
    for name, item in _UNPORTED.items():
        sub.add_parser(name, help=f"not ported yet: raises (ROADMAP Queue 1 "
                                  f"item {item})")
    return p


def config_from_args(a: argparse.Namespace) -> ExperimentConfig:
    dp = (
        DPConfig(
            clip_norm=a.dp_clip, noise_multiplier=a.dp_sigma, mode=a.dp_mode
        )
        if a.dp_clip is not None
        else None
    )
    return ExperimentConfig(
        data=DataConfig(
            dataset=a.dataset,
            raw_folder=a.raw_folder,
            classes=_parse_classes(a.classes),
            features=a.features,
            num_clients=a.clients,
            partition=a.partition,
            alpha=a.alpha,
            seed=a.seed,
        ),
        model=ModelConfig(
            model=a.model,
            n_qubits=a.qubits,
            n_layers=a.layers,
            encoding=a.encoding,
            bond_dim=a.bond_dim,
            n_landmarks=a.landmarks,
            sv_size=a.sv_size,
            depolarizing_p=a.depolarizing,
            amp_damping_gamma=a.damping,
            readout_flip=a.readout_flip,
            shots=a.shots,
            noise_placement=a.noise_placement,
            remat=a.remat,
            scan_layers=(
                None if a.scan_layers is None else a.scan_layers == "on"
            ),
        ),
        fed=FedConfig(
            local_epochs=a.local_epochs,
            batch_size=a.batch_size,
            learning_rate=a.lr,
            optimizer=a.optimizer,
            algorithm=a.algorithm,
            prox_mu=a.prox_mu if a.algorithm == "fedprox" else 0.0,
            client_fraction=a.client_fraction,
            dp=dp,
            secure_agg=a.secure_agg,
            secure_agg_mode=a.secure_agg_mode,
            secure_agg_neighbors=a.secure_agg_neighbors,
            aggregator=a.aggregator,
            clip_bound=a.clip_bound,
            trim_fraction=a.trim_fraction,
            staleness_mode=a.staleness_mode,
            staleness_alpha=a.staleness_alpha,
            staleness_max_age=a.staleness_max_age,
        ),
        num_rounds=a.rounds,
        eval_every=a.eval_every,
        # Default deep scan only where in-scan eval applies; sv-sharded
        # models evaluate host-side, where a deep default would just
        # clamp to --eval-every and warn on every plain run.
        rounds_per_call=(
            a.rounds_per_call
            if a.rounds_per_call is not None
            else (1 if a.sv_size > 1 else 10)
        ),
        pipeline_depth=a.pipeline_depth,
        eval_batches=a.eval_batches,
        checkpoint_every=a.checkpoint_every,
        seed=a.seed,
        run_root=a.run_root,
        name=a.name,
        tuned_from=getattr(a, "tuned", None) or None,
    )


def run_train(cfg: ExperimentConfig, resume: bool = False,
              device=None, data: dict | None = None, profile: bool = False,
              trace: bool = False, plots: bool = False,
              devices=None) -> dict:
    """Train ``cfg`` in a tracked run directory on ``device`` (None = the
    card), over the trainer's default mesh on ``devices`` (None:
    ``parallel.mesh.local_devices()``); returns the summary
    ``summary.json`` holds. ``data`` is what
    ``build_data(cfg)`` returns, for a caller that has built it already.
    ``trace`` sets QFEDX_TRACE for the run (the pin is the contract, the
    flag sugar); ``profile`` captures the training under
    ``torch.profiler`` into ``<run-dir>/profile`` (``QFEDX_PROFILE`` can
    redirect or enable it) and parses it, even when training fails;
    ``plots`` saves ``client_samples.png`` and ``class_distribution.png``
    into the run directory."""
    import contextlib

    from qfedx_tpu_torch import obs
    from qfedx_tpu_torch.run.metrics import ExperimentRun
    from qfedx_tpu_torch.run.trainer import default_mesh, train_federated
    from qfedx_tpu_torch.utils import pins
    from qfedx_tpu_torch.utils.host import is_primary

    if trace:
        # Read per call, so this covers the whole run; reset() makes the
        # trace.json window exactly this run.
        pins.set_pin("QFEDX_TRACE", "1")
        obs.reset()
    # Under a process group only rank 0 speaks and writes the plots,
    # the profile summary and the phase trace (the run directory's files
    # are gated inside run/metrics and run/checkpoint).
    say = _say()
    if data is None:
        data = build_data(cfg)
    model = build_model(cfg, data["num_classes"], device=device)
    mesh = default_mesh(model, data["cx"].shape[0], devices=devices,
                        device=device)
    test_x, test_y = data["test"]
    val_x, val_y = data["val"]
    # Per-round evaluation on the validation split; the test set is
    # touched once, at the end.
    have_val = len(val_y) > 0
    eval_x, eval_y = (val_x, val_y) if have_val else (test_x, test_y)

    with ExperimentRun(cfg.run_root, cfg.run_name(), config=cfg,
                       resume=resume) as run:
        say(f"[qfedx_tpu_torch] run dir: {run.dir}")
        if plots and is_primary():
            from qfedx_tpu_torch.data.viz import (
                save_class_distribution,
                save_client_samples,
            )

            tr_x, _ = data["train"]
            save_client_samples(tr_x, data["parts"],
                                run.dir / "client_samples.png")
            save_class_distribution(data["stats"],
                                    run.dir / "class_distribution.png")
        say(
            f"[qfedx_tpu_torch] model={model.name} "
            f"clients={data['cx'].shape[0]} "
            f"samples/client≤{data['cx'].shape[1]} "
            f"classes={data['num_classes']}"
        )

        def on_round_end(r, m):
            run.on_round_end(r, m)
            if (r + 1) % 5 == 0:
                say(f"[round {r + 1:3d}] " + json.dumps(m))

        prof_dir = obs.profile.profile_dir(str(run.dir / "profile"))
        if profile and prof_dir is None:
            prof_dir = str(run.dir / "profile")
        bridge_set = False
        if prof_dir is not None and obs.enabled() and not pins.pin_is_set(
            "QFEDX_TRACE_XLA"
        ):
            # Spans as record_function ranges while profiling, so the
            # parse attributes device time per phase; cleared after.
            pins.set_pin("QFEDX_TRACE_XLA", "1")
            bridge_set = True
        profile_ctx = (
            obs.profile.capture(
                prof_dir, cuda=pins.resolve_device(device).type == "cuda")
            if prof_dir is not None else contextlib.nullcontext()
        )
        prof_parsed = None
        try:
            with profile_ctx:
                result = train_federated(
                    model,
                    cfg.fed,
                    data["cx"],
                    data["cy"],
                    data["cmask"],
                    eval_x,
                    eval_y,
                    num_rounds=cfg.num_rounds,
                    seed=cfg.seed,
                    eval_every=cfg.eval_every,
                    eval_batches=cfg.eval_batches,
                    rounds_per_call=cfg.rounds_per_call,
                    pipeline_depth=cfg.pipeline_depth,
                    on_round_end=on_round_end,
                    checkpointer=run.checkpointer(every=cfg.checkpoint_every),
                    mesh=mesh,
                )
        finally:
            if bridge_set:
                pins.clear_pin("QFEDX_TRACE_XLA")
            if prof_dir is not None and is_primary():
                # Parsed on the crash path too: a killed run most needs
                # its device timeline.
                try:
                    prof_parsed = obs.profile.parse_capture(prof_dir)
                    psum = obs.profile.summarize(prof_parsed)
                    obs.profile.attach_span_device(psum)
                    (run.dir / "profile_summary.json").write_text(
                        json.dumps(psum, indent=2))
                except Exception as exc:  # noqa: BLE001 — reporting must
                    say(f"[qfedx_tpu_torch] profile parse failed: {exc}")
                    prof_parsed = None  # not mask the run's own outcome
                else:
                    say(
                        "[qfedx_tpu_torch] profile summary: "
                        f"{run.dir / 'profile_summary.json'} "
                        f"(ops={psum['ops_executed']}, "
                        f"gap_p50={psum['gap_p50_us']}us, "
                        f"busy={psum['device_busy_fraction']}, under the "
                        "profiler)")
        with obs.span("final.eval"):
            test_metrics = result.evaluate(result.params, test_x, test_y)
        summary = {
            "final_accuracy": test_metrics["accuracy"],
            "final_val_accuracy": result.final_accuracy if have_val else None,
            "final_auc": test_metrics.get("auc"),
            "rounds": cfg.num_rounds,
            "mean_round_time_s": (
                sum(result.round_times_s) / len(result.round_times_s)
                if result.round_times_s
                else 0.0
            ),
            "comm_mb_per_round": result.comm_mb_per_round,
            "final_epsilon": result.epsilons[-1] if result.epsilons else None,
        }
        run.finish(**summary)
        if obs.enabled() and is_primary():
            # A parsed capture adds the device-op lane on the same clock.
            if prof_parsed is not None:
                trace_path = obs.profile.write_merged_trace(
                    run.dir / "trace.json", prof_parsed)
                say(f"[qfedx_tpu_torch] phase trace: {trace_path} "
                    "(host spans + device lane; load in Perfetto)")
            else:
                trace_path = obs.write_chrome_trace(run.dir / "trace.json")
                say(f"[qfedx_tpu_torch] phase trace: {trace_path} "
                    "(load in Perfetto / chrome://tracing)")
        say("[qfedx_tpu_torch] " + json.dumps(summary))
        return summary


def run_serve(args, device=None) -> dict:
    """``serve``: restore → warm every bucket → answer a JSONL request
    stream through the micro-batcher, draining on EOF or Ctrl-C.

    Responses are written in input order: one ``{"id", "pred", "probs",
    "logits"}`` object per admitted request, ``{"id", "error", "code":
    400}`` for a malformed or non-finite line (the stream keeps
    flowing), ``{"id", "error", "code": 500}`` for a failed batch. The
    in-flight window is capped at the admission queue's depth, so a slow
    device backpressures the reader. A SIGTERM lands as a
    ``KeyboardInterrupt`` (``utils/host``), so the drain answers every
    admitted request, and with ``QFEDX_FLIGHT`` the black box lands in
    the run directory. ``QFEDX_FAULTS`` reaches the engine's and the
    batcher's fault sites. The summary's p50/p95 come from a bounded
    ``obs.Histogram`` (within one bucket-width of the exact quantile,
    never above it); ``--trace`` writes ``serve_trace.json``."""
    import contextlib

    from qfedx_tpu_torch import obs
    from qfedx_tpu_torch.obs import flight
    from qfedx_tpu_torch.serve import MicroBatcher, RequestError, ServeConfig
    from qfedx_tpu_torch.serve.engine import engine_from_run_dir
    from qfedx_tpu_torch.utils import pins
    from qfedx_tpu_torch.utils.host import (
        install_sigterm_interrupt,
        is_primary,
        restore_sigterm,
    )

    if args.trace:
        pins.set_pin("QFEDX_TRACE", "1")
        obs.reset()
    say = _say()
    if getattr(args, "tuned", None) is not None:
        # Replay the `tune` winner as pins before the config resolves;
        # operator-set pins are skipped inside apply_best_config, and
        # explicit --buckets/--deadline-ms flags below still win.
        from qfedx_tpu_torch.tune import offline as tune_offline

        applied = tune_offline.apply_best_config(args.tuned or args.run_dir)
        say("[qfedx_tpu_torch] tuned pins applied: "
            + json.dumps(applied["applied"])
            + (f" (operator kept: {sorted(applied['skipped'])})"
               if applied["skipped"] else ""), file=sys.stderr)
    buckets = (
        tuple(int(b) for b in args.buckets.split(",")) if args.buckets
        else None
    )
    cfg = ServeConfig.resolve(
        buckets=buckets, deadline_ms=args.deadline_ms,
        max_queue=args.max_queue,
    )
    engine, info = engine_from_run_dir(
        args.run_dir, round_idx=args.round, config=cfg, device=device
    )
    say(f"[qfedx_tpu_torch] serving {info['model']} from "
        f"{info['run_dir']} (round {info['round']}, "
        f"{info['num_classes']} classes)", file=sys.stderr)
    with obs.span("serve.warmup_all"):
        warm = engine.warmup()
    say("[qfedx_tpu_torch] warm buckets: " + ", ".join(
        f"{b} ({v['wall_s']:.2f}s wall)" for b, v in warm["buckets"].items()
    ) + f"; kernel builds {warm['kernel_builds']}", file=sys.stderr)
    say("[qfedx_tpu_torch] route: " + ", ".join(
        f"{k}={v}" for k, v in warm["route_resolved"].items()
    ), file=sys.stderr)

    in_f = sys.stdin if args.input == "-" else open(args.input)
    out_f = sys.stdout if args.output == "-" else open(args.output, "w")
    # Bounded: a long-lived loop holds ~2 KB of buckets however much
    # traffic it answers.
    lat_hist = obs.Histogram()
    window: list = []  # ordered (id, future | error-dict) in-flight pairs

    def emit(rid, fut_or_err):
        if isinstance(fut_or_err, dict):
            rec = {"id": rid, **fut_or_err}
        else:
            try:
                res = fut_or_err.result(timeout=60.0)
            except Exception as exc:  # noqa: BLE001 — a failed batch answers
                # its own requests with 5xx records; the server keeps serving
                rec = {"id": rid, "error": str(exc), "code": 500}
            else:
                # Submit → answer on the batcher's clock: emit may run
                # long after completion when the input stream is slow.
                lat_hist.record(
                    (fut_or_err.done_t - fut_or_err.submit_t) * 1e3)
                rec = {
                    "id": rid,
                    "pred": res["pred"],
                    "probs": [round(float(p), 6) for p in res["probs"]],
                    "logits": [float(v) for v in res["logits"]],
                }
        out_f.write(json.dumps(rec) + "\n")
        out_f.flush()

    flight.set_dump_path(Path(args.run_dir) / "flight.json")
    sigterm_token = install_sigterm_interrupt()
    batcher = MicroBatcher(engine).start()
    responses = 0
    try:
        for i, line in enumerate(in_f):
            line = line.strip()
            if not line:
                continue
            try:
                req = json.loads(line)
            except json.JSONDecodeError as exc:
                window.append((i, {"error": f"bad JSON: {exc}", "code": 400}))
                continue
            feats = req.get("features") if isinstance(req, dict) else req
            rid = req.get("id", i) if isinstance(req, dict) else i
            try:
                fut = batcher.submit(feats)
            except RequestError as exc:
                window.append((rid, {"error": str(exc), "code": 400}))
            else:
                window.append((rid, fut))
            # Resolve the head once the window is full, so submit never
            # hits its own Overloaded shed. Emit-then-pop: an interrupt
            # leaves only unanswered entries for the final drain.
            while len(window) >= cfg.max_queue:
                emit(*window[0])
                window.pop(0)
                responses += 1
        while window:
            emit(*window[0])
            window.pop(0)
            responses += 1
    except KeyboardInterrupt:
        say("[qfedx_tpu_torch] interrupted — draining in-flight requests",
            file=sys.stderr)
        flight.maybe_dump(reason="sigterm")
    finally:
        batcher.close(drain=True)
        while window:  # answered by the drain; emit in order
            pair = window.pop(0)
            with contextlib.suppress(Exception):
                emit(*pair)
                responses += 1
        restore_sigterm(sigterm_token)
        if in_f is not sys.stdin:
            in_f.close()
        if out_f is not sys.stdout:
            out_f.close()
        # In the finally, so a crash still leaves the completed spans.
        if obs.enabled() and is_primary():
            trace_path = obs.write_chrome_trace(
                Path(args.run_dir) / "serve_trace.json")
            say(f"[qfedx_tpu_torch] serve trace: {trace_path}",
                file=sys.stderr)

    def pct(q):  # the nearest-rank rule over log buckets (obs/histo.py)
        return round(lat_hist.percentile(q), 3) if lat_hist.count else None

    # "served" counts requests the engine answered; "responses" counts
    # emitted lines, error records included.
    summary = {
        "served": batcher.stats["served"],
        "responses": responses,
        "p50_ms": pct(0.50),
        "p95_ms": pct(0.95),
        **{k: batcher.stats[k] for k in ("rejected", "shed", "batches")},
    }
    say("[qfedx_tpu_torch] serve summary: " + json.dumps(summary),
        file=sys.stderr)
    return summary


def run_tune(args, device=None) -> dict:
    """``tune``: the offline half of the closed loop. Restores the run's
    checkpoint once on ``device``, sweeps the (bucket set × deadline)
    lattice through the real serving stack, and writes the winning cell
    as a ``best_config.json`` pin sidecar (tune/offline.py)."""
    from qfedx_tpu_torch.tune import offline as tune_offline

    say = _say()
    bucket_sets = (
        tuple(
            tuple(int(b) for b in grp.split(","))
            for grp in args.buckets.split(";") if grp.strip()
        )
        if args.buckets else None
    )
    deadlines = (
        tuple(float(d) for d in args.deadlines.split(","))
        if args.deadlines else None
    )
    record = tune_offline.tune_run_dir(
        args.run_dir,
        round_idx=args.round,
        slo_ms=args.slo_ms,
        bucket_sets=bucket_sets,
        deadlines_ms=deadlines,
        requests=args.requests,
        out_path=args.out,
        device=device,
    )
    say(f"[qfedx_tpu_torch] tuned {args.run_dir}: {len(record['cells'])} "
        f"cells swept, winner pins {json.dumps(record['pins'])} "
        f"(throughput_at_slo={record['score']['throughput_at_slo']}, "
        f"p95={record['score']['p95_ms']}ms)")
    say(f"[qfedx_tpu_torch] sidecar: {record['path']} — restore with "
        "`serve --tuned`")
    say("[qfedx_tpu_torch] " + json.dumps(
        {k: record[k] for k in ("schema", "key", "pins", "score", "path")}
    ))
    return record


# -- the bench-trajectory regression ledger ------------------------------------
#
# ``bench history`` parses the committed BENCH_r*.json trajectory (the
# reference's bench.py snapshots) into per-metric trend verdicts with a
# gate-able exit code: pure stdlib file parsing, no device, the same
# rules as the reference's tool.

# The first round whose timing methodology is comparable: earlier rounds
# are tagged and excluded from trend verdicts rather than compared.
_FIRST_COMPARABLE_BENCH_ROUND = 4
# Provenance watermark: rounds up to this one ran on the TPU; later ones
# in CPU containers, never trend-compared against chip numbers. A row's
# explicit "backend" field wins over this inference.
_LAST_ONCHIP_BENCH_ROUND = 5

# (dotted path into the parsed compact row, higher_is_better)
_BENCH_TREND_METRICS = (
    ("value", True),
    ("per_dispatch_value", True),
    ("fed16q_client_rounds_per_s.bf16", True),
    ("engine_fwd_grad_ms.n18", False),
    ("time_to_target.seconds", False),
)


def _dig(obj, dotted):
    for part in dotted.split("."):
        if not isinstance(obj, dict) or part not in obj:
            return None
        obj = obj[part]
    return obj


def _bench_history_rows(bench_dir) -> list[dict]:
    """Parse every BENCH_r*.json in ``bench_dir``, numerically sorted,
    each row tagged with methodology era and on-chip-vs-CPU provenance.
    A null ``parsed`` is recovered from the captured ``tail`` (the same
    recovery rule as the writer's)."""
    import re

    rows = []
    for path in Path(bench_dir).glob("BENCH_r*.json"):
        m = re.search(r"BENCH_r(\d+)\.json$", path.name)
        if not m:
            continue
        n = int(m.group(1))
        row = {"round": n, "file": path.name}
        try:
            rec = json.loads(path.read_text())
        except ValueError:
            row.update(parseable=False, error="bad JSON")
            rows.append(row)
            continue
        parsed = rec.get("parsed")
        recovered = False
        if not isinstance(parsed, dict):
            tail = rec.get("tail") or ""
            at = tail.find('{"metric"')
            if at >= 0:
                try:
                    parsed, _end = json.JSONDecoder().raw_decode(tail[at:])
                    recovered = isinstance(parsed, dict)
                except ValueError:
                    parsed = None
            if not isinstance(parsed, dict):
                parsed = None
        backend = parsed.get("backend") if parsed else None
        row.update(
            rc=rec.get("rc"),
            parseable=parsed is not None,
            recovered_from_tail=recovered,
            methodology=(
                "pre-r04" if n < _FIRST_COMPARABLE_BENCH_ROUND else "r04+"
            ),
            provenance=backend or (
                "tpu" if n <= _LAST_ONCHIP_BENCH_ROUND else "cpu"
            ),
            parsed=parsed,
        )
        rows.append(row)
    rows.sort(key=lambda r: r["round"])
    return rows


def _bench_trends(rows) -> tuple[dict, list[str]]:
    """Per-metric trend verdicts over the comparable rows ("r04+"
    methodology), comparing the latest point against the most recent
    EARLIER point of the SAME provenance — a CPU-container number must
    never read as a regression against an on-chip one. Thresholds:
    ±5%."""
    verdicts: dict = {}
    regressed: list[str] = []
    comparable = [
        r for r in rows if r.get("parseable") and r["methodology"] == "r04+"
    ]
    for key, higher_better in _BENCH_TREND_METRICS:
        series = []
        for r in comparable:
            v = _dig(r["parsed"], key)
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                series.append((r["round"], r["provenance"], float(v)))
        if len(series) < 2:
            verdicts[key] = {"verdict": "n/a", "points": len(series)}
            continue
        last = series[-1]
        prev = next(
            (s for s in reversed(series[:-1]) if s[1] == last[1]), None
        )
        if prev is None:
            verdicts[key] = {
                "verdict": "no-prior-same-provenance",
                "now_round": last[0],
                "provenance": last[1],
            }
            continue
        if prev[2] == 0:
            verdicts[key] = {"verdict": "n/a", "points": len(series)}
            continue
        ratio = last[2] / prev[2]
        if higher_better:
            verdict = (
                "regressed" if ratio < 0.95
                else ("improved" if ratio > 1.05 else "flat")
            )
        else:
            verdict = (
                "regressed" if ratio > 1.05
                else ("improved" if ratio < 0.95 else "flat")
            )
        verdicts[key] = {
            "verdict": verdict,
            "prev_round": prev[0],
            "now_round": last[0],
            "prev": prev[2],
            "now": last[2],
            "ratio": round(ratio, 4),
            "provenance": last[1],
        }
        if verdict == "regressed":
            regressed.append(key)
    return verdicts, regressed


def _bench_history_compact(bench_dir) -> dict | None:
    """One-line ledger summary, or None when ``bench_dir`` holds no
    BENCH files — what ``inspect`` attaches when a run dir sits next to
    the committed trajectory."""
    rows = _bench_history_rows(bench_dir)
    if not rows:
        return None
    _verdicts, regressed = _bench_trends(rows)
    return {
        "dir": str(bench_dir),
        "rounds": len(rows),
        "latest": rows[-1]["round"],
        "latest_on_chip": max(
            (r["round"] for r in rows if r.get("provenance") == "tpu"),
            default=None,
        ),
        "regressed": regressed,
    }


def run_bench_history(args) -> int:
    """``bench history``: the regression ledger. Exit 0 = no trend
    regression, 1 = regression (gate-able; ``--no-gate`` keeps it
    advisory), 2 = no BENCH files found."""
    say = _say()
    bench_dir = Path(args.dir)
    rows = _bench_history_rows(bench_dir)
    if not rows:
        say(f"[qfedx_tpu_torch] no BENCH_r*.json files under {bench_dir}")
        return 2
    verdicts, regressed = _bench_trends(rows)
    report = {
        "dir": str(bench_dir),
        "rows": [
            {k: v for k, v in r.items() if k != "parsed"} for r in rows
        ],
        "verdicts": verdicts,
        "regressed": regressed,
        "latest_on_chip": max(
            (r["round"] for r in rows if r.get("provenance") == "tpu"),
            default=None,
        ),
    }
    if args.as_json:
        say(json.dumps(report))
    else:
        for r in rows:
            tags = [r.get("methodology", "?"), r.get("provenance", "?")]
            if not r.get("parseable"):
                tags.append("unparseable")
            elif r.get("recovered_from_tail"):
                tags.append("tail-recovered")
            val = _dig(r.get("parsed") or {}, "value")
            say(f"[qfedx_tpu_torch] r{r['round']:02d} {r['file']}: "
                f"value={val} [{', '.join(tags)}]")
        for key, v in verdicts.items():
            say(f"[qfedx_tpu_torch] {key}: {json.dumps(v)}")
        say("[qfedx_tpu_torch] " + json.dumps(report))
        if regressed and not args.no_gate:
            say("[qfedx_tpu_torch] REGRESSED: " + ", ".join(regressed))
    if regressed and not args.no_gate:
        return 1
    return 0


def run_inspect(run_dir) -> dict:
    """``inspect <run-dir>``: the read side of the run directory.

    Summarizes ``metrics.jsonl`` (rounds completed, loss/accuracy
    trajectory, the casualty/byzantine/staleness ledger totals, the
    alert and tune event rows, schema validation of every row via
    ``validate_metrics_record``), ``summary.json``,
    ``profile_summary.json`` (with ``floor_attribution``),
    ``config.json``, ``flight.json``, ``best_config.json`` and the
    adjacent ``BENCH_r*.json`` compact row. Prints a compact report plus
    one final JSON line; returns the dict (the reference's, key for
    key)."""
    from qfedx_tpu_torch.run.metrics import validate_metrics_record

    say = _say()
    run_dir = Path(run_dir)
    metrics_path = run_dir / "metrics.jsonl"
    if not metrics_path.exists():
        raise FileNotFoundError(
            f"{metrics_path} not found — not a tracked run directory"
        )

    rows, invalid = [], []
    for i, line in enumerate(metrics_path.read_text().splitlines()):
        if not line.strip():
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError as exc:
            invalid.append(f"line {i + 1}: bad JSON: {exc}")
            continue
        try:
            rows.append(validate_metrics_record(rec))
        except ValueError as exc:
            invalid.append(f"line {i + 1}: {exc}")
            # Schema violations are REPORTED, not fatal: a pre-schema
            # run still summarizes from whatever rounds it recorded.
            if isinstance(rec.get("round"), int):
                rows.append(rec)

    # Event rows (watchdog alerts, tune decisions) interleave with round rows in
    # the same file, keyed by "event" instead of "round" — every
    # round-shaped aggregate below must see round rows ONLY.
    event_rows = [r for r in rows if "event" in r]
    rows = [r for r in rows if "event" not in r]
    accs = [r["accuracy"] for r in rows if r.get("accuracy") is not None]
    losses = [r["loss"] for r in rows if r.get("loss") is not None]
    # The permanent robustness record (the round ledgers) — summed only
    # over rows that carry the field, so pre-guard runs report nothing.
    ledger = {
        field: int(sum(r[field] for r in rows if field in r))
        for field in (
            "rejected_updates", "dropped_clients", "clipped_clients",
            "late_waves", "stale_partials_applied", "stale_discarded_waves",
        )
        if any(field in r for r in rows)
    }
    # The detection record: firing transitions per rule ID, from the
    # structured alert events the watchdog sank into this file.
    alerts_fired: dict[str, int] = {}
    for r in event_rows:
        if r.get("event") == "alert" and r.get("state") == "firing":
            rid = str(r.get("rule", "?"))
            alerts_fired[rid] = alerts_fired.get(rid, 0) + 1
    # The adaptation record: tune-controller decisions per
    # decision ID, reverts counted apart — shown next to the alert
    # totals so one inspect answers "what fired AND what adapted".
    # Tolerant of no-tuner runs (both stay empty/zero).
    tune_decisions: dict[str, int] = {}
    tune_reverts = 0
    for r in event_rows:
        if r.get("event") == "tune":
            did = str(r.get("decision", "?"))
            tune_decisions[did] = tune_decisions.get(did, 0) + 1
            if r.get("revert"):
                tune_reverts += 1
    out = {
        "run_dir": str(run_dir),
        "rounds_completed": max((r["round"] for r in rows), default=0),
        "metrics_rows": len(rows),
        "event_rows": len(event_rows),
        "alerts_fired": alerts_fired,
        "tune_decisions": tune_decisions,
        "tune_reverts": tune_reverts,
        "invalid_rows": len(invalid),
        "first_accuracy": accs[0] if accs else None,
        "best_accuracy": max(accs) if accs else None,
        "last_accuracy": accs[-1] if accs else None,
        "last_loss": losses[-1] if losses else None,
        "last_epsilon": next(
            (r["epsilon"] for r in reversed(rows) if r.get("epsilon")
             is not None),
            None,
        ),
        "rounds_skipped": sum(1 for r in rows if r.get("skipped")),
        "ledger": ledger,
    }
    # The fuse/scan/kernel chain as THIS process resolves it (the run's
    # own raw pins live in config.json).
    from qfedx_tpu_torch.ops.scan_body import resolved_route

    out["route"] = resolved_route()
    # Artifact problems are tracked apart from metrics-row validation:
    # invalid_rows (already in `out`) counts metrics.jsonl records only,
    # and a truncated summary.json must still show up in the JSON line.
    bad_artifacts = []
    for name in ("summary.json", "profile_summary.json", "config.json"):
        path = run_dir / name
        if path.exists():
            try:
                obj = json.loads(path.read_text())
            except ValueError:
                bad_artifacts.append(name)
                continue
            if name == "summary.json":
                out["summary"] = {
                    k: obj.get(k)
                    for k in ("final_accuracy", "final_epsilon",
                              "wall_time_s", "partial", "crashed")
                    if k in obj
                }
            elif name == "profile_summary.json":
                out["profile"] = {
                    k: obj.get(k)
                    for k in ("ops_executed", "gap_p50_us",
                              "device_busy_fraction", "device_busy_s")
                }
                # The floor_attribution compact row (obs/profile.py).
                from qfedx_tpu_torch.obs import profile as obs_profile

                out["floor_attribution"] = obs_profile.floor_attribution(
                    obj.get("static_state_ops"), obj
                )
            else:
                model = (obj.get("model") or {})
                out["model"] = (
                    f"{model.get('model', '?')} "
                    f"n={model.get('n_qubits', '?')} "
                    f"layers={model.get('n_layers', '?')}"
                )
    # The black box: a flight.json left by a SIGTERM'd/crashed or
    # alert-firing process. Summarized, never re-dumped — inspect is the
    # read side.
    flight_path = run_dir / "flight.json"
    if flight_path.exists():
        try:
            fl = json.loads(flight_path.read_text())
        except ValueError:
            bad_artifacts.append("flight.json")
        else:
            out["flight"] = {
                "path": str(flight_path),
                "bytes": flight_path.stat().st_size,
                "reason": fl.get("reason"),
                "events": len(fl.get("events", [])),
                "dropped": fl.get("dropped"),
            }
    # The tuned sidecar: a best_config.json left by `tune` — chosen
    # cell, score, provenance. Absent for untuned runs.
    tuned_path = run_dir / "best_config.json"
    if tuned_path.exists():
        try:
            tuned = json.loads(tuned_path.read_text())
        except ValueError:
            bad_artifacts.append("best_config.json")
        else:
            out["tune"] = {
                "path": str(tuned_path),
                "pins": tuned.get("pins"),
                "score": tuned.get("score"),
                "cells": len(tuned.get("cells") or []),
                "source": (tuned.get("provenance") or {}).get("source"),
            }
    # Bench-trajectory adjacency: when this run dir sits inside (or
    # next to) a checkout carrying the committed BENCH_r*.json ledger,
    # attach the compact history row so one inspect answers both "how
    # did this run do" and "where is the trajectory".
    for cand in (run_dir, run_dir.parent, run_dir.parent.parent):
        compact = _bench_history_compact(cand)
        if compact is not None:
            out["bench_history"] = compact
            break
    if bad_artifacts:
        out["unreadable_artifacts"] = bad_artifacts
    say(f"[qfedx_tpu_torch] {run_dir}: {out['rounds_completed']} rounds, "
        f"accuracy {out['first_accuracy']} -> {out['last_accuracy']} "
        f"(best {out['best_accuracy']})")
    if ledger:
        say("[qfedx_tpu_torch] ledger: " + json.dumps(ledger))
    if alerts_fired:
        say("[qfedx_tpu_torch] alerts fired: " + json.dumps(alerts_fired))
    if tune_decisions:
        say("[qfedx_tpu_torch] tune decisions: " + json.dumps(tune_decisions)
            + f" (reverts: {tune_reverts})")
    if "tune" in out:
        say(f"[qfedx_tpu_torch] tuned sidecar: {out['tune']['path']} "
            f"(pins {json.dumps(out['tune']['pins'])}, "
            f"score {json.dumps(out['tune']['score'])}, "
            f"{out['tune']['cells']} cells)")
    if "flight" in out:
        say(f"[qfedx_tpu_torch] flight recorder: {out['flight']['path']} "
            f"({out['flight']['bytes']} bytes, "
            f"reason={out['flight']['reason']}, "
            f"{out['flight']['events']} events)")
    if "bench_history" in out:
        say("[qfedx_tpu_torch] bench history: "
            + json.dumps(out["bench_history"]))
    say("[qfedx_tpu_torch] route: " + json.dumps(out["route"]))
    if "floor_attribution" in out:
        say("[qfedx_tpu_torch] floor: " + json.dumps(out["floor_attribution"]))
    for problem in invalid[:5]:
        say(f"[qfedx_tpu_torch] invalid metrics record: {problem}")
    for name in bad_artifacts:
        say(f"[qfedx_tpu_torch] unreadable artifact: {name}")
    say("[qfedx_tpu_torch] " + json.dumps(out))
    return out


def run_lint_cmd(args) -> int:
    """``lint``: run the analysis engine, print text or JSON, exit
    non-zero on any non-baselined finding (tests/test_torch_lint.py
    gates the same engine)."""
    from qfedx_tpu_torch import analysis
    from qfedx_tpu_torch.analysis import engine as lint_engine

    say = _say()
    cfg = analysis.load_config()
    if args.baseline:
        cfg.baseline = args.baseline
    rules = (
        tuple(r.strip() for r in args.rules.split(",") if r.strip())
        if args.rules else None
    )
    result = analysis.run_lint(config=cfg, rules=rules)
    if args.update_baseline:
        ctx = lint_engine.LintContext(cfg)
        n = lint_engine.write_baseline(
            cfg.baseline_path, ctx,
            result.findings + result.baselined,
            rules_run=result.rules_run,
        )
        say(f"[qfedx_tpu_torch] baseline rewritten: {cfg.baseline_path} "
            f"({n} entries)")
        return 0
    if args.as_json:
        say(analysis.render_json(result))
    else:
        say(analysis.render_text(
            result, verbose_baselined=args.show_baselined
        ))
    return 0 if result.ok else 1



def main(argv=None, device=None, devices=None):
    """Parse ``argv`` and run the subcommand on ``device`` (None = the
    card; the tests pass ``"cpu"``), ``train``'s and ``sweep``'s mesh on
    ``devices`` (None: ``parallel.mesh.local_devices()``). Returns the
    subcommand's summary; ``lint`` and ``bench history`` exit with their
    codes, as the reference's do."""
    parser = build_parser()
    args, extra = parser.parse_known_args(argv)
    if args.cmd in _UNPORTED:
        raise NotImplementedError(
            f"the {args.cmd!r} subcommand is not ported yet (ROADMAP Queue 1 "
            f"item {_UNPORTED[args.cmd]})"
        )
    if extra:
        parser.error(f"unrecognized arguments: {' '.join(extra)}")
    if args.cmd == "lint":
        # No torch, no device: lint is a pure AST pass, seconds.
        raise SystemExit(run_lint_cmd(args))
    if args.cmd == "bench":
        # Pure file parsing over committed BENCH_r*.json snapshots.
        raise SystemExit(run_bench_history(args))
    if args.cmd == "train":
        if args.tuned:
            # Replay tuned pins before the config is built, so route
            # choices land in config.json with the run. Operator-set pins
            # win inside apply.
            from qfedx_tpu_torch.tune import offline as tune_offline

            applied = tune_offline.apply_best_config(args.tuned)
            _say()("[qfedx_tpu_torch] tuned pins applied: "
                   + json.dumps(applied["applied"]))
        return run_train(config_from_args(args), resume=args.resume,
                         device=device, profile=args.profile,
                         trace=args.trace, plots=args.plots,
                         devices=devices)
    if args.cmd == "serve":
        return run_serve(args, device=device)
    if args.cmd == "tune":
        return run_tune(args, device=device)
    if args.cmd == "inspect":
        return run_inspect(args.run_dir)
    if args.cmd == "demo":
        from qfedx_tpu_torch.run.demo import run_demo

        return run_demo(out_dir=args.out, dataset=args.dataset,
                        device=device)
    from qfedx_tpu_torch.run.sweep import run_sweep

    kw = {} if devices is None else {"devices": devices}
    return run_sweep(preset=args.preset, seeds=args.seeds,
                     root=args.run_root, device=device, **kw)
