"""Command-line entry point: ``python -m qfedx_tpu_torch train|serve ...``.

Counterpart of ``qfedx_tpu/run/cli.py``: ``build_parser`` takes the
reference's subcommands and flags, so the same argv parses the same way
and ``config_from_args`` gives the same ``ExperimentConfig``. ``train``
builds the data and the model, trains in a tracked run directory
(``config.json``, ``metrics.jsonl``, ``summary.json``, checkpoints) and
prints the summary; ``serve --run-dir`` restores a run's checkpoint and
answers a JSONL request stream. ``main(argv, device=None)`` runs on the
card unless a caller passes ``device="cpu"`` (the tests do).

Every ``--model`` (vqc, cnn, qkernel, mps, with ``--bond-dim`` and
``--landmarks``), every ``--encoding`` (angle, amplitude, reupload),
every federation option of the resident round — ``--algorithm
fedprox`` with ``--prox-mu``, ``--secure-agg[-mode|-neighbors]``,
``--dp-clip/--dp-sigma/--dp-mode client|example`` (the summary's
``final_epsilon``), ``--aggregator``, ``--clip-bound``,
``--trim-fraction``, ``--client-fraction`` and ``--optimizer spsa`` —
and the VQC's noise flags (``--depolarizing``, ``--damping``,
``--readout-flip``, ``--shots``, ``--noise-placement readout|circuit``)
run. The staleness settings (``--staleness-mode``, ``--staleness-alpha``,
``--staleness-max-age``) go into ``FedConfig`` as in the reference; the
resident trainer ignores them, as the reference's does (the streamed
trainer, ``run/trainer.train_federated_streamed``, is a library entry
in both packages). Not ported yet, each raising NotImplementedError:
``--plots``, ``--profile``, ``--trace`` and ``--tuned`` (ROADMAP Queue 1
item 14); sharding (``run/config.build_model``, item 12); and the
``tune``,
``inspect``, ``demo``, ``sweep`` and ``bench`` subcommands (item 14) and
``lint`` (item 15).
"""

from __future__ import annotations

import argparse
import json
import sys

from qfedx_tpu_torch.fed.config import DPConfig, FedConfig
from qfedx_tpu_torch.run.config import (
    DataConfig,
    ExperimentConfig,
    ModelConfig,
    build_data,
    build_model,
)


# The reference's other subcommands, with the ROADMAP Queue 1 item that
# ports each.
_UNPORTED = {"tune": 14, "inspect": 14, "demo": 14, "sweep": 14, "bench": 14,
             "lint": 15}


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
                   help="not ported yet: raises (ROADMAP Queue 1 item 14)")
    t.add_argument("--profile", action="store_true",
                   help="not ported yet: raises (ROADMAP Queue 1 item 14)")
    t.add_argument("--trace", action="store_true",
                   help="not ported yet: raises (ROADMAP Queue 1 item 14)")
    t.add_argument("--tuned", default=None, metavar="PATH",
                   help="not ported yet: raises (ROADMAP Queue 1 item 14)")

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
                   help="not ported yet: raises (ROADMAP Queue 1 item 14)")
    v.add_argument("--tuned", nargs="?", const="", default=None,
                   metavar="PATH",
                   help="not ported yet: raises (ROADMAP Queue 1 item 14)")

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




def _refuse_unported_train_flags(a: argparse.Namespace) -> None:
    """Flags whose paths the port does not have yet raise; they never
    silently run something else. (Sharding raises in
    ``run/config.build_model``.)"""
    for flag, on, item in (
        ("--plots", a.plots, 14), ("--profile", a.profile, 14),
        ("--trace", a.trace, 14), ("--tuned", a.tuned is not None, 14),
    ):
        if on:
            raise NotImplementedError(
                f"{flag} is not ported yet (ROADMAP Queue 1 item {item})"
            )


def run_train(cfg: ExperimentConfig, resume: bool = False,
              device=None, data: dict | None = None) -> dict:
    """Train ``cfg`` in a tracked run directory on ``device`` (None = the
    card); returns the summary ``summary.json`` holds. ``data`` is what
    ``build_data(cfg)`` returns, for a caller that has built it already."""
    from qfedx_tpu_torch.run.metrics import ExperimentRun
    from qfedx_tpu_torch.run.trainer import train_federated

    if data is None:
        data = build_data(cfg)
    model = build_model(cfg, data["num_classes"], device=device)
    test_x, test_y = data["test"]
    val_x, val_y = data["val"]
    # Per-round evaluation on the validation split; the test set is
    # touched once, at the end.
    have_val = len(val_y) > 0
    eval_x, eval_y = (val_x, val_y) if have_val else (test_x, test_y)

    with ExperimentRun(cfg.run_root, cfg.run_name(), config=cfg,
                       resume=resume) as run:
        print(f"[qfedx_tpu_torch] run dir: {run.dir}")
        print(
            f"[qfedx_tpu_torch] model={model.name} "
            f"clients={data['cx'].shape[0]} "
            f"samples/client≤{data['cx'].shape[1]} "
            f"classes={data['num_classes']}"
        )

        def on_round_end(r, m):
            run.on_round_end(r, m)
            if (r + 1) % 5 == 0:
                print(f"[round {r + 1:3d}] " + json.dumps(m))

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
        )
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
        print("[qfedx_tpu_torch] " + json.dumps(summary))
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
    admitted request. ``QFEDX_FAULTS`` reaches the engine's and the
    batcher's fault sites. The latencies are kept exactly (the
    reference's bounded histogram is ROADMAP Queue 1 item 14)."""
    import contextlib

    import numpy as np

    from qfedx_tpu_torch.serve import MicroBatcher, RequestError, ServeConfig
    from qfedx_tpu_torch.serve.engine import engine_from_run_dir
    from qfedx_tpu_torch.utils.host import (
        install_sigterm_interrupt,
        restore_sigterm,
    )

    if args.trace or args.tuned is not None:
        raise NotImplementedError(
            "serve --trace and --tuned are not ported yet (ROADMAP Queue 1 "
            "item 14)"
        )
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
    print(f"[qfedx_tpu_torch] serving {info['model']} from "
          f"{info['run_dir']} (round {info['round']}, "
          f"{info['num_classes']} classes)", file=sys.stderr)
    warm = engine.warmup()
    print("[qfedx_tpu_torch] warm buckets: " + ", ".join(
        f"{b} ({v['wall_s']:.2f}s wall)" for b, v in warm["buckets"].items()
    ) + f"; kernel builds {warm['kernel_builds']}", file=sys.stderr)
    print("[qfedx_tpu_torch] route: " + ", ".join(
        f"{k}={v}" for k, v in warm["route_resolved"].items()
    ), file=sys.stderr)

    in_f = sys.stdin if args.input == "-" else open(args.input)
    out_f = sys.stdout if args.output == "-" else open(args.output, "w")
    lat_ms: list[float] = []
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
                lat_ms.append((fut_or_err.done_t - fut_or_err.submit_t) * 1e3)
                rec = {
                    "id": rid,
                    "pred": res["pred"],
                    "probs": [round(float(p), 6) for p in res["probs"]],
                    "logits": [float(v) for v in res["logits"]],
                }
        out_f.write(json.dumps(rec) + "\n")
        out_f.flush()

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
        print("[qfedx_tpu_torch] interrupted — draining in-flight requests",
              file=sys.stderr)
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

    def pct(q):
        return round(float(np.percentile(lat_ms, q)), 3) if lat_ms else None

    # "served" counts requests the engine answered; "responses" counts
    # emitted lines, error records included.
    summary = {
        "served": batcher.stats["served"],
        "responses": responses,
        "p50_ms": pct(50),
        "p95_ms": pct(95),
        **{k: batcher.stats[k] for k in ("rejected", "shed", "batches")},
    }
    print("[qfedx_tpu_torch] serve summary: " + json.dumps(summary),
          file=sys.stderr)
    return summary


def main(argv=None, device=None):
    """Parse ``argv`` and run the subcommand on ``device`` (None = the
    card; the tests pass ``"cpu"``). Returns the subcommand's summary."""
    parser = build_parser()
    args, extra = parser.parse_known_args(argv)
    if args.cmd in _UNPORTED:
        raise NotImplementedError(
            f"the {args.cmd!r} subcommand is not ported yet (ROADMAP Queue 1 "
            f"item {_UNPORTED[args.cmd]})"
        )
    if extra:
        parser.error(f"unrecognized arguments: {' '.join(extra)}")
    if args.cmd == "train":
        _refuse_unported_train_flags(args)
        return run_train(config_from_args(args), resume=args.resume,
                         device=device)
    return run_serve(args, device=device)
