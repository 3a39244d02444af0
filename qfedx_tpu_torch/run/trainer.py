"""Host-side federated training orchestrator.

Counterpart of ``qfedx_tpu/run/trainer.py``'s ``train_federated`` on one
device: the round-0 evaluation, rounds of ``fed/round.make_fed_round``
(every local step through the scan-body kernel's Launches B and C on
the card), evaluation every ``eval_every`` rounds (Launch A at tb = 256),
checkpoints every K rounds with resume, and one metrics row per round
through ``on_round_end`` — with the reference's row semantics:

- rounds run in chunks of up to ``rounds_per_call`` that never cross a
  checkpoint (nor, without the in-chunk evaluation, an evaluation);
  ``time_s`` is the chunk's drain-to-drain wall over its rounds and
  ``chunk_rounds`` its length;
- a chunk of more than one round evaluates after each of its rounds on
  the first ``min(len, 2048)`` (or ``eval_batches·256``) evaluation
  samples, in one ``model.apply``, and records ``eval_n``; the final
  accuracy is then recomputed on the whole set;
- with guards on, ``rejected_updates`` and ``skipped`` come from the
  round's quarantine ledger;
- the final round is saved synchronously after the async writer has
  drained; a crash drains the writer without masking the exception.

With DP an ``RDPAccountant`` charges each round — client mode one step
at q = client_fraction, example mode E·S_pad/B steps at q = B/S_pad —
and each row carries ``epsilon`` (example mode's first row also the
``epsilon_accounting`` convention); a resumed run charges the rounds
its checkpoint covers first. Under ``clip_mean`` and the robust rules
the rows carry ``aggregator`` and ``clipped_clients`` or
``trimmed_fraction``.

Two things differ from the reference by necessity. The rounds' shuffles
come from a ``torch.Generator`` seeded from ``(seed, round)``, the
round's other draws (participation, DP noise, SPSA's Δ) from
``fed/round.RoundDraws`` seeded from ``(seed, round, salt[, client])``,
and with secure aggregation the round's mask seed from ``(seed, round,
salt)`` — stateless in the round index like the reference's
``fold_in``, so a resumed run equals an uninterrupted one — because
jax.random streams cannot be matched. And the pipelined loop overlaps
host work with the device only as far as the CUDA stream's asynchrony
does (results are the same at any ``pipeline_depth``, as in the
reference).

``params=``, ``perms_for_round=`` and ``draws_for_round=`` exist for the
parity tests only: initial parameters in place of ``model.init(seed)``,
a callable from the round index to the (C, E, S) shuffles the reference
drew, and one from the round index to the streams of ``RoundDraws``
the reference drew (a dict by stream name). Sv-sharded models (ROADMAP
Queue 1 item 12) raise NotImplementedError.

``train_federated_streamed`` trains over a client registry in streamed
waves: the cohort sampler, the wave uploader, the hierarchical partial
rounds and the staleness buffer (its docstring).
"""

from __future__ import annotations

import time
import warnings
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from qfedx_tpu_torch.fed.accountant import RDPAccountant
from qfedx_tpu_torch.fed.config import FedConfig
from qfedx_tpu_torch.fed.evaluate import make_evaluator
from qfedx_tpu_torch.fed.robust import resolve_aggregator
from qfedx_tpu_torch.fed.round import (
    SA_SEED_SALT,
    RoundDraws,
    guards_enabled,
    make_fed_round,
    round_generator,
)
from qfedx_tpu_torch.fed.secure_agg import round_seed
from qfedx_tpu_torch.models.api import Model
from qfedx_tpu_torch.utils import pins, trees

# The in-chunk evaluation's default cap (one un-batched forward).
_IN_CHUNK_EVAL_CAP = 2048


@dataclass
class TrainResult:
    params: Any
    accuracies: list[float]  # index 0 = round-0 (pre-training) accuracy
    losses: list[float]
    epsilons: list[float] = field(default_factory=list)
    round_times_s: list[float] = field(default_factory=list)
    comm_mb_per_round: float = 0.0
    # The UNCAPPED evaluator (eval_batches caps only the per-round ones).
    evaluate: Callable | None = None

    @property
    def final_accuracy(self) -> float:
        return self.accuracies[-1] if self.accuracies else 0.0


def resolve_pipeline_depth(pipeline_depth: int | None = None) -> int:
    """How many chunks may be dispatched but not yet drained: an explicit
    ``pipeline_depth`` wins, else the ``QFEDX_PIPELINE`` pin ('0'/'off' →
    0, '1'/'on' → 1, or an integer), else 1. Results are the same at
    any depth."""
    if pipeline_depth is not None:
        depth = int(pipeline_depth)
        if depth < 0:
            raise ValueError(f"pipeline_depth must be >= 0, got {depth}")
        return depth
    return pins.depth_pin("QFEDX_PIPELINE", 1)


def train_federated(
    model: Model,
    cfg: FedConfig,
    cx: np.ndarray,
    cy: np.ndarray,
    cmask: np.ndarray,
    test_x: np.ndarray,
    test_y: np.ndarray,
    num_rounds: int = 30,
    seed: int = 42,
    eval_every: int = 1,
    eval_batches: int | None = None,
    on_round_end: Callable[[int, dict], None] | None = None,
    checkpointer=None,
    rounds_per_call: int = 1,
    pipeline_depth: int | None = None,
    *,
    params=None,
    perms_for_round: Callable[[int], Any] | None = None,
    draws_for_round: Callable[[int], dict] | None = None,
) -> TrainResult:
    """Run federated training on the model's device; returns params +
    metric history.

    ``cx, cy, cmask``: packed client data (``data.partition.pack_clients``).
    ``on_round_end(round_idx, metrics)``: the metrics hook.
    ``checkpointer``: optional ``run.checkpoint.Checkpointer`` for
    save-every-K and resume. ``rounds_per_call`` and ``pipeline_depth``:
    see the module docstring."""
    num_clients = cx.shape[0]
    guards = guards_enabled()
    agg = resolve_aggregator(cfg)
    round_fn = make_fed_round(model, cfg, num_clients=num_clients)
    requested_rpc = max(1, int(rounds_per_call))
    # eval_every > num_rounds is the "evaluation off" convention.
    in_chunk_eval = requested_rpc > 1 and eval_every <= num_rounds
    rounds_per_call = min(
        requested_rpc,
        requested_rpc if in_chunk_eval else eval_every,
        checkpointer.every if checkpointer is not None else requested_rpc,
    )
    if rounds_per_call < requested_rpc:
        warnings.warn(
            f"rounds_per_call clamped {requested_rpc} → {rounds_per_call}: "
            "chunks cannot cross "
            + ("checkpoint" if in_chunk_eval else "eval/checkpoint")
            + " boundaries ("
            + (f"eval_every={eval_every}, " if not in_chunk_eval else "")
            + (f"checkpoint_every={checkpointer.every}"
               if checkpointer is not None else "")
            + ") — raise those cadences to chunk deeper",
            UserWarning,
            stacklevel=2,
        )
    evaluate = make_evaluator(model, max_batches=eval_batches)
    evaluate_full = make_evaluator(model)

    if params is None:
        params = model.init(seed)
    start_round = 0
    if checkpointer is not None:
        restored = checkpointer.restore_latest(params)
        if restored is not None:
            params, start_round = restored
    device = trees.tree_leaves(params)[0].device
    dcx = torch.as_tensor(np.asarray(cx, dtype=np.float32), device=device)
    dcy = torch.as_tensor(np.asarray(cy), device=device)
    dcm = torch.as_tensor(np.asarray(cmask, dtype=np.float32), device=device)

    ex_dev = ey_dev = None
    if rounds_per_call > 1 and in_chunk_eval:
        cap = (
            min(len(test_x), _IN_CHUNK_EVAL_CAP)
            if eval_batches is None
            else min(len(test_x), eval_batches * 256)
        )
        if cap < len(test_x):
            warnings.warn(
                f"in-chunk per-round eval uses the first {cap} of "
                f"{len(test_x)} test samples (set eval_batches to raise "
                "the cap); final reported accuracy is recomputed uncapped",
                UserWarning,
                stacklevel=2,
            )
        ex_dev = torch.as_tensor(np.asarray(test_x[:cap], dtype=np.float32),
                                 device=device)
        ey_dev = torch.as_tensor(np.asarray(test_y[:cap], dtype=np.int64),
                                 device=device)

    accountant = RDPAccountant() if cfg.dp is not None else None
    # Client mode: one mechanism invocation per round at q =
    # client_fraction. Example mode: one per LOCAL step at q = B/S_pad
    # (each epoch permutes S_pad slots into S_pad/B batches); client
    # sampling is not folded into q there — a round's steps share one
    # participation draw.
    if accountant is not None and cfg.dp.mode == "example":
        acct_q = min(1.0, cfg.batch_size / cx.shape[1])
        acct_steps = cfg.local_epochs * (cx.shape[1] // cfg.batch_size)
    else:
        acct_q = cfg.client_fraction
        acct_steps = 1
    if accountant is not None and start_round > 0:
        # The rounds the checkpoint covers spent privacy too.
        accountant.step(q=acct_q, sigma=cfg.dp.noise_multiplier,
                        num_steps=start_round * acct_steps)
    # Each participating client uploads Δθ and downloads θ.
    comm_mb = 2 * trees.tree_bytes(params) / 1e6
    result = TrainResult(
        params=params, accuracies=[], losses=[], comm_mb_per_round=comm_mb,
        evaluate=evaluate_full,
    )
    if eval_every <= num_rounds:
        result.accuracies.append(evaluate(params, test_x, test_y)["accuracy"])

    def run_round(p, r):
        kw = {"draws": RoundDraws(
            seed, r, None if draws_for_round is None else draws_for_round(r))}
        if cfg.secure_agg:
            kw["sa_seed"] = round_seed(seed, r, SA_SEED_SALT)
        if perms_for_round is not None:
            return round_fn(p, dcx, dcy, dcm, perms=perms_for_round(r), **kw)
        return round_fn(p, dcx, dcy, dcm,
                        generator=round_generator(seed, r), **kw)

    def chunk_accuracy(p) -> torch.Tensor:
        with torch.inference_mode():
            logits = model.apply(p, ex_dev)
            return (torch.argmax(logits, dim=-1) == ey_dev).float().mean()

    depth = resolve_pipeline_depth(pipeline_depth)
    # In-flight chunks: (chunk_len, first_round, params_ref, stats, accs,
    # t_dispatch); params_ref is None unless the drain needs θ (host
    # eval, checkpoint, final round).
    pending: deque = deque()
    prev_fetch_end = 0.0

    def drain_one() -> None:
        nonlocal prev_fetch_end
        chunk, base_rnd, params_ref, stats, accs, t_dispatch = pending.popleft()
        # ONE fetch per chunk: the only point the loop waits on the device.
        fields = torch.stack([torch.stack([
            s.mean_loss.float(), s.rejected_updates.float(),
            s.applied.float(), s.clipped_clients.float(),
            s.trimmed_fraction.float(),
        ]) for s in stats]).cpu().numpy()
        chunk_accs = (None if accs is None
                      else torch.stack(accs).cpu().numpy())
        t_fetch_end = time.perf_counter()
        dt_per_round = (t_fetch_end - max(t_dispatch, prev_fetch_end)) / chunk
        prev_fetch_end = t_fetch_end
        for i in range(chunk):
            r = base_rnd + i
            loss, rejected, applied, clipped, trimmed = (
                float(v) for v in fields[i])
            result.round_times_s.append(dt_per_round)
            result.losses.append(loss)
            metrics = {
                "round": r + 1,
                "loss": loss,
                "time_s": dt_per_round,
                "chunk_rounds": chunk,
            }
            if guards:
                metrics["rejected_updates"] = int(round(rejected))
                if applied < 0.5:
                    metrics["skipped"] = True
            if agg != "mean":
                metrics["aggregator"] = agg
                if agg == "clip_mean":
                    metrics["clipped_clients"] = int(round(clipped))
                else:
                    metrics["trimmed_fraction"] = round(trimmed, 4)
            if accountant is not None:
                accountant.step(q=acct_q, sigma=cfg.dp.noise_multiplier,
                                num_steps=acct_steps)
                eps = accountant.epsilon(cfg.dp.delta)
                result.epsilons.append(eps)
                metrics["epsilon"] = eps
                if r == start_round and cfg.dp.mode == "example":
                    metrics["epsilon_accounting"] = (
                        "poisson-rdp at q=B/S_pad on a shuffle sampler "
                        "(Opacus/TF-privacy convention; not a strict "
                        "shuffle bound)"
                    )
            if chunk_accs is not None:
                acc = float(chunk_accs[i])
                result.accuracies.append(acc)
                metrics["accuracy"] = acc
                metrics["eval_n"] = int(ex_dev.shape[0])
            elif (r + 1) % eval_every == 0 or r == num_rounds - 1:
                eval_metrics = evaluate(params_ref, test_x, test_y)
                result.accuracies.append(eval_metrics["accuracy"])
                metrics.update(eval_metrics)
            if checkpointer is not None:
                # The final round is always saved, synchronously, after
                # the queued writes: the weights the run reports exist
                # on disk when train_federated returns.
                if r == num_rounds - 1:
                    checkpointer.wait()
                    checkpointer.save(r + 1, params_ref)
                elif depth > 0:
                    checkpointer.maybe_save_async(r + 1, params_ref)
                else:
                    checkpointer.maybe_save(r + 1, params_ref)
            if on_round_end is not None:
                on_round_end(r, metrics)

    rnd = start_round
    try:
        while rnd < num_rounds:
            until_eval = (
                num_rounds if in_chunk_eval else eval_every - (rnd % eval_every)
            )
            until_ckpt = (
                checkpointer.every - (rnd % checkpointer.every)
                if checkpointer is not None
                else rounds_per_call
            )
            chunk = min(
                rounds_per_call, until_eval, until_ckpt, num_rounds - rnd
            )
            t_dispatch = time.perf_counter()
            with_accs = chunk > 1 and rounds_per_call > 1 and in_chunk_eval
            stats, accs = [], ([] if with_accs else None)
            for i in range(chunk):
                params, st = run_round(params, rnd + i)
                stats.append(st)
                if with_accs:
                    accs.append(chunk_accuracy(params))
            # A round returns new tensors, so θ needs no snapshot here.
            pending.append((chunk, rnd, params, stats, accs, t_dispatch))
            while len(pending) > depth:
                drain_one()
            rnd += chunk
        while pending:
            drain_one()
    except BaseException as crash:
        # Drain the async writer WITHOUT raising, so the crash propagates
        # unmasked; a failed write is attached to it as a note (wait()
        # has also warned).
        if checkpointer is not None:
            try:
                werr = checkpointer.wait(raise_errors=False, timeout=60.0)
            except Exception:  # noqa: BLE001 — the unwind path stays silent
                werr = None
            if werr is not None and hasattr(crash, "add_note"):
                crash.add_note(
                    f"async checkpoint write also failed: {werr!r} — the "
                    "latest on-disk checkpoint may predate the crash round"
                )
        raise

    result.params = params
    # The in-chunk evaluation set may be capped; the final reported
    # accuracy covers the whole set.
    if ex_dev is not None and result.accuracies and ex_dev.shape[0] < len(
        test_x
    ):
        result.accuracies[-1] = evaluate_full(params, test_x, test_y)[
            "accuracy"
        ]
    return result


def _host_stats(stats) -> dict:
    """A round's ``RoundStats`` as host floats, in one device read."""
    fields = stats._fields
    vals = torch.stack([torch.as_tensor(getattr(stats, f),
                                        dtype=torch.float32).reshape(())
                        .to(stats.mean_loss.device) for f in fields])
    return dict(zip(fields, vals.cpu().tolist()))


def train_federated_streamed(
    model: Model,
    cfg: FedConfig,
    registry,
    test_x: np.ndarray,
    test_y: np.ndarray,
    *,
    cohort_size: int,
    wave_size: int | None = None,
    num_rounds: int = 30,
    seed: int = 42,
    device=None,
    eval_every: int = 1,
    eval_batches: int | None = None,
    on_round_end: Callable[[int, dict], None] | None = None,
    checkpointer=None,
    stream_depth: int | None = None,
    fault_plan=None,
    wave_deadline_s: float | None = None,
    stale_poll_s: float = 30.0,
    params=None,
    perms_for_round: Callable[[int], Any] | None = None,
    draws_for_round: Callable[[int], dict] | None = None,
) -> TrainResult:
    """Federated training over a client REGISTRY in streamed waves.

    Counterpart of the reference's ``train_federated_streamed``. Each
    round samples ``cohort_size`` clients from ``registry`` (anything
    with ``num_clients`` and ``batch(ids)``: ``data.stream.
    SyntheticRegistry``, ``ArrayRegistry``) with ``fed.sampling.
    CohortSampler``, streams them to ``device`` in waves of
    ``wave_size`` (``data.stream.WaveStream``, ``stream_depth`` /
    ``QFEDX_STREAM``), computes each wave's partial
    (``fed.round.make_fed_round_partial``) and applies their sum once
    (``make_accumulate_partial``, ``make_apply_partial``; under the
    robust rules or ``QFEDX_STALE`` the stacked ``make_apply_partials``).
    ``QFEDX_HIER=off`` runs the flat round and needs one wave.

    The round's shuffles are drawn once over the cohort from the
    resident trainer's generator of (seed, round) and sliced per wave,
    and client c's other draws are its cohort position's, so one wave
    over an ``ArrayRegistry`` equals ``train_federated`` on the same
    arrays. Participation and the secure-agg pair graph span the cohort,
    so ring masks cancel across waves.

    A wave whose fetch exhausts its retries, or (with
    ``wave_deadline_s``) hangs past the deadline, is dropped: its sampled
    clients become casualties and, under cohort-graph masks, the server
    adds their regenerated masks back (``secure_agg.
    unmatched_mask_sum``). With ``QFEDX_STALE`` a deadline-missed wave
    is a straggler instead: its upload finishes in the background, its
    partial is computed against its origin round's θ, draws, shuffles
    and mask seed, and it folds into a later round's apply at the
    staleness discount of its age, or is discarded past
    ``cfg.staleness_max_age``; ``stale_poll_s`` bounds each round's wait
    for it. Needs QFEDX_HIER and QFEDX_GUARDS.

    The DP accountant charges each round at the origin's q =
    client_fraction · cohort / registry size (example mode: E·S/B steps
    at q = B/S). ``comm_mb_per_round`` is (W + 1)·|θ|. A
    ``KeyboardInterrupt`` (from ``on_round_end`` or Ctrl-C) closes the
    streams, drains the checkpoint writer and saves the last completed
    round synchronously before it propagates; a SIGTERM is translated
    into that ``KeyboardInterrupt`` for the run (``utils/host``).

    ``fault_plan`` (or the plan ``QFEDX_FAULTS`` pins; ``utils/
    faults``) injects the reference's faults: each round, before any
    wave dispatches, its ``survivors`` (dropped clients) and
    ``byzantine_attack`` (scale, sign flip, noise) reach every wave's
    partial and a straggler's origin record; the stream poisons
    ``nan``/``inf`` clients, flips ``label_flip`` clients' labels,
    injects fetch/H2D errors and planned delays. The rows'
    ``dropped_clients``, ``rejected_updates``, ``clipped_clients`` and
    ``participants`` then equal the plan's counts (plus lost waves'
    casualties). A plan needs QFEDX_GUARDS. The obs spans and the
    /metrics endpoint are not ported yet (item 14). ``params=``,
    ``perms_for_round=`` (the round's
    (cohort, E, S) shuffles) and ``draws_for_round=`` (its ``RoundDraws``
    streams over the cohort) exist for the parity tests."""
    from qfedx_tpu_torch.data.stream import DroppedWave, LateWave, WaveStream
    from qfedx_tpu_torch.fed.client import draw_perms
    from qfedx_tpu_torch.fed.round import (
        RoundStats,
        hier_enabled,
        make_accumulate_partial,
        make_apply_partial,
        make_apply_partials,
        make_fed_round_partial,
        stack_partials,
        stale_enabled,
    )
    from qfedx_tpu_torch.fed.robust import ROBUST_AGGREGATORS
    from qfedx_tpu_torch.fed.sampling import CohortSampler
    from qfedx_tpu_torch.fed.secure_agg import unmatched_mask_sum
    from qfedx_tpu_torch.utils import faults
    from qfedx_tpu_torch.utils.host import (
        install_sigterm_interrupt,
        restore_sigterm,
    )

    wave_size = cohort_size if wave_size is None else int(wave_size)
    if cohort_size % wave_size != 0:
        raise ValueError(
            f"cohort_size={cohort_size} not divisible by wave_size={wave_size}"
        )
    num_waves = cohort_size // wave_size
    hier = hier_enabled()
    if not hier and num_waves > 1:
        raise ValueError(
            "QFEDX_HIER=off forces the flat one-program round, which "
            f"needs the whole cohort in one wave (waves={num_waves})"
        )
    plan = faults.resolve_plan(fault_plan)
    guards = guards_enabled()
    if plan is not None and not guards:
        raise ValueError(
            "a fault plan is active (QFEDX_FAULTS / fault_plan) but "
            "QFEDX_GUARDS=off built the unguarded round program — "
            "injected casualties would corrupt θ instead of exercising "
            "the recovery path"
        )
    agg = resolve_aggregator(cfg)
    robust = agg in ROBUST_AGGREGATORS
    if robust and cfg.secure_agg and num_waves < 2:
        raise ValueError(
            f"aggregator={agg!r} under secure_agg defends at the WAVE "
            f"level (per-wave pair graphs) and needs >= 2 waves; with "
            f"waves={num_waves} it would silently degenerate to plain "
            "masked mean — split the cohort or use clip_mean"
        )
    stale = stale_enabled()
    if stale and not hier:
        raise ValueError(
            "QFEDX_STALE needs the hierarchical round (QFEDX_HIER=on): "
            "staleness buffering parks per-wave RoundPartials, which "
            "the flat one-program round does not produce"
        )
    if stale and not guards:
        raise ValueError(
            "QFEDX_STALE needs QFEDX_GUARDS=on: a straggler wave that "
            "dies for good degrades to survivor-mask dropouts, which "
            "the unguarded round program cannot express"
        )
    if stale and wave_deadline_s is None:
        warnings.warn(
            "QFEDX_STALE is on but wave_deadline_s is None: no wave "
            "can be classified late, so staleness buffering is inert "
            "— pass wave_deadline_s to salvage stragglers",
            UserWarning,
            stacklevel=2,
        )

    sampler = CohortSampler(registry_size=registry.num_clients,
                            cohort_size=cohort_size, seed=seed)
    partial_fn = accum_fn = apply_fn = apply_stacked_fn = round_fn = None
    if hier:
        partial_fn = make_fed_round_partial(model, cfg, wave_size,
                                            cohort_clients=cohort_size)
        if robust or stale:
            apply_stacked_fn = make_apply_partials(cfg, cohort_size)
        if not robust:
            # Under QFEDX_STALE a straggler-free round takes this exact
            # sequential accumulate + apply, so the pin changes nothing
            # until a wave is late.
            accum_fn = make_accumulate_partial()
            apply_fn = make_apply_partial(cfg, cohort_size)
    else:
        round_fn = make_fed_round(model, cfg, num_clients=cohort_size)

    evaluate = make_evaluator(model, max_batches=eval_batches)
    evaluate_full = make_evaluator(model)
    if params is None:
        params = model.init(seed)
    if device is not None:
        params = trees.tree_map(lambda t: t.to(pins.resolve_device(device)),
                                params)
    start_round = 0
    if checkpointer is not None:
        restored = checkpointer.restore_latest(params)
        if restored is not None:
            params, start_round = restored
    device = trees.tree_leaves(params)[0].device
    s_pad = registry.batch(np.arange(1))[0].shape[1]

    accountant = RDPAccountant() if cfg.dp is not None else None
    if accountant is not None and cfg.dp.mode == "example":
        acct_q = min(1.0, cfg.batch_size / s_pad)
        acct_steps = cfg.local_epochs * (s_pad // cfg.batch_size)
    else:
        # Client mode: the registry → cohort draw and the participation
        # draw both select a client, so q is over the registry.
        acct_q = cfg.client_fraction * (cohort_size / registry.num_clients)
        acct_steps = 1
    if accountant is not None and start_round > 0:
        accountant.step(q=acct_q, sigma=cfg.dp.noise_multiplier,
                        num_steps=start_round * acct_steps)
    # Each wave uplinks one partial of |θ|, and θ goes down once.
    comm_mb = (num_waves + 1) * trees.tree_bytes(params) / 1e6
    result = TrainResult(
        params=params, accuracies=[], losses=[], comm_mb_per_round=comm_mb,
        evaluate=evaluate_full,
    )
    if eval_every <= num_rounds:
        result.accuracies.append(evaluate(params, test_x, test_y)["accuracy"])

    def origin(rnd: int, cohort_ids: np.ndarray) -> dict:
        """Everything a wave of round ``rnd`` is computed against besides
        θ: the draws, the cohort's shuffles, the mask seed and the plan's
        survivors (None when all survive) and attack (None when all are
        honest), decided before any wave dispatches."""
        given = None if draws_for_round is None else draws_for_round(rnd)
        perms = (perms_for_round(rnd) if perms_for_round is not None
                 else draw_perms(round_generator(seed, rnd), cohort_size,
                                 cfg.local_epochs, s_pad))
        surv = byz = None
        if plan is not None:
            s_np = plan.survivors(rnd, cohort_ids)
            if not np.all(s_np == 1.0):
                surv = s_np
            byz = plan.byzantine_attack(rnd, cohort_ids)
        return dict(draws=RoundDraws(seed, rnd, given),
                    perms=torch.as_tensor(perms, dtype=torch.int64),
                    sa_seed=(round_seed(seed, rnd, SA_SEED_SALT)
                             if cfg.secure_agg else None),
                    surv=surv, byz=byz)

    def participation(o: dict) -> np.ndarray:
        if cfg.client_fraction >= 1.0:
            return np.ones(cohort_size, np.float32)
        return o["draws"].participation(cohort_size, cfg.client_fraction)

    def wave_partial(p, o: dict, lo: int, wx, wy, wm):
        return partial_fn(p, wx, wy, wm, lo,
                          perms=o["perms"][lo:lo + wave_size],
                          survivors=o["surv"], byzantine=o["byz"],
                          sa_seed=o["sa_seed"], draws=o["draws"])

    def zero() -> torch.Tensor:
        return torch.zeros((), dtype=torch.float32, device=device)

    # Streams of earlier rounds whose late waves are still uploading,
    # each with its origin round's θ and derivation.
    pending_late: list = []
    last_done, last_params = start_round, params
    sigterm_token = install_sigterm_interrupt()
    try:
        for rnd in range(start_round, num_rounds):
            t0 = time.perf_counter()
            cohort_ids = sampler.round_ids(rnd)
            o = origin(rnd, cohort_ids)
            # θ this round's waves train against, and the origin θ of its
            # stragglers; rounds make new tensors, so it stays intact.
            params_in = params
            stream = WaveStream(
                registry, device, cohort_ids, wave_size, depth=stream_depth,
                fault_plan=plan, round_idx=rnd,
                on_wave_error=("buffer" if stale else
                               "drop" if guards else "raise"),
                wave_deadline_s=wave_deadline_s,
            )
            lost: list = []
            late: list = []
            stale_parts: list = []  # (origin round, partial) folding in now
            host_extra_dropped = 0.0  # casualties no partial carries
            stale_discarded = 0
            try:
                acc = None
                parts: list = []
                stats = None
                for item in stream:
                    if isinstance(item, DroppedWave):
                        lost.append(item)
                        continue
                    if isinstance(item, LateWave):
                        late.append(item)
                        continue
                    lo, (wx, wy, wm) = item
                    if hier:
                        part = wave_partial(params, o, lo, wx, wy, wm)
                        if robust or stale:
                            parts.append(part)
                        else:
                            acc = part if acc is None else accum_fn(acc, part)
                    else:
                        params, stats = round_fn(
                            params, wx, wy, wm, perms=o["perms"],
                            survivors=o["surv"], byzantine=o["byz"],
                            sa_seed=o["sa_seed"], draws=o["draws"])
                if stale and pending_late:
                    # Stragglers of earlier rounds, each computed against
                    # its origin round; one salvage deadline for all.
                    still_pending = []
                    poll_deadline = time.monotonic() + stale_poll_s
                    for pl in pending_late:
                        age = rnd - pl["round"]
                        items, failed = pl["stream"].poll_late(
                            timeout_s=max(0.0,
                                          poll_deadline - time.monotonic()))
                        for lo, (lwx, lwy, lwm) in items:
                            stale_parts.append((pl["round"], wave_partial(
                                pl["params"], pl["origin"], lo, lwx, lwy,
                                lwm)))
                        dead_waves = list(failed)
                        keep = pl["stream"].late_pending()
                        if keep and age >= cfg.staleness_max_age:
                            dead_waves += pl["stream"].abandon_late()
                            keep = False
                        if dead_waves:
                            # A dead straggler's sampled clients: no
                            # partial ever counted them.
                            p_np = participation(pl["origin"])
                            for w in dead_waves:
                                host_extra_dropped += float(p_np[
                                    w * wave_size:(w + 1) * wave_size].sum())
                            stale_discarded += len(dead_waves)
                        if keep:
                            still_pending.append(pl)
                        else:
                            pl["stream"].close()
                    pending_late[:] = still_pending
                if lost:
                    # Fetch-dead waves: their sampled clients are
                    # casualties (the plan's dropped ones too: no
                    # dispatched partial counted them); under cohort-graph
                    # masks the server adds the masks of the survivors
                    # among them back.
                    dead = np.zeros(cohort_size, dtype=np.float32)
                    for dw in lost:
                        dead[dw.wave_base:dw.wave_base + wave_size] = 1.0
                    part_np = participation(o)
                    eff_pre = (part_np if o["surv"] is None
                               else part_np * o["surv"])
                    n_lost = float((part_np * dead).sum())
                    if stale:
                        # Per-wave graphs: nothing to correct.
                        host_extra_dropped += n_lost
                    else:
                        if acc is not None and cfg.secure_agg:
                            corr = unmatched_mask_sum(
                                o["sa_seed"], cohort_size,
                                trees.tree_map(torch.zeros_like, params),
                                eff_pre, eff_pre * (1.0 - dead),
                                cfg.secure_agg_scale,
                                cfg.secure_agg_neighbors,
                                cfg.secure_agg_mode,
                            )
                            acc = acc._replace(update_sum=trees.tree_add(
                                acc.update_sum, corr))
                        if acc is not None:
                            acc = acc._replace(
                                dropped_clients=acc.dropped_clients + n_lost)
                        elif parts:
                            parts[-1] = parts[-1]._replace(
                                dropped_clients=parts[-1].dropped_clients
                                + n_lost)
                if hier and stale:
                    if stale_parts:
                        ages = np.asarray(
                            [0.0] * len(parts)
                            + [float(rnd - og) for og, _ in stale_parts],
                            np.float32)
                        params, stats = apply_stacked_fn(
                            params, stack_partials(
                                parts + [sp for _, sp in stale_parts]),
                            ages=ages)
                    elif robust and parts:
                        params, stats = apply_stacked_fn(
                            params, stack_partials(parts))
                    elif parts:
                        acc = parts[0]
                        for extra in parts[1:]:
                            acc = accum_fn(acc, extra)
                        params, stats = apply_fn(params, acc)
                elif hier and robust and parts:
                    params, stats = apply_stacked_fn(params,
                                                     stack_partials(parts))
                elif hier and acc is not None:
                    params, stats = apply_fn(params, acc)
                if stats is None:
                    # Every wave died (or went late): θ passes through,
                    # the skipped-round shape.
                    n_lost = 0.0 if (stale or not lost) else n_lost
                    stats = RoundStats(
                        mean_loss=zero(), total_weight=zero(),
                        num_participants=zero(), rejected_updates=zero(),
                        dropped_clients=zero() + n_lost, applied=zero(),
                        clipped_clients=zero(), trimmed_fraction=zero())
            finally:
                if stale and stream.late_pending():
                    # Straggler salvage in flight: later rounds collect or
                    # abandon it; the outer finally closes it on a crash.
                    pending_late.append(dict(round=rnd, stream=stream,
                                             params=params_in, origin=o))
                else:
                    stream.close()
            st = _host_stats(stats)
            dt = time.perf_counter() - t0

            loss = st["mean_loss"]
            result.round_times_s.append(dt)
            result.losses.append(loss)
            metrics = {
                "round": rnd + 1,
                "loss": loss,
                "time_s": dt,
                "cohort": cohort_size,
                "waves": num_waves,
                "participants": int(st["num_participants"]),
            }
            if guards:
                metrics["dropped_clients"] = int(round(
                    st["dropped_clients"] + host_extra_dropped))
                metrics["rejected_updates"] = int(round(
                    st["rejected_updates"]))
                if lost:
                    metrics["dropped_waves"] = len(lost)
                if st["applied"] < 0.5:
                    metrics["skipped"] = True
            if stale:
                metrics["late_waves"] = len(late)
                metrics["stale_partials_applied"] = len(stale_parts)
                if stale_discarded:
                    metrics["stale_discarded_waves"] = stale_discarded
            if agg != "mean":
                metrics["aggregator"] = agg
                if agg == "clip_mean":
                    metrics["clipped_clients"] = int(round(
                        st["clipped_clients"]))
                else:
                    metrics["trimmed_fraction"] = round(
                        st["trimmed_fraction"], 4)
            if accountant is not None:
                accountant.step(q=acct_q, sigma=cfg.dp.noise_multiplier,
                                num_steps=acct_steps)
                eps = accountant.epsilon(cfg.dp.delta)
                result.epsilons.append(eps)
                metrics["epsilon"] = eps
            if (rnd + 1) % eval_every == 0 or rnd == num_rounds - 1:
                eval_metrics = evaluate(params, test_x, test_y)
                result.accuracies.append(eval_metrics["accuracy"])
                metrics.update(eval_metrics)
            if checkpointer is not None:
                if rnd == num_rounds - 1:
                    checkpointer.wait()
                    checkpointer.save(rnd + 1, params)
                else:
                    checkpointer.maybe_save_async(rnd + 1, params)
            if on_round_end is not None:
                on_round_end(rnd, metrics)
            last_done, last_params = rnd + 1, params
    except (KeyboardInterrupt, SystemExit):
        # Drain, persist, re-raise: the last completed round is saved
        # synchronously unless a timed-out writer is still busy (two
        # writers on one file set could validate a torn checkpoint).
        if checkpointer is not None:
            try:
                checkpointer.wait(raise_errors=False, timeout=30.0)
                if last_done > start_round and not checkpointer.busy():
                    checkpointer.save(last_done, last_params)
            except Exception:  # noqa: BLE001 — the unwind path stays silent
                pass
        raise
    finally:
        for pl in pending_late:
            try:
                pl["stream"].close()
            except Exception:  # noqa: BLE001 — best-effort unwind
                pass
        pending_late.clear()
        restore_sigterm(sigterm_token)
    result.params = params
    return result
