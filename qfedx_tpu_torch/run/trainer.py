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
Queue 1 item 12) and ``train_federated_streamed`` (item 9) raise
NotImplementedError.
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


def _round_generator(seed: int, round_idx: int) -> torch.Generator:
    """The shuffles' generator of round ``round_idx``: a function of
    (seed, round) alone."""
    state = np.random.SeedSequence([seed, round_idx]).generate_state(1)[0]
    return torch.Generator().manual_seed(int(state))


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
                        generator=_round_generator(seed, r), **kw)

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


def train_federated_streamed(*args, **kwargs) -> TrainResult:
    """Training over a client registry in streamed waves: not ported
    yet (ROADMAP Queue 1 item 9)."""
    raise NotImplementedError(
        "train_federated_streamed is not ported yet (ROADMAP Queue 1 item 9)"
    )
