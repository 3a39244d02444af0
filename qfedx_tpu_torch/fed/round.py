"""The federated round on one device.

Counterpart of ``qfedx_tpu/fed/round.py``'s ``make_fed_round`` with one
client block and no mesh: the cohort's C clients train FOLDED into one
engine batch (``fed/client.make_local_update_clients``), then each
client's update is post-processed — the non-finite quarantine under
guards (the default program), weight = n × participation × finite — and
the weighted sum is applied, θ_new = θ + Σ wΔ / Σ w
(``_finalize_partial``, with the ``min_participation`` identity).
With ``secure_agg`` each client's weighted contribution carries its
ring or pairwise mask (``fed/secure_agg.py``), drawn over the round's
effective participants from the round's secure-agg seed; a quarantined
client's masks stay in the sum, so the masks cancel exactly.

Not ported yet, each raising NotImplementedError: DP, the robust
aggregators and a finite ``clip_bound`` (secure aggregation with a
robust rule raises ValueError, as in the reference), byzantine inputs,
client sampling below 1, the vmap (unfolded) client path, and more than
one device (the mesh, waves and partial rounds).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from qfedx_tpu_torch.fed.client import make_local_update_clients
from qfedx_tpu_torch.fed.config import FedConfig
from qfedx_tpu_torch.fed.sampling import participation_mask
from qfedx_tpu_torch.fed.secure_agg import cohort_masks
from qfedx_tpu_torch.models.api import Model
from qfedx_tpu_torch.utils import pins, trees

AGGREGATORS = ("mean", "clip_mean", "trimmed_mean", "median")
ROBUST_AGGREGATORS = ("trimmed_mean", "median")

# Salt of the per-round secure-agg seed (the reference's SA_KEY_SALT).
SA_SEED_SALT = 0x5EC


class RoundStats(NamedTuple):
    mean_loss: torch.Tensor  # participation-weighted mean local loss
    total_weight: torch.Tensor  # Σ aggregation weights (0 ⇒ no-op round)
    num_participants: torch.Tensor  # sampled ∧ surviving ∧ finite
    rejected_updates: torch.Tensor  # non-finite Δθ quarantined
    dropped_clients: torch.Tensor  # sampled but dropped (survivors = 0)
    applied: torch.Tensor  # 0 ⇒ round skipped (min_participation)
    clipped_clients: torch.Tensor  # clip_mean norm hits (always 0 here)
    trimmed_fraction: torch.Tensor  # robust-rule exclusions (always 0)


class RoundPartial(NamedTuple):
    """The round's weighted delta sum and counts, before the apply."""

    update_sum: dict
    weight_sum: torch.Tensor
    loss_sum: torch.Tensor
    num_participants: torch.Tensor
    rejected_updates: torch.Tensor
    dropped_clients: torch.Tensor


def guards_enabled() -> bool:
    """Build the fault-tolerant round (survivor mask, non-finite
    quarantine, casualty counts)? ``QFEDX_GUARDS`` pins; default on."""
    return pins.bool_pin("QFEDX_GUARDS", True)


def fold_clients_enabled(model: Model, cfg: FedConfig) -> bool:
    """Fold the client axis into the engine batch? Eligible when the
    model has ``apply_clients`` and the config stays on the plain
    gradient route (no SPSA, no per-example DP); ``QFEDX_FOLD_CLIENTS``
    pins the choice for eligible configs."""
    eligible = (
        model.apply_clients is not None
        and model.apply_train is None
        and cfg.optimizer != "spsa"
        and not (cfg.dp is not None and cfg.dp.mode == "example")
    )
    pinned = pins.bool_pin("QFEDX_FOLD_CLIENTS", True)
    return eligible and pinned


def resolve_aggregator(cfg: FedConfig) -> str:
    """``QFEDX_AGG`` overrides ``cfg.aggregator``."""
    env = pins.choice_pin("QFEDX_AGG", AGGREGATORS, None)
    return cfg.aggregator if env is None else env


def _finalize_partial(params: dict, partial: RoundPartial,
                      min_participants: float = 0.0):
    """θ_new = θ + Σ wΔ / Σ w. With ``min_participants`` > 0, fewer
    surviving participants make the apply the identity (stats.applied
    0)."""
    denom = torch.clamp(partial.weight_sum, min=1e-12)
    zero = torch.zeros((), dtype=torch.float32, device=denom.device)
    if min_participants > 0:
        ok = partial.num_participants >= min_participants
        new_params = trees.tree_map(
            lambda p, u: torch.where(ok, (p + u / denom).to(p.dtype), p),
            params, partial.update_sum,
        )
        applied = ok.float()
    else:
        new_params = trees.tree_map(
            lambda p, u: (p + u / denom).to(p.dtype),
            params, partial.update_sum,
        )
        applied = torch.ones((), dtype=torch.float32, device=denom.device)
    stats = RoundStats(
        mean_loss=partial.loss_sum / denom,
        total_weight=partial.weight_sum,
        num_participants=partial.num_participants,
        rejected_updates=partial.rejected_updates,
        dropped_clients=partial.dropped_clients,
        applied=applied,
        clipped_clients=zero,
        trimmed_fraction=zero,
    )
    return new_params, stats


def _per_client(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(C,) → (C, 1, …) broadcasting against a (C, …) leaf."""
    return v.reshape((-1,) + (1,) * (like.ndim - 1))


def make_fed_round(model: Model, cfg: FedConfig, num_clients: int,
                   num_devices: int = 1):
    """Build ``round_fn(params, cx, cy, cmask, generator=None,
    perms=None, survivors=None, byzantine=None, sa_seed=None) ->
    (params, stats)``.

    ``cx/cy/cmask``: packed client data [C, S, ...] on the parameters'
    device; ``generator``/``perms`` give the local shuffles
    (``fed/client``). With guards on, ``survivors`` [C] 0/1 excludes
    mid-round casualties from the aggregate and from the secure-agg pair
    graph (the round then equals the survivor-only round); with guards
    off it must be None. ``sa_seed``: the round's secure-agg seed
    (``run/trainer.py`` derives one per round), required with
    ``cfg.secure_agg``."""
    if num_devices != 1:
        raise NotImplementedError(
            "the port's round runs on one device; the multi-device mesh is "
            "not ported yet"
        )
    agg = resolve_aggregator(cfg)
    if agg in ROBUST_AGGREGATORS and cfg.secure_agg:
        raise ValueError(
            f"aggregator={agg!r} needs per-client visibility, which "
            "secure_agg masks remove on the flat one-program round — "
            "it would silently degenerate to plain masked mean. Use "
            "secure_agg=False; clip_mean composes with masking."
        )
    if cfg.dp is not None:
        raise NotImplementedError("DP is not ported yet")
    if agg not in ("mean", "clip_mean"):
        raise NotImplementedError(f"aggregator={agg!r} is not ported yet")
    if agg == "clip_mean" and math.isfinite(cfg.clip_bound):
        raise NotImplementedError("a finite clip_bound is not ported yet")
    if not fold_clients_enabled(model, cfg):
        raise NotImplementedError(
            "the vmap (unfolded) client path is not ported yet; the round "
            "needs the folded path (model.apply_clients, QFEDX_FOLD_CLIENTS "
            "on, no SPSA or per-example DP)"
        )
    guards = guards_enabled()
    min_count = cfg.min_participation * num_clients
    local_update_c = make_local_update_clients(model, cfg)

    def round_fn(params, cx, cy, cmask, generator=None, perms=None,
                 survivors=None, byzantine=None, sa_seed=None):
        if byzantine is not None:
            raise NotImplementedError("byzantine inputs are not ported yet")
        if survivors is not None and not guards:
            raise ValueError(
                "survivors requires the guarded round program "
                "(QFEDX_GUARDS=off builds the round without a survivor "
                "input)"
            )
        if cx.shape[0] != num_clients:
            raise ValueError(f"cx holds {cx.shape[0]} clients, the round "
                             f"was built for {num_clients}")
        device = trees.tree_leaves(params)[0].device
        part = participation_mask(num_clients, cfg.client_fraction, device)
        if cfg.secure_agg and sa_seed is None:
            raise ValueError("secure_agg needs the round's sa_seed")
        eff = part
        if survivors is not None:
            eff = part * torch.as_tensor(survivors, dtype=torch.float32,
                                         device=device)
        deltas, ns, losses = local_update_c(
            params, cx, cy, cmask, generator=generator, perms=perms
        )
        with torch.no_grad():
            weight = ns * eff
            if guards:
                # Non-finite quarantine before anything consumes Δθ: a
                # NaN/Inf update is zeroed (where, not multiply — NaN·0
                # is NaN), its loss excluded and its weight 0.
                fin = torch.isfinite(losses)
                for leaf in trees.tree_leaves(deltas):
                    fin = fin & torch.isfinite(leaf).reshape(
                        leaf.shape[0], -1).all(dim=1)
                deltas = trees.tree_map(
                    lambda d: torch.where(_per_client(fin, d), d,
                                          torch.zeros_like(d)),
                    deltas,
                )
                losses = torch.where(fin, losses, torch.zeros_like(losses))
                finf = fin.float()
                weight = weight * finf
                n_part = torch.sum(eff * finf)
                rejected = torch.sum(eff * (1.0 - finf))
                dropped = torch.sum(part - eff)
            else:
                n_part = torch.sum(part)
                rejected = dropped = torch.zeros((), device=device)
            contrib = trees.tree_map(
                lambda d: d * _per_client(weight, d), deltas)
            if cfg.secure_agg:
                # The pair graph runs over the effective participants
                # (sampled ∧ surviving; participation_mask is all ones at
                # the one fraction the port samples): a quarantined
                # client's masks stay in the sum, so they cancel.
                sa_part = (np.ones(num_clients, np.float32)
                           if survivors is None else
                           np.asarray(torch.as_tensor(survivors).cpu(),
                                      dtype=np.float32))
                masks = cohort_masks(
                    sa_seed, contrib, sa_part, cfg.secure_agg_scale,
                    cfg.secure_agg_mode, cfg.secure_agg_neighbors,
                )
                contrib = trees.tree_add(contrib, masks)
            partial = RoundPartial(
                update_sum=trees.tree_map(
                    lambda c: torch.sum(c, dim=0), contrib),
                weight_sum=torch.sum(weight),
                loss_sum=torch.sum(weight * losses),
                num_participants=n_part,
                rejected_updates=rejected,
                dropped_clients=dropped,
            )
            return _finalize_partial(params, partial, min_count)

    return round_fn
