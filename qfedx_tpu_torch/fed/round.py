"""The federated round on one device.

Counterpart of ``qfedx_tpu/fed/round.py``'s ``make_fed_round`` with one
client block and no mesh. The cohort's C clients train FOLDED into one
engine batch (``fed/client.make_local_update_clients``; with
``QFEDX_FOLD_CLIENTS=0``, a model without ``apply_clients`` (the MPS
classifier) or one with ``apply_train`` (the TinyCNN's dropout, the
noisy VQC's shots and trajectories), one client at a time,
``make_local_update``). Then each client's update is
post-processed in the reference's order:

1. a ``byzantine`` attack: the delta times its multiplier, then
   replaced by σ·N(0, I) where σ > 0;
2. the non-finite quarantine (guards on, the default program);
3. client-mode DP: clip to C, add N(0, σ²C²I) (``fed/privacy.py``);
4. the weight: the sample count, or ``min(n, 1)`` under DP or a robust
   rule;
5. ``clip_mean``'s ℓ2 bound, counting clipped clients whose weight is
   > 0;
6. the weight times the effective participation (sampled ∧ surviving)
   and the finite flag;
7. the secure-agg mask (ring or pairwise, ``fed/secure_agg.py``), drawn
   over the effective participants; a quarantined client's masks stay
   in the sum, so the masks cancel.

The aggregate is the weighted sum, or under ``trimmed_mean``/``median``
the coordinate-wise combine over the live clients (``fed/robust.py``)
times their count, so ``_finalize_partial`` applies θ_new = θ + Σ wΔ /
Σ w either way (with the ``min_participation`` identity).

The random draws beyond the shuffles and masks (participation below
fraction 1, DP noise, SPSA's Δ, the byzantine noise, and the draws of
``apply_train``: the dropout keep masks, the shot uniforms and the Kraus
branch draws) come from ``RoundDraws``. A robust rule with secure
aggregation raises ValueError, as in the reference. More than one device
(the mesh, waves and partial rounds) is not ported yet.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from qfedx_tpu_torch.fed.client import (
    make_local_update,
    make_local_update_clients,
    resolve_perms,
)
from qfedx_tpu_torch.fed.config import FedConfig
from qfedx_tpu_torch.fed.privacy import privatize
from qfedx_tpu_torch.fed.robust import (
    ROBUST_AGGREGATORS,
    clip_update,
    resolve_aggregator,
    robust_combine,
    trimmed_fraction_stat,
)
from qfedx_tpu_torch.fed.sampling import participation_mask
from qfedx_tpu_torch.fed.secure_agg import cohort_masks
from qfedx_tpu_torch.models.api import Model
from qfedx_tpu_torch.utils import pins, trees

# Salts of the round's seeded streams: the secure-agg seed (the
# reference's SA_KEY_SALT), and the draws of ``RoundDraws``, each the
# salt the reference folds into its key for the same stream.
SA_SEED_SALT = 0x5EC
DP_SEED_SALT = 0xD9
PARTICIPATION_SEED_SALT = 0x5A3D
BYZ_SEED_SALT = 0xBAD
SPSA_SEED_SALT = 0x59A
EXAMPLE_SEED_SALT = 0xDE5
# The reference has no salts for the draws of ``apply_train`` (its keys
# come from the client's train key, split per epoch, step and sample);
# these are the port's own.
DROPOUT_SEED_SALT = 0xD20
SHOT_SEED_SALT = 0x5407
BRANCH_SEED_SALT = 0xB4A
_TRAIN_DRAW_SALTS = {"dropout_keep": DROPOUT_SEED_SALT,
                     "shot_uniform": SHOT_SEED_SALT,
                     "branch_gumbel": BRANCH_SEED_SALT}


class RoundDraws:
    """The random draws of round ``round_idx`` beyond the shuffles and
    the secure-agg masks. Each stream comes from a CPU
    ``torch.Generator`` seeded from (seed, round, salt[, client]) through
    ``np.random.SeedSequence`` — stateless in the round, so a resumed run
    draws the same — and moves to the parameters' device, so the card
    and the CPU draw the same numbers. A stream named in ``given`` is
    taken from there instead (the parity tests inject the arrays the
    reference drew):

    - ``participation``: [C] 0/1, Bernoulli(client_fraction);
    - ``dp_noise``: client-mode N(0, I), leaves (C, *leaf);
    - ``byzantine_noise``: the attack's N(0, I), leaves (C, *leaf);
    - ``example_noise``: per-example DP's N(0, I) per local step, leaves
      (C, E·S/B, *leaf);
    - ``spsa_delta``: SPSA's Rademacher Δ per local step, leaves
      (C, E·S/B, *leaf);
    - the ``train_draws`` of a model with ``apply_train`` (its
      ``models.api.StepDraw`` specs), each (C, E·S/B, B, *spec.shape):
      ``dropout_keep`` (the TinyCNN's keep masks, bools),
      ``shot_uniform`` (the VQC's finite-shot uniforms, f64) and
      ``branch_gumbel`` (the VQC's Kraus branch draws, f32), each stream
      with its own salt.
    """

    STREAMS = ("participation", "dp_noise", "byzantine_noise",
               "example_noise", "spsa_delta", *_TRAIN_DRAW_SALTS)

    def __init__(self, seed: int, round_idx: int, given: dict | None = None):
        unknown = set(given or {}) - set(self.STREAMS)
        if unknown:
            raise ValueError(f"unknown streams {sorted(unknown)}; expected "
                             f"a subset of {self.STREAMS}")
        self.seed, self.round_idx = int(seed), int(round_idx)
        self.given = dict(given or {})

    def _generator(self, salt: int, *rest: int) -> torch.Generator:
        state = np.random.SeedSequence(
            [self.seed, self.round_idx, salt, *rest]).generate_state(1)[0]
        return torch.Generator().manual_seed(int(state))

    def participation(self, num_clients: int, fraction: float) -> np.ndarray:
        if "participation" in self.given:
            return np.asarray(self.given["participation"], np.float32)
        return participation_mask(
            num_clients, fraction,
            self._generator(PARTICIPATION_SEED_SALT)).numpy()

    def train_draws(self, specs, clients: int, steps: int, batch: int,
                    device) -> dict:
        """The streams of ``specs`` (``models.api.StepDraw``) on
        ``device``: client c's (steps, batch, *spec.shape) draws from its
        own generator — "keep" uniforms below ``spec.prob``, "uniform"
        f64 uniforms, "gumbel" −log(−log u) of f32 uniforms floored at
        the smallest normal."""
        out = {}
        for spec in specs:
            if spec.stream in self.given:
                dtype = {"keep": bool, "uniform": np.float64}.get(
                    spec.kind, np.float32)
                out[spec.stream] = torch.as_tensor(
                    np.asarray(self.given[spec.stream], dtype),
                    device=device)
                continue
            shape = (steps, batch) + tuple(spec.shape)
            per_client = []
            for c in range(clients):
                gen = self._generator(_TRAIN_DRAW_SALTS[spec.stream], c)
                if spec.kind == "keep":
                    draw = torch.rand(shape, generator=gen) < spec.prob
                elif spec.kind == "uniform":
                    draw = torch.rand(shape, generator=gen,
                                      dtype=torch.float64)
                elif spec.kind == "gumbel":
                    u = torch.clamp(torch.rand(shape, generator=gen),
                                    min=torch.finfo(torch.float32).tiny)
                    draw = -torch.log(-torch.log(u))
                else:
                    raise ValueError(f"unknown draw kind {spec.kind!r}")
                per_client.append(draw)
            out[spec.stream] = torch.stack(per_client).to(device)
        return out

    def tree(self, name: str, like, clients: int, steps: int | None = None):
        """Stream ``name`` as a tree shaped like ``like`` with (C[, steps])
        leading axes, on ``like``'s device: client c's leaves, in
        ``trees.tree_leaves`` order, from its own generator."""
        device = trees.tree_leaves(like)[0].device
        if name in self.given:
            return trees.tree_map(
                lambda g, _: torch.as_tensor(np.asarray(g, np.float32),
                                             device=device),
                self.given[name], like)
        salt = {"dp_noise": DP_SEED_SALT, "byzantine_noise": BYZ_SEED_SALT,
                "example_noise": EXAMPLE_SEED_SALT,
                "spsa_delta": SPSA_SEED_SALT}[name]
        lead = () if steps is None else (steps,)
        per_client = []
        for c in range(clients):
            gen = self._generator(salt, c)
            if name == "spsa_delta":
                draw = lambda x: (torch.randint(  # noqa: E731
                    0, 2, lead + tuple(x.shape), generator=gen) * 2 - 1
                ).to(torch.float32)
            else:
                draw = lambda x: torch.randn(  # noqa: E731
                    lead + tuple(x.shape), generator=gen)
            per_client.append([draw(x) for x in trees.tree_leaves(like)])
        stacked = [torch.stack(c).to(device) for c in zip(*per_client)]
        it = iter(stacked)
        return trees.tree_map(lambda _: next(it), like)


class RoundStats(NamedTuple):
    mean_loss: torch.Tensor  # participation-weighted mean local loss
    total_weight: torch.Tensor  # Σ aggregation weights (0 ⇒ no-op round)
    num_participants: torch.Tensor  # sampled ∧ surviving ∧ finite
    rejected_updates: torch.Tensor  # non-finite Δθ quarantined
    dropped_clients: torch.Tensor  # sampled but dropped (survivors = 0)
    applied: torch.Tensor  # 0 ⇒ round skipped (min_participation)
    clipped_clients: torch.Tensor  # clip_mean norm hits
    trimmed_fraction: torch.Tensor  # robust-rule exclusions


class RoundPartial(NamedTuple):
    """The round's weighted delta sum and counts, before the apply."""

    update_sum: dict
    weight_sum: torch.Tensor
    loss_sum: torch.Tensor
    num_participants: torch.Tensor
    rejected_updates: torch.Tensor
    dropped_clients: torch.Tensor
    clipped_clients: torch.Tensor


def guards_enabled() -> bool:
    """Build the fault-tolerant round (survivor mask, non-finite
    quarantine, casualty counts)? ``QFEDX_GUARDS`` pins; default on."""
    return pins.bool_pin("QFEDX_GUARDS", True)


def fold_clients_enabled(model: Model, cfg: FedConfig) -> bool:
    """Fold the client axis into the engine batch? Eligible when the
    model has ``apply_clients`` and no stochastic ``apply_train``, so the
    TinyCNN (dropout), the VQC under shots or circuit-level noise and the
    MPS classifier (no ``apply_clients``) train one client at a time, as
    in the reference, and the VQC otherwise and the kernel head fold;
    SPSA and per-example DP fold too (their random
    trees come from outside, unlike the reference's, which keeps them on
    its vmap path).
    ``QFEDX_FOLD_CLIENTS`` pins the choice for eligible models."""
    eligible = model.apply_clients is not None and model.apply_train is None
    pinned = pins.bool_pin("QFEDX_FOLD_CLIENTS", True)
    return eligible and pinned


def _finalize_partial(params: dict, partial: RoundPartial,
                      min_participants: float = 0.0,
                      trimmed_fraction=None):
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
        clipped_clients=partial.clipped_clients,
        trimmed_fraction=zero if trimmed_fraction is None
        else trimmed_fraction,
    )
    return new_params, stats


def _per_client(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(C,) → (C, 1, …) broadcasting against a (C, …) leaf."""
    return v.reshape((-1,) + (1,) * (like.ndim - 1))


def make_fed_round(model: Model, cfg: FedConfig, num_clients: int,
                   num_devices: int = 1):
    """Build ``round_fn(params, cx, cy, cmask, generator=None,
    perms=None, survivors=None, byzantine=None, sa_seed=None,
    draws=None) -> (params, stats)``.

    ``cx/cy/cmask``: packed client data [C, S, ...] on the parameters'
    device; ``generator``/``perms`` give the local shuffles
    (``fed/client``). With guards on, ``survivors`` [C] 0/1 excludes
    mid-round casualties from the aggregate and from the secure-agg pair
    graph (the round then equals the survivor-only round); with guards
    off it must be None. ``byzantine`` [C, 2]: each client's (delta
    multiplier, noise σ), honest clients (1, 0). ``sa_seed``: the round's
    secure-agg seed, required with ``cfg.secure_agg``. ``draws``: the
    round's ``RoundDraws``, required when the config samples below
    fraction 1, runs DP or SPSA, an attacker's σ > 0, or the model trains
    through ``apply_train``."""
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
    do_clip = agg == "clip_mean" and math.isfinite(cfg.clip_bound)
    robust = agg in ROBUST_AGGREGATORS
    dp = cfg.dp
    step_stream = ("example_noise" if dp is not None and dp.mode == "example"
                   else "spsa_delta" if cfg.optimizer == "spsa" else None)
    guards = guards_enabled()
    min_count = cfg.min_participation * num_clients
    folded = fold_clients_enabled(model, cfg)
    local_update = (make_local_update_clients if folded
                    else make_local_update)(model, cfg)
    train_specs = model.train_draws

    def train_clients(params, cx, cy, cmask, generator, perms, step_draws,
                      tdraws):
        if folded:
            return local_update(params, cx, cy, cmask, generator=generator,
                                perms=perms, step_draws=step_draws)
        perms = resolve_perms(cfg, num_clients, cx.shape[1], generator,
                              perms, cx.device)
        outs = [local_update(
            params, cx[c], cy[c], cmask[c], perms[c],
            None if step_draws is None
            else trees.tree_map(lambda d: d[c], step_draws),
            None if tdraws is None
            else {k: v[c] for k, v in tdraws.items()})
            for c in range(num_clients)]
        deltas = trees.tree_map(lambda *d: torch.stack(d),
                                *(o[0] for o in outs))
        return (deltas, torch.stack([o[1] for o in outs]),
                torch.stack([o[2] for o in outs]))

    def round_fn(params, cx, cy, cmask, generator=None, perms=None,
                 survivors=None, byzantine=None, sa_seed=None, draws=None):
        if survivors is not None and not guards:
            raise ValueError(
                "survivors requires the guarded round program "
                "(QFEDX_GUARDS=off builds the round without a survivor "
                "input)"
            )
        if cx.shape[0] != num_clients:
            raise ValueError(f"cx holds {cx.shape[0]} clients, the round "
                             f"was built for {num_clients}")
        if cfg.secure_agg and sa_seed is None:
            raise ValueError("secure_agg needs the round's sa_seed")
        if byzantine is not None:
            byzantine = torch.as_tensor(np.asarray(byzantine, np.float32))
            if tuple(byzantine.shape) != (num_clients, 2):
                raise ValueError(
                    f"byzantine must be [num_clients={num_clients}, 2] "
                    "(multiplier, noise sigma) per cohort client; got "
                    f"shape {tuple(byzantine.shape)}"
                )
        needs_draws = (cfg.client_fraction < 1.0 or dp is not None
                       or step_stream is not None or bool(train_specs)
                       or (byzantine is not None
                           and bool((byzantine[:, 1] > 0).any())))
        if needs_draws and draws is None:
            raise ValueError("this round needs its RoundDraws (sampling "
                             "below 1, DP, SPSA, a byzantine sigma, or "
                             "apply_train's dropout, shots or "
                             "trajectories)")
        device = trees.tree_leaves(params)[0].device
        # Participation is decided on the host (a CPU draw), so the
        # secure-agg pair graph needs no device read.
        part_h = (np.ones(num_clients, np.float32)
                  if cfg.client_fraction >= 1.0
                  else draws.participation(num_clients, cfg.client_fraction))
        eff_h = part_h if survivors is None else part_h * np.asarray(
            torch.as_tensor(survivors).cpu(), dtype=np.float32)
        part = torch.as_tensor(part_h, device=device)
        eff = torch.as_tensor(eff_h, device=device)
        steps = cfg.local_epochs * (cx.shape[1] // cfg.batch_size)
        step_draws = tdraws = None
        if step_stream is not None:
            step_draws = draws.tree(step_stream, params, num_clients, steps)
        if train_specs:
            tdraws = draws.train_draws(train_specs, num_clients, steps,
                                       cfg.batch_size, device)
        deltas, ns, losses = train_clients(params, cx, cy, cmask, generator,
                                           perms, step_draws, tdraws)
        with torch.no_grad():
            if byzantine is not None:
                # The adversary tampers after local training and before
                # upload; the quarantine and defenses below see it.
                byz = byzantine.to(device)
                mult, sigma = byz[:, 0], byz[:, 1]
                deltas = trees.tree_map(
                    lambda d: d * _per_client(mult, d), deltas)
                if bool((byzantine[:, 1] > 0).any()):
                    rnd = draws.tree("byzantine_noise", params, num_clients)
                    deltas = trees.tree_map(
                        lambda d, r: torch.where(
                            _per_client(sigma, d) > 0,
                            _per_client(sigma, d) * r, d),
                        deltas, rnd)
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
            if dp is not None and dp.mode == "client":
                deltas = privatize(
                    deltas, dp, draws.tree("dp_noise", params, num_clients),
                    lead=1)
            # Under DP or a robust rule every contributor weighs the same
            # (sample counts would leak dataset sizes, or let an attacker
            # claim mass); example-mode updates are already private.
            weight = torch.clamp(ns, max=1.0) if (dp is not None or robust) \
                else ns
            if do_clip:
                deltas, was_clipped = clip_update(deltas, cfg.clip_bound,
                                                  lead=1)
            weight = weight * eff
            if guards:
                weight = weight * finf
                n_part = torch.sum(eff * finf)
                rejected = torch.sum(eff * (1.0 - finf))
                dropped = torch.sum(part - eff)
            else:
                n_part = torch.sum(part)
                rejected = dropped = torch.zeros((), device=device)
            clipped = (torch.sum(was_clipped * (weight > 0).float())
                       if do_clip else torch.zeros((), device=device))
            contrib = trees.tree_map(
                lambda d: d * _per_client(weight, d), deltas)
            if cfg.secure_agg:
                # The pair graph runs over the effective participants
                # (sampled ∧ surviving): a quarantined client's masks
                # stay in the sum, so they cancel.
                masks = cohort_masks(
                    sa_seed, contrib, eff_h, cfg.secure_agg_scale,
                    cfg.secure_agg_mode, cfg.secure_agg_neighbors,
                )
                contrib = trees.tree_add(contrib, masks)
            tf = None
            if robust:
                # update_sum = combine · m keeps Σ wΔ / Σ w intact.
                combined, m, _ = robust_combine(
                    contrib, (weight > 0).float(), agg, cfg.trim_fraction)
                update_sum = trees.tree_map(lambda t: t * m, combined)
                weight_sum = m
                tf = trimmed_fraction_stat(agg, cfg.trim_fraction, m)
            else:
                update_sum = trees.tree_map(
                    lambda c: torch.sum(c, dim=0), contrib)
                weight_sum = torch.sum(weight)
            partial = RoundPartial(
                update_sum=update_sum,
                weight_sum=weight_sum,
                loss_sum=torch.sum(weight * losses),
                num_participants=n_part,
                rejected_updates=rejected,
                dropped_clients=dropped,
                clipped_clients=clipped,
            )
            return _finalize_partial(params, partial, min_count, tf)

    return round_fn
