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
aggregation raises ValueError on the flat round, as in the reference.

The hierarchy of the streamed trainer (``run/trainer.
train_federated_streamed``) shares that per-client code
(``_make_wave_block``): ``make_fed_round_partial`` computes one wave's
``RoundPartial`` over cohort positions ``[base, base + W)``, with
participation, survivors, the byzantine input, each client's draws and
the secure-agg pair graph drawn over the cohort (or, under
``QFEDX_STALE`` and the robust rules with masks, the wave's own graph);
``make_accumulate_partial`` adds partials, ``make_apply_partial``
applies their sum, ``make_apply_partials`` applies a stacked set with
the staleness discount by age and, under the robust rules, the
combine across waves; ``make_fed_round`` is the one-wave case. More
than one device (the mesh) is not ported yet.
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
    staleness_discount,
    trimmed_fraction_stat,
)
from qfedx_tpu_torch.fed.sampling import participation_mask
from qfedx_tpu_torch.fed.secure_agg import round_seed, wave_masks
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
    and the CPU draw the same numbers. Client c is its cohort position,
    so a wave at ``first`` draws its own clients' generators only, the
    same numbers whatever wave c lands in. A stream named in ``given``
    is taken from there instead, sliced to the wave (the parity tests
    inject the arrays the reference drew over the cohort):

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
                    device, first: int = 0) -> dict:
        """The streams of ``specs`` (``models.api.StepDraw``) on
        ``device`` for cohort positions ``[first, first + clients)``:
        client c's (steps, batch, *spec.shape) draws from its own
        generator — "keep" uniforms below ``spec.prob``, "uniform" f64
        uniforms, "gumbel" −log(−log u) of f32 uniforms floored at the
        smallest normal."""
        out = {}
        for spec in specs:
            if spec.stream in self.given:
                dtype = {"keep": bool, "uniform": np.float64}.get(
                    spec.kind, np.float32)
                out[spec.stream] = torch.as_tensor(
                    np.asarray(self.given[spec.stream],
                               dtype)[first:first + clients],
                    device=device)
                continue
            shape = (steps, batch) + tuple(spec.shape)
            per_client = []
            for c in range(first, first + clients):
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

    def tree(self, name: str, like, clients: int, steps: int | None = None,
             first: int = 0):
        """Stream ``name`` as a tree shaped like ``like`` with (C[, steps])
        leading axes, on ``like``'s device, for cohort positions
        ``[first, first + clients)``: client c's leaves, in
        ``trees.tree_leaves`` order, from its own generator."""
        device = trees.tree_leaves(like)[0].device
        if name in self.given:
            return trees.tree_map(
                lambda g, _: torch.as_tensor(
                    np.asarray(g, np.float32)[first:first + clients],
                    device=device),
                self.given[name], like)
        salt = {"dp_noise": DP_SEED_SALT, "byzantine_noise": BYZ_SEED_SALT,
                "example_noise": EXAMPLE_SEED_SALT,
                "spsa_delta": SPSA_SEED_SALT}[name]
        lead = () if steps is None else (steps,)
        per_client = []
        for c in range(first, first + clients):
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


def hier_enabled() -> bool:
    """Route streamed rounds through the partial/apply pair?
    ``QFEDX_HIER`` pins; default on. Off forces the flat round, which
    needs the whole cohort in one wave (the parity lever)."""
    return pins.bool_pin("QFEDX_HIER", True)


def stale_enabled() -> bool:
    """Staleness-aware buffering in the streamed trainer? ``QFEDX_STALE``
    pins; default off. On, every wave's secure-agg pair graph is its own
    (a straggler's partial cancels wherever it lands), the streams run
    in "buffer" mode and late partials fold in discounted
    (``make_apply_partials(ages=…)``)."""
    return pins.bool_pin("QFEDX_STALE", False)


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


def _make_wave_block(model: Model, cfg: FedConfig, cohort_clients: int,
                     wave_graph: bool = False):
    """The round's per-client code, shared by the flat round and the
    partial: ``block(params, cx, cy, cmask, base, generator, perms,
    survivors, byzantine, sa_seed, draws) -> RoundPartial`` for the W
    clients at cohort positions ``[base, base + W)`` (``cx`` holds their
    data). Participation, survivors and the byzantine input span the
    cohort, and client c's draws are its own whatever wave it lands in,
    so the flat round is the one-wave case. Under a robust rule with
    secure aggregation, or ``wave_graph`` (``QFEDX_STALE``), the pair
    graph is restricted to the wave, so the wave's masks cancel inside
    its own partial."""
    agg = resolve_aggregator(cfg)
    do_clip = agg == "clip_mean" and math.isfinite(cfg.clip_bound)
    robust = agg in ROBUST_AGGREGATORS
    robust_per_client = robust and not cfg.secure_agg
    per_wave_graph = robust or wave_graph
    dp = cfg.dp
    step_stream = ("example_noise" if dp is not None and dp.mode == "example"
                   else "spsa_delta" if cfg.optimizer == "spsa" else None)
    guards = guards_enabled()
    folded = fold_clients_enabled(model, cfg)
    local_update = (make_local_update_clients if folded
                    else make_local_update)(model, cfg)
    train_specs = model.train_draws

    def train_clients(params, cx, cy, cmask, generator, perms, step_draws,
                      tdraws):
        if folded:
            return local_update(params, cx, cy, cmask, generator=generator,
                                perms=perms, step_draws=step_draws)
        width = cx.shape[0]
        perms = resolve_perms(cfg, width, cx.shape[1], generator, perms,
                              cx.device)
        outs = [local_update(
            params, cx[c], cy[c], cmask[c], perms[c],
            None if step_draws is None
            else trees.tree_map(lambda d: d[c], step_draws),
            None if tdraws is None
            else {k: v[c] for k, v in tdraws.items()})
            for c in range(width)]
        deltas = trees.tree_map(lambda *d: torch.stack(d),
                                *(o[0] for o in outs))
        return (deltas, torch.stack([o[1] for o in outs]),
                torch.stack([o[2] for o in outs]))

    def block(params, cx, cy, cmask, base, generator=None, perms=None,
              survivors=None, byzantine=None, sa_seed=None, draws=None):
        if survivors is not None and not guards:
            raise ValueError(
                "survivors requires the guarded round program "
                "(QFEDX_GUARDS=off builds the round without a survivor "
                "input)"
            )
        width = cx.shape[0]
        base = int(base)
        if not 0 <= base <= cohort_clients - width:
            raise ValueError(f"a wave of {width} clients at {base} does not "
                             f"fit a cohort of {cohort_clients}")
        if cfg.secure_agg and sa_seed is None:
            raise ValueError("secure_agg needs the round's sa_seed")
        ids = slice(base, base + width)
        if byzantine is not None:
            byzantine = torch.as_tensor(np.asarray(byzantine, np.float32))
            if tuple(byzantine.shape) != (cohort_clients, 2):
                raise ValueError(
                    f"byzantine must be [num_clients={cohort_clients}, 2] "
                    "(multiplier, noise sigma) per cohort client; got "
                    f"shape {tuple(byzantine.shape)}"
                )
            byzantine = byzantine[ids]
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
        # Participation is decided on the host (a CPU draw over the
        # cohort), so the secure-agg pair graph needs no device read.
        part_h = (np.ones(cohort_clients, np.float32)
                  if cfg.client_fraction >= 1.0
                  else draws.participation(cohort_clients,
                                           cfg.client_fraction))
        eff_h = part_h if survivors is None else part_h * np.asarray(
            torch.as_tensor(survivors).cpu(), dtype=np.float32)
        part = torch.as_tensor(part_h[ids], device=device)
        eff = torch.as_tensor(eff_h[ids], device=device)
        steps = cfg.local_epochs * (cx.shape[1] // cfg.batch_size)
        step_draws = tdraws = None
        if step_stream is not None:
            step_draws = draws.tree(step_stream, params, width, steps,
                                    first=base)
        if train_specs:
            tdraws = draws.train_draws(train_specs, width, steps,
                                       cfg.batch_size, device, first=base)
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
                    rnd = draws.tree("byzantine_noise", params, width,
                                     first=base)
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
                    deltas, dp, draws.tree("dp_noise", params, width,
                                           first=base),
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
                # (sampled ∧ surviving) of the cohort, or of this wave
                # alone: a quarantined client's masks stay in the sum,
                # so they cancel.
                sa_part = eff_h
                if per_wave_graph:
                    sa_part = np.zeros_like(eff_h)
                    sa_part[ids] = eff_h[ids]
                masks = wave_masks(
                    sa_seed, contrib, sa_part, base, cfg.secure_agg_scale,
                    cfg.secure_agg_mode, cfg.secure_agg_neighbors,
                )
                contrib = trees.tree_add(contrib, masks)
            if robust_per_client:
                # update_sum = combine · m keeps Σ wΔ / Σ w intact.
                combined, m, _ = robust_combine(
                    contrib, (weight > 0).float(), agg, cfg.trim_fraction)
                update_sum = trees.tree_map(lambda t: t * m, combined)
                weight_sum = m
            else:
                update_sum = trees.tree_map(
                    lambda c: torch.sum(c, dim=0), contrib)
                weight_sum = torch.sum(weight)
            return RoundPartial(
                update_sum=update_sum,
                weight_sum=weight_sum,
                loss_sum=torch.sum(weight * losses),
                num_participants=n_part,
                rejected_updates=rejected,
                dropped_clients=dropped,
                clipped_clients=clipped,
            )

    return block


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
    through ``apply_train``. A round returns new tensors: θ is never
    updated in place."""
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
            "the hierarchical streamed path (>= 2 waves, per-wave pair "
            "graphs) or secure_agg=False; clip_mean composes with "
            "masking on any path."
        )
    min_count = cfg.min_participation * num_clients
    block = _make_wave_block(model, cfg, num_clients)

    def round_fn(params, cx, cy, cmask, generator=None, perms=None,
                 survivors=None, byzantine=None, sa_seed=None, draws=None):
        if cx.shape[0] != num_clients:
            raise ValueError(f"cx holds {cx.shape[0]} clients, the round "
                             f"was built for {num_clients}")
        partial = block(params, cx, cy, cmask, 0, generator, perms,
                        survivors, byzantine, sa_seed, draws)
        with torch.no_grad():
            tf = (trimmed_fraction_stat(agg, cfg.trim_fraction,
                                        partial.weight_sum)
                  if agg in ROBUST_AGGREGATORS else None)
            return _finalize_partial(params, partial, min_count, tf)

    return round_fn


def make_fed_round_partial(model: Model, cfg: FedConfig, wave_clients: int,
                           cohort_clients: int | None = None):
    """Build ``partial_fn(params, cx, cy, cmask, wave_base,
    generator=None, perms=None, survivors=None, byzantine=None,
    sa_seed=None, draws=None) -> RoundPartial``: one WAVE of the
    hierarchical round, its ``wave_clients`` clients at cohort positions
    ``[wave_base, wave_base + wave_clients)`` of a cohort of
    ``cohort_clients`` (default: one wave is the whole cohort).

    Sampling, survivors, the byzantine input (all cohort-wide), each
    client's draws and the secure-agg pair graph run over the COHORT, so
    ring masks cancel across waves and W waves equal the flat round up
    to summation order (one wave: bit for bit). ``perms`` holds the
    wave's (W, E, S) shuffles. Under ``QFEDX_STALE`` or a robust rule
    with secure aggregation the pair graph is the wave's own; a robust
    rule with secure aggregation needs ``wave_clients < cohort_clients``,
    as in the reference."""
    cohort = wave_clients if cohort_clients is None else cohort_clients
    agg = resolve_aggregator(cfg)
    if agg in ROBUST_AGGREGATORS and cfg.secure_agg and wave_clients >= cohort:
        raise ValueError(
            f"aggregator={agg!r} under secure_agg "
            "defends at the WAVE level and needs wave_clients < "
            f"cohort_clients (got wave={wave_clients}, cohort={cohort}) "
            "— split the cohort or use clip_mean"
        )
    block = _make_wave_block(model, cfg, cohort, wave_graph=stale_enabled())

    def partial_fn(params, cx, cy, cmask, wave_base, generator=None,
                   perms=None, survivors=None, byzantine=None, sa_seed=None,
                   draws=None):
        if cx.shape[0] != wave_clients:
            raise ValueError(f"cx holds {cx.shape[0]} clients, the wave "
                             f"was built for {wave_clients}")
        return block(params, cx, cy, cmask, wave_base, generator, perms,
                     survivors, byzantine, sa_seed, draws)

    return partial_fn


def make_accumulate_partial():
    """``accum(acc, partial) -> RoundPartial``: the leaf-wise sum that
    folds wave w's partial into the round's running aggregate."""

    def accum(acc: RoundPartial, partial: RoundPartial) -> RoundPartial:
        with torch.no_grad():
            return RoundPartial(*(
                trees.tree_add(a, b) if isinstance(a, dict) else a + b
                for a, b in zip(acc, partial)))

    return accum


def make_apply_partial(cfg: FedConfig | None = None,
                       cohort_clients: int = 0):
    """``apply_fn(params, partial) -> (params, stats)``: the hierarchy's
    root, ``_finalize_partial`` on the accumulated partial (the flat
    round's own finalize, so one wave + apply equals ``make_fed_round``
    bit for bit). With ``cfg``, fewer than ``cfg.min_participation ·
    cohort_clients`` surviving participants make the apply the
    identity."""
    min_count = (cfg.min_participation * cohort_clients
                 if cfg is not None else 0.0)

    def apply_fn(params, partial: RoundPartial):
        with torch.no_grad():
            return _finalize_partial(params, partial, min_count)

    return apply_fn


def make_apply_partials(cfg: FedConfig | None = None,
                        cohort_clients: int = 0):
    """``apply_fn(params, stacked, ages=None) -> (params, stats)`` over a
    STACKED partial (a leading wave axis W on every leaf).

    Under ``mean``/``clip_mean``: the sum over waves, then the finalize;
    with ``ages`` [W] (rounds of lateness, 0 fresh) each wave's update
    and weight are scaled by s(τ) (``fed/robust.staleness_discount``):
    θ ← θ + Σ s·wΔ / Σ s·w. Under ``trimmed_mean``/``median`` each
    wave's mean (``update_sum / weight_sum``, scaled by s(τ) with ages)
    is one contributor of the coordinate-wise combine across waves;
    zero-weight waves are left out, and ``stats.trimmed_fraction`` is
    the combine's. The counts stay undiscounted."""
    agg = resolve_aggregator(cfg) if cfg is not None else "mean"
    min_count = (cfg.min_participation * cohort_clients
                 if cfg is not None else 0.0)
    robust = agg in ROBUST_AGGREGATORS

    def counts(stacked):
        return dict(num_participants=torch.sum(stacked.num_participants),
                    rejected_updates=torch.sum(stacked.rejected_updates),
                    dropped_clients=torch.sum(stacked.dropped_clients),
                    clipped_clients=torch.sum(stacked.clipped_clients))

    def lead(s, t):
        return s.reshape((-1,) + (1,) * (t.ndim - 1)).to(t.dtype)

    def apply_fn(params, stacked: RoundPartial, ages=None):
        if ages is not None and cfg is None:
            raise ValueError(
                "ages requires a FedConfig (staleness_mode/"
                "staleness_alpha shape the discount)"
            )
        with torch.no_grad():
            w = stacked.weight_sum  # [W]
            s = (None if ages is None else staleness_discount(
                cfg.staleness_mode, cfg.staleness_alpha, ages).to(w.device))
            if not robust:
                if s is None:
                    partial = RoundPartial(
                        trees.tree_map(lambda t: torch.sum(t, dim=0),
                                       stacked.update_sum),
                        torch.sum(w), torch.sum(stacked.loss_sum),
                        **counts(stacked))
                else:
                    partial = RoundPartial(
                        trees.tree_map(
                            lambda t: torch.sum(t * lead(s, t), dim=0),
                            stacked.update_sum),
                        torch.sum(w * s), torch.sum(stacked.loss_sum * s),
                        **counts(stacked))
                return _finalize_partial(params, partial, min_count)
            present = (w > 0).float()
            wave_means = trees.tree_map(
                lambda u: u / torch.clamp(lead(w, u), min=1e-12),
                stacked.update_sum)
            if s is not None:
                # A stale wave's mean shrinks by its discount before the
                # sort: one order over fresh and stale contributors.
                wave_means = trees.tree_map(lambda u: u * lead(s, u),
                                            wave_means)
            combined, _m, tf = robust_combine(wave_means, present, agg,
                                              cfg.trim_fraction)
            total_w = torch.sum(w)
            partial = RoundPartial(
                trees.tree_map(lambda t: t * total_w, combined), total_w,
                torch.sum(stacked.loss_sum), **counts(stacked))
            return _finalize_partial(params, partial, min_count,
                                     trimmed_fraction=tf)

    return apply_fn


def stack_partials(parts) -> RoundPartial:
    """A list of per-wave partials → ONE stacked partial (a leading wave
    axis per leaf) for ``make_apply_partials``."""
    if not parts:
        raise ValueError("stack_partials needs at least one wave partial")
    return RoundPartial(*(
        trees.tree_map(lambda *xs: torch.stack(xs), *field)
        if isinstance(field[0], dict) else torch.stack(field)
        for field in zip(*parts)))


def make_fed_rounds(model: Model, cfg: FedConfig, num_clients: int,
                    rounds_per_call: int, with_eval: bool = False,
                    seed: int = 0):
    """K federated rounds in one call: ``rounds_fn(params, cx, cy, cmask,
    start_round[, eval_x, eval_y]) -> (params, stats)`` (with
    ``with_eval``, ``(params, (stats, accuracies))``), each a list over
    the K rounds. Round r takes the trainer's per-round derivation:
    shuffles from ``round_generator(seed, r)``, draws from
    ``RoundDraws(seed, r)``, the secure-agg seed from ``round_seed(seed,
    r, SA_SEED_SALT)``, so K calls of ``make_fed_round`` give the same
    θ. ``with_eval`` takes each round's accuracy on the evaluation set
    (one ``model.apply``) after it."""
    one_round = make_fed_round(model, cfg, num_clients)

    def rounds_fn(params, cx, cy, cmask, start_round, eval_x=None,
                  eval_y=None):
        if with_eval and (eval_x is None or eval_y is None):
            raise ValueError("with_eval=True needs eval_x and eval_y")
        stats, accs = [], []
        for i in range(rounds_per_call):
            r = int(start_round) + i
            params, st = one_round(
                params, cx, cy, cmask, generator=round_generator(seed, r),
                sa_seed=(round_seed(seed, r, SA_SEED_SALT)
                         if cfg.secure_agg else None),
                draws=RoundDraws(seed, r))
            stats.append(st)
            if with_eval:
                with torch.inference_mode():
                    logits = model.apply(params, eval_x)
                    accs.append((torch.argmax(logits, dim=-1)
                                 == eval_y).float().mean())
        return params, ((stats, accs) if with_eval else stats)

    return rounds_fn


def round_generator(seed: int, round_idx: int) -> torch.Generator:
    """The shuffles' generator of round ``round_idx``: a function of
    (seed, round) alone."""
    state = np.random.SeedSequence([seed, round_idx]).generate_state(1)[0]
    return torch.Generator().manual_seed(int(state))
