"""Federated training configuration.

Counterpart of ``qfedx_tpu/fed/config.py`` (a copy: the port imports
nothing of the JAX package): the same ``DPConfig``/``FedConfig`` fields,
defaults and validation, as plain frozen dataclasses. The resident
round (``fed/round.make_fed_round``) runs every field but the staleness
settings; those shape the streamed trainer's discount of late waves
(``run/trainer.train_federated_streamed``, ``fed/round.
make_apply_partials``), as in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class DPConfig:
    """Differential privacy (reference ROADMAP.md:50-51,140-141).

    Two granularities (``mode``):

    - ``"client"`` — DP-FedAvg: clip each client's whole update Δθ to ℓ2
      norm C and add N(0, σ²C²I) once per round (fed.privacy.privatize).
      Protects client membership; one accountant step per round at
      q = client_fraction.
    - ``"example"`` — DP-SGD (BASELINE.md config 2; SURVEY §7.3 hard-part
      4): clip every *example's* gradient to C inside each local step and
      noise the per-batch mean (fed.client per-example grad). Protects
      example membership; the accountant composes one step per LOCAL
      step at q = batch/S_pad (padded client partition size), with client
      sampling conservatively treated as amplification-FREE — client
      fraction is deliberately NOT folded into q (run.trainer).
    """

    clip_norm: float = 1.0
    noise_multiplier: float = 1.0
    delta: float = 1e-5  # reporting δ (ROADMAP.md:113)
    mode: str = "client"  # "client" (DP-FedAvg) | "example" (DP-SGD)

    def __post_init__(self):
        if self.mode not in ("client", "example"):
            raise ValueError(f"unknown dp mode {self.mode!r}")


@dataclass(frozen=True)
class FedConfig:
    local_epochs: int = 5
    batch_size: int = 32
    learning_rate: float = 0.01
    momentum: float = 0.9
    # "sgd" | "adam" | "spsa" (ROADMAP.md:38: Adam + SPSA option). SPSA is a
    # 2-evaluation stochastic gradient *estimator* (the gradient-cost
    # reduction the roadmap wants for shot-based hardware) driving an SGD
    # update; spsa_c is its perturbation scale.
    optimizer: str = "sgd"
    spsa_c: float = 0.1
    algorithm: str = "fedavg"  # "fedavg" | "fedprox"
    prox_mu: float = 0.0  # FedProx proximal strength (BASELINE.md config 3)
    client_fraction: float = 1.0  # client sampling p (ROADMAP.md:106)
    dp: DPConfig | None = None
    secure_agg: bool = False
    secure_agg_scale: float = 1.0  # std of pairwise masks (ROADMAP.md:52-55)
    # Pair graph: "ring" = k-successor ring among the round's cohort, O(k)
    # PRG samples per client (scales to the 256-client BASELINE configs);
    # "pairwise" = complete graph, O(C) per client, collusion threshold
    # C−1 (the roadmap's literal construction).
    secure_agg_mode: str = "ring"
    secure_agg_neighbors: int = 1  # ring hops k; unmasking needs 2k colluders
    # Under DP, clients are weighted uniformly (sample-count weights would
    # leak dataset sizes through the sensitivity analysis). Setting this
    # False with dp configured is rejected — the privacy guarantee must
    # not hinge on a config default (see __post_init__).
    dp_uniform_weights: bool = True
    # Graceful-degradation floor (r11): if fewer than this FRACTION of
    # the round's cohort survives (sampled ∧ not dropped ∧ finite
    # update), the apply step becomes the identity — the round is
    # skipped and logged (stats.applied = 0) instead of averaging a
    # nearly-empty, possibly mask-dust-dominated sum into θ. 0 (the
    # default) disables the floor and keeps the pre-r11 program exactly.
    min_participation: float = 0.0
    # Byzantine-robust aggregation rule (r12, docs/ROBUSTNESS.md):
    #
    # - "mean"         — weighted FedAvg; the r11 program exactly.
    # - "clip_mean"    — each client's Δθ is L2-clipped to ``clip_bound``
    #   BEFORE weighting and before the secure-agg mask is added, so it
    #   composes bit-exactly with ring masks, waves, survivor masks and
    #   DP; ``clip_bound=inf`` (the default) compiles NO clip ops and
    #   reproduces "mean" bit-for-bit (the min_participation=0 idiom).
    # - "trimmed_mean" / "median" — coordinate-wise robust rules (Yin et
    #   al. 2018) over the round's effective participants, UNIFORMLY
    #   weighted (sample-count weights would let an attacker claim
    #   arbitrary mass). They need per-client visibility, so with
    #   secure_agg OFF they run per-client (within each wave) AND across
    #   per-wave RoundPartials; with secure_agg ON the pair graph is
    #   restricted to each WAVE (masks cancel inside a wave's partial)
    #   and the robust rule runs across wave partials only — which still
    #   bounds what a fully-captured wave can do, at the cost of the
    #   server seeing per-wave (never per-client) aggregates. The flat
    #   one-program round with secure_agg + a robust rule is rejected:
    #   it would silently degenerate to plain masked mean.
    #
    # QFEDX_AGG pins the choice at BUILD time (overrides this field —
    # the bench/experiment lever, like QFEDX_FOLD_CLIENTS).
    aggregator: str = "mean"
    clip_bound: float = float("inf")  # L2 bound for clip_mean (∞ = elided)
    trim_fraction: float = 0.1  # per-END trim for trimmed_mean (< 0.5)
    # Staleness-aware buffered aggregation (r13, docs/ROBUSTNESS.md):
    # activation is the QFEDX_STALE BUILD-time pin (default off — the
    # r12 program bit-for-bit); these fields shape the discount s(τ)
    # applied when a straggler wave's RoundPartial, parked τ rounds in
    # the staleness buffer, folds into a later round's apply
    # (fed/robust.staleness_discount):
    #
    # - "constant" — s(τ) = staleness_alpha for every τ ≥ 1 (fresh waves
    #   always weigh 1.0); the FedAsync constant-discount rule.
    # - "poly"     — s(τ) = (1 + τ)^(−staleness_alpha); the FedBuff-style
    #   polynomial decay (τ = 0 ⇒ exactly 1.0 by construction).
    #
    # staleness_max_age bounds the buffer: a parked partial older than
    # this many rounds is discarded (its clients become casualties) —
    # an unboundedly slow straggler cannot pin host memory or steer θ
    # with arbitrarily ancient gradients.
    staleness_mode: str = "constant"  # "constant" | "poly"
    staleness_alpha: float = 0.5
    staleness_max_age: int = 2

    def __post_init__(self):
        if self.algorithm not in ("fedavg", "fedprox"):
            raise ValueError(f"unknown algorithm {self.algorithm!r}")
        if self.optimizer not in ("sgd", "adam", "spsa"):
            raise ValueError(f"unknown optimizer {self.optimizer!r}")
        if self.algorithm == "fedprox" and self.prox_mu <= 0:
            raise ValueError("fedprox requires prox_mu > 0")
        if self.secure_agg_mode not in ("ring", "pairwise"):
            raise ValueError(f"unknown secure_agg_mode {self.secure_agg_mode!r}")
        if self.secure_agg_neighbors < 1:
            raise ValueError("secure_agg_neighbors must be ≥ 1")
        if not (0.0 <= self.min_participation <= 1.0):
            raise ValueError(
                f"min_participation={self.min_participation} must be a "
                "fraction in [0, 1]"
            )
        if self.aggregator not in ("mean", "clip_mean", "trimmed_mean",
                                   "median"):
            raise ValueError(f"unknown aggregator {self.aggregator!r}")
        if not self.clip_bound > 0:
            raise ValueError(
                f"clip_bound={self.clip_bound} must be > 0 (inf disables)"
            )
        if not (0.0 <= self.trim_fraction < 0.5):
            raise ValueError(
                f"trim_fraction={self.trim_fraction} must be in [0, 0.5) — "
                "trimming half or more from each end leaves nothing"
            )
        if self.staleness_mode not in ("constant", "poly"):
            raise ValueError(
                f"unknown staleness_mode {self.staleness_mode!r} "
                "(expected 'constant' or 'poly')"
            )
        if self.staleness_mode == "constant" and not (
            0.0 < self.staleness_alpha <= 1.0
        ):
            raise ValueError(
                f"constant staleness_alpha={self.staleness_alpha} must be "
                "in (0, 1] — 0 discards every stale wave (use 'drop'), "
                "> 1 would amplify stale gradients"
            )
        if self.staleness_mode == "poly" and not self.staleness_alpha >= 0.0:
            raise ValueError(
                f"poly staleness_alpha={self.staleness_alpha} must be >= 0"
            )
        if self.staleness_max_age < 1:
            raise ValueError(
                f"staleness_max_age={self.staleness_max_age} must be >= 1 "
                "— a buffered wave needs at least one later round to land"
            )
        if (
            self.dp is not None
            and self.dp.mode == "example"
            and self.optimizer == "spsa"
        ):
            # SPSA's 2-evaluation estimator has no per-example gradients
            # to clip — the DP-SGD sensitivity analysis doesn't apply.
            raise ValueError("per-example DP (dp mode='example') requires a "
                             "gradient optimizer (sgd/adam), not spsa")
        if self.dp is not None and not self.dp_uniform_weights:
            # Sample-count aggregation weights under DP leak each client's
            # private dataset size into the aggregate and break the noise
            # calibration both DP modes assume (uniform per-client share).
            raise ValueError(
                "dp requires dp_uniform_weights=True: sample-count "
                "weighting leaks dataset sizes and invalidates the DP "
                "noise calibration"
            )
