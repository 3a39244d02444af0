"""Client sampling: registry → cohort, and cohort → participants.

Counterpart of ``qfedx_tpu/fed/sampling.py``:

1. ``CohortSampler`` (host, numpy; a copy of the reference's, bit for
   bit): which registry clients form round r's cohort, a pure function
   of (seed, r), so a resumed run replays the same cohorts. The
   streamed trainer (``run/trainer.train_federated_streamed``) draws
   from it.
2. ``participation_mask``: every cohort client trains every round;
   sampling is a 0/1 mask on the aggregation weights, a Bernoulli(p)
   draw per client when p < 1. The reference draws it from the round
   key; the port from a CPU ``torch.Generator`` the caller seeds per
   round (``fed/round.RoundDraws``), so the card and the CPU draw the
   same mask. It spans the cohort, not a wave, so secure-agg pair
   graphs drawn from it cancel across waves.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


def participation_mask(num_clients: int, fraction: float,
                       generator: torch.Generator | None = None
                       ) -> torch.Tensor:
    """[num_clients] float32 0/1 cohort mask on the CPU: all ones when
    fraction ≥ 1, else Bernoulli(fraction) from ``generator``."""
    if fraction >= 1.0:
        return torch.ones((num_clients,), dtype=torch.float32)
    if generator is None:
        raise ValueError(f"client_fraction={fraction} < 1 needs a generator")
    return (torch.rand((num_clients,), generator=generator)
            < fraction).float()


@dataclass(frozen=True)
class CohortSampler:
    """Seeded, resumable per-round cohort draw from a client registry.

    ``round_ids(r)`` returns the ``cohort_size`` registry ids of round
    r's cohort: drawn without replacement from ``np.random.default_rng(
    [seed, r])`` and sorted (the cohort position order participation,
    DP noise and secure-agg rings index by). ``cohort_size ==
    registry_size`` gives all clients in id order."""

    registry_size: int
    cohort_size: int
    seed: int = 0

    def __post_init__(self):
        if not (1 <= self.cohort_size <= self.registry_size):
            raise ValueError(
                f"cohort_size={self.cohort_size} must be in "
                f"[1, registry_size={self.registry_size}]"
            )

    def round_ids(self, round_idx: int) -> np.ndarray:
        if round_idx < 0:
            raise ValueError(f"round_idx must be >= 0, got {round_idx}")
        if self.cohort_size == self.registry_size:
            return np.arange(self.registry_size, dtype=np.int64)
        rng = np.random.default_rng([self.seed, int(round_idx)])
        ids = rng.choice(self.registry_size, self.cohort_size, replace=False)
        return np.sort(ids.astype(np.int64))
