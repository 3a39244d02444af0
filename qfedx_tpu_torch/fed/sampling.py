"""Client sampling: cohort → participants.

Counterpart of ``qfedx_tpu/fed/sampling.py``'s ``participation_mask``.
Every cohort client trains every round (the program shape is static);
sampling is a 0/1 mask on the aggregation weights, a Bernoulli(p) draw
per client when p < 1. The reference draws it from the round key; the
port from a CPU ``torch.Generator`` the caller seeds per round
(``fed/round.RoundDraws``), so the card and the CPU draw the same mask.
``CohortSampler`` (registry → cohort) serves the streamed trainer and
waits for it (ROADMAP Queue 1 item 9).
"""

from __future__ import annotations

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
