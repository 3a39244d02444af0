"""Client sampling: cohort → participants.

Counterpart of ``qfedx_tpu/fed/sampling.py``'s ``participation_mask``
at full participation. Every cohort client trains every round (the
program shape is static); sampling is a 0/1 mask on the aggregation
weights. A fraction below 1 needs a Bernoulli draw from the round's key
stream, which is not ported yet.
"""

from __future__ import annotations

import torch


def participation_mask(num_clients: int, fraction: float,
                       device) -> torch.Tensor:
    """[num_clients] float 0/1 cohort mask: all ones when fraction ≥ 1."""
    if fraction >= 1.0:
        return torch.ones((num_clients,), dtype=torch.float32, device=device)
    raise NotImplementedError(
        f"client_fraction={fraction} < 1 is not ported yet; the port "
        "samples every client (fraction 1)"
    )
