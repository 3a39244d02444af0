"""Differential privacy primitives on the parameters' device.

Counterpart of ``qfedx_tpu/fed/privacy.py``: clip a client's update Δθ
to ℓ2 norm C, then add Gaussian noise N(0, σ²C²I). The reference draws
the noise inside its round program from a per-client key; here the
standard-normal tree is an argument (``fed/round.RoundDraws`` draws it
from a seeded CPU generator, or a test injects the reference's), so the
same call gives the same numbers on the card and on the CPU.

Both functions take trees whose leaves carry ``lead`` leading batch
axes (0 for one client's tree, 1 for a (C, …) stack of clients): the
norm is taken over every leaf's remaining axes, so each client is
clipped by its own norm.
"""

from __future__ import annotations

import torch

from qfedx_tpu_torch.fed.config import DPConfig
from qfedx_tpu_torch.utils import trees


def batched_global_norm(tree, lead: int = 0) -> torch.Tensor:
    """ℓ2 norm over every leaf's axes after the first ``lead``: a
    (lead axes)-shaped tensor, one norm per client (or example)."""
    return torch.sqrt(sum(
        torch.sum(torch.square(x), dim=tuple(range(lead, x.ndim)))
        for x in trees.tree_leaves(tree)
    ))


def lead_scale(tree, factor: torch.Tensor):
    """Each leaf times ``factor`` (shaped like the leaves' leading axes),
    broadcast over the remaining axes."""
    return trees.tree_map(
        lambda x: x * factor.reshape(tuple(factor.shape)
                                     + (1,) * (x.ndim - factor.ndim)),
        tree)


def clip_factor(norm: torch.Tensor, clip_norm: float) -> torch.Tensor:
    """min(1, C / max(‖Δ‖, 1e-12)): the scale that brings a norm to ≤ C."""
    return torch.clamp(clip_norm / torch.clamp(norm, min=1e-12), max=1.0)


def clip_by_global_norm(delta, clip_norm: float, lead: int = 0):
    """Scale each tree (per leading index) so its global ℓ2 norm is
    ≤ ``clip_norm``."""
    return lead_scale(delta, clip_factor(batched_global_norm(delta, lead),
                                         clip_norm))


def privatize(delta, dp: DPConfig, noise, lead: int = 0):
    """Clip + noise: Δ̃ = clip_C(Δ) + σC·z, with ``noise`` the standard
    normal tree z shaped like ``delta``."""
    clipped = clip_by_global_norm(delta, dp.clip_norm, lead)
    scale = dp.noise_multiplier * dp.clip_norm
    return trees.tree_map(lambda c, z: c + scale * z, clipped, noise)
