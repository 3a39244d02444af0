"""Byzantine-robust aggregation rules.

Counterpart of ``qfedx_tpu/fed/robust.py`` (``AGGREGATORS``,
``resolve_aggregator``, ``clip_update``, ``trimmed_fraction_stat``,
``robust_combine``) for the resident one-device round:

- **``clip_mean``**: a server-chosen ℓ2 bound on each client's Δθ,
  applied after DP and before weighting and the secure-agg mask, so it
  composes with masks and survivor masks; a bound of ∞ builds no clip.
- **``trimmed_mean`` / ``median``**: coordinate-wise rules (Yin et al.
  2018) over the round's live contributors, uniformly weighted. They
  need per-client visibility, so they refuse secure aggregation on the
  flat round (``fed/round.py``).

``robust_combine`` takes contributors on a leading axis; absentees
become NaN before the sort (``torch.sort`` orders NaN last ascending,
as ``jnp.sort`` does), and the kept range is a function of the live
count, so sampling, dropouts and quarantines need no other code.
``staleness_discount`` belongs to the wave and staleness paths (ROADMAP
Queue 1 item 9) and is not here.
"""

from __future__ import annotations

import torch

from qfedx_tpu_torch.fed.privacy import (
    batched_global_norm,
    clip_factor,
    lead_scale,
)
from qfedx_tpu_torch.utils import pins, trees

AGGREGATORS = ("mean", "clip_mean", "trimmed_mean", "median")
ROBUST_AGGREGATORS = ("trimmed_mean", "median")


def resolve_aggregator(cfg) -> str:
    """The round's aggregation rule: ``QFEDX_AGG`` overrides
    ``cfg.aggregator``; a typo raises."""
    env = pins.choice_pin("QFEDX_AGG", AGGREGATORS, None)
    return cfg.aggregator if env is None else env


def clip_update(delta, bound: float, lead: int = 0):
    """ℓ2-clip each update tree (per leading index) to ``bound``; returns
    the rescaled tree and a float32 0/1 ``was_clipped`` flag per tree.
    Scaling keeps the direction; an update under the bound passes with
    factor exactly 1."""
    factor = clip_factor(batched_global_norm(delta, lead), bound)
    return lead_scale(delta, factor), (factor < 1.0).float()


def trimmed_fraction_stat(mode: str, trim_fraction: float, m):
    """Fraction of the ``m`` live contributors the combine excluded:
    ``trimmed_mean`` drops ``floor(trim_fraction·m)`` per end, ``median``
    keeps the middle one (m odd) or two (m even)."""
    m = torch.as_tensor(m, dtype=torch.float32)
    if mode == "median":
        kept = torch.where(m > 0, 2.0 - torch.remainder(m, 2.0),
                           torch.zeros_like(m))
        trimmed = m - kept
    elif mode == "trimmed_mean":
        trimmed = 2.0 * torch.floor(trim_fraction * m)
    else:
        return torch.zeros((), dtype=torch.float32, device=m.device)
    return trimmed / torch.clamp(m, min=1.0)


def robust_combine(stacked, present, mode: str, trim_fraction: float):
    """Coordinate-wise robust combine over the LEADING axis of every leaf
    of ``stacked`` (K candidate contributions); ``present`` [K] 0/1 marks
    the live ones. ``trimmed_mean`` drops ``floor(trim_fraction·m)``
    from each end of every coordinate's sorted order, ``median`` takes
    the middle element (the mean of the middle two when m is even).

    Returns ``(combined, m, trimmed_fraction)``; m = 0 gives an all-zeros
    combine."""
    if mode not in ROBUST_AGGREGATORS:
        raise ValueError(
            f"robust_combine mode {mode!r} not in {ROBUST_AGGREGATORS}"
        )
    leaf0 = trees.tree_leaves(stacked)[0]
    present = torch.as_tensor(present, dtype=torch.float32,
                              device=leaf0.device)
    m = torch.sum(present)
    k_trim = torch.floor(trim_fraction * m)

    def combine_leaf(v):
        shape = (v.shape[0],) + (1,) * (v.ndim - 1)
        pres = present.reshape(shape)
        idx = torch.arange(v.shape[0], dtype=torch.float32,
                           device=v.device).reshape(shape)
        # Absentees become NaN so the sort puts them after the live
        # contributors; every kept index is < m, so no NaN enters a sum
        # (where, not multiply: NaN·0 is NaN).
        sv = torch.sort(torch.where(pres > 0, v, torch.nan), dim=0).values
        zero = torch.zeros((), dtype=v.dtype, device=v.device)
        if mode == "median":
            lo = torch.floor((m - 1.0) / 2.0)
            hi = torch.floor(m / 2.0)
            # idx < m gates m = 0, where hi = 0 would select a NaN.
            sel = ((idx == lo) | (idx == hi)) & (idx < m)
            coeff = (idx == lo).to(v.dtype) + (idx == hi).to(v.dtype)
            return torch.sum(torch.where(sel, sv * coeff, zero), dim=0) * 0.5
        keep = (idx >= k_trim) & (idx < m - k_trim)
        cnt = torch.clamp(m - 2.0 * k_trim, min=1.0)
        return torch.sum(torch.where(keep, sv, zero), dim=0) / cnt.to(
            v.dtype)

    combined = trees.tree_map(combine_leaf, stacked)
    return combined, m, trimmed_fraction_stat(mode, trim_fraction, m)
