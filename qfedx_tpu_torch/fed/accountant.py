"""Rényi differential privacy accountant (host-side, pure numpy).

Counterpart of ``qfedx_tpu/fed/accountant.py`` (a copy: the port imports
nothing of the JAX package; the arithmetic is the reference's line for
line, so ε agrees bit for bit). RDP of the subsampled Gaussian mechanism
at a grid of integer orders α, composed over steps, converted to (ε, δ).

For sampling rate q = 1 the Gaussian mechanism has RDP(α) = α / (2σ²).
For q < 1 the Poisson-subsampled bound (Mironov et al. 2019; the formula
Opacus/TF-privacy use for integer α) is

    RDP(α) = 1/(α−1) · log Σ_{i=0..α} C(α,i) (1−q)^{α−i} q^i · exp((i²−i)/(2σ²))

computed in log space. Conversion: ε = min_α [ RDP(α)·T + log(1/δ)/(α−1) ].
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


def _logsumexp(vals: np.ndarray) -> float:
    m = np.max(vals)
    if not np.isfinite(m):
        return m
    return float(m + np.log(np.sum(np.exp(vals - m))))


def _log_binom(n: int, k: np.ndarray) -> np.ndarray:
    from math import lgamma

    return np.array([lgamma(n + 1) - lgamma(int(i) + 1) - lgamma(n - int(i) + 1) for i in k])


def rdp_subsampled_gaussian(q: float, sigma: float, orders: np.ndarray) -> np.ndarray:
    """Per-step RDP at each integer order for sampling rate q, noise σ."""
    if sigma <= 0:
        return np.full(len(orders), np.inf)
    out = np.empty(len(orders), dtype=np.float64)
    for idx, alpha in enumerate(orders):
        alpha = int(alpha)
        if q >= 1.0:
            out[idx] = alpha / (2.0 * sigma**2)
            continue
        if q == 0.0:
            out[idx] = 0.0
            continue
        i = np.arange(alpha + 1)
        log_terms = (
            _log_binom(alpha, i)
            + i * np.log(q)
            + (alpha - i) * np.log1p(-q)
            + (i * i - i) / (2.0 * sigma**2)
        )
        out[idx] = _logsumexp(log_terms) / (alpha - 1)
    return out


DEFAULT_ORDERS = np.array(list(range(2, 64)) + [80, 128, 256, 512], dtype=np.int64)


@dataclass
class RDPAccountant:
    """Tracks composed RDP over federated rounds and reports ε(δ).

    ``step(q, sigma, num_steps)`` charges ``num_steps`` invocations of
    the mechanism at sampling rate q and noise multiplier σ;
    ``epsilon(δ)`` gives the current guarantee. q comes from the
    sampling distribution, never from the survivors: a client that was
    selected and then dropped was still sampled, so dropout does not
    shrink q, and a skipped round is still charged (``run/trainer.py``).
    """

    orders: np.ndarray = field(default_factory=lambda: DEFAULT_ORDERS.copy())
    _rdp: np.ndarray = field(default=None)  # type: ignore[assignment]

    def __post_init__(self):
        if self._rdp is None:
            self._rdp = np.zeros(len(self.orders), dtype=np.float64)

    def step(self, q: float, sigma: float, num_steps: int = 1) -> None:
        self._rdp = self._rdp + num_steps * rdp_subsampled_gaussian(
            q, sigma, self.orders
        )

    def epsilon(self, delta: float = 1e-5) -> float:
        if delta <= 0 or delta >= 1:
            raise ValueError("delta must be in (0, 1)")
        eps = self._rdp + np.log(1.0 / delta) / (self.orders - 1)
        return float(np.min(eps))

    @property
    def rdp(self) -> np.ndarray:
        return self._rdp.copy()
