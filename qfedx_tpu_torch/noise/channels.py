"""Quantum noise channels: analytic ⟨Z⟩ maps and Kraus operators.

Counterpart of ``qfedx_tpu/noise/channels.py``: depolarizing(p),
amplitude damping(γ), readout confusion and finite shots, at two levels
of fidelity:

- **Analytic readout channels** (``NoiseModel``): for single-qubit Z
  observables, product channels applied before measurement act on ⟨Z⟩ in
  closed form: depolarizing gives (1−p)⟨Z⟩, amplitude damping
  ⟨Z⟩ + γ(1−⟨Z⟩), a readout confusion pushes the marginals through its
  column-stochastic matrix, and finite shots sample counts of
  P(0) = (1+⟨Z⟩)/2.
- **Trajectory sampling** (``noise/trajectory.py``): the Kraus sets here
  applied inside the circuit by stochastic unravelling.

Finite shots take their randomness from outside, as every draw of the
port does (``fed/round.RoundDraws``): one U[0, 1) per (sample, class),
and the count is the Binomial(shots, p₀) inverse CDF at it
(``binomial_counts``). The uniforms do not depend on the parameters, so
the card and the CPU draw the same, and the counts carry no gradient, as
the reference's ``jax.random.binomial`` counts carry none.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

import numpy as np
import torch

from qfedx_tpu_torch.ops.cpx import RDTYPE, CArray, from_complex
from qfedx_tpu_torch.ops.statevector import _align, expect_z_all
from qfedx_tpu_torch.utils import pins


# --- Kraus operator sets (stacked (k, 2, 2) CArrays) -----------------------


def depolarizing_kraus(p: float, device=None) -> CArray:
    """{√(1−3p/4)·I, √(p/4)·X, √(p/4)·Y, √(p/4)·Z}: ρ → (1−p)ρ + p·I/2,
    so ⟨Z⟩ → (1−p)⟨Z⟩, the same p as ``NoiseModel.apply_to_z``."""
    s0, s1 = np.sqrt(1.0 - 3.0 * p / 4.0), np.sqrt(p / 4.0)
    ops = np.stack([
        s0 * np.eye(2),
        s1 * np.array([[0, 1], [1, 0]]),
        s1 * np.array([[0, -1j], [1j, 0]]),
        s1 * np.array([[1, 0], [0, -1]]),
    ])
    return from_complex(ops, device)


def _real_kraus(ops, device) -> CArray:
    return CArray(torch.as_tensor(np.stack(ops), dtype=RDTYPE,
                                  device=pins.resolve_device(device)), None)


def amplitude_damping_kraus(gamma: float, device=None) -> CArray:
    """{[[1,0],[0,√(1−γ)]], [[0,√γ],[0,0]]}."""
    return _real_kraus([
        np.array([[1.0, 0.0], [0.0, np.sqrt(1.0 - gamma)]]),
        np.array([[0.0, np.sqrt(gamma)], [0.0, 0.0]]),
    ], device)


def bit_flip_kraus(p: float, device=None) -> CArray:
    return _real_kraus([
        np.sqrt(1.0 - p) * np.eye(2),
        np.sqrt(p) * np.array([[0.0, 1.0], [1.0, 0.0]]),
    ], device)


def phase_flip_kraus(p: float, device=None) -> CArray:
    return _real_kraus([
        np.sqrt(1.0 - p) * np.eye(2),
        np.sqrt(p) * np.diag([1.0, -1.0]),
    ], device)


# --- readout confusion -----------------------------------------------------


def confusion_matrix(e01: float, e10: float, device=None) -> torch.Tensor:
    """Column-stochastic M[measured, true]: P(read i | prepared j), with
    e01 = P(read 1 | true 0) and e10 = P(read 0 | true 1)."""
    return torch.tensor([[1.0 - e01, e10], [e01, 1.0 - e10]], dtype=RDTYPE,
                        device=pins.resolve_device(device))


def apply_confusion_to_z(z: torch.Tensor, e01: float, e10: float
                         ) -> torch.Tensor:
    """⟨Z⟩ after pushing per-qubit marginals through the confusion
    matrix."""
    p0 = (1.0 + z) / 2.0
    p0_read = (1.0 - e01) * p0 + e10 * (1.0 - p0)
    return 2.0 * p0_read - 1.0


# --- finite shots ------------------------------------------------------------


def binomial_counts(p0: torch.Tensor, shots: int, u: torch.Tensor
                    ) -> torch.Tensor:
    """Binomial(shots, p₀) counts as the inverse CDF at ``u``:
    count = #{c < shots : F(c) ≤ u}, F computed in f64 on ``p0``'s device
    from the log-pmf (``xlogy`` keeps p₀ ∈ {0, 1} exact). ``u`` has
    ``p0``'s shape; the counts come back in ``p0``'s dtype, detached.
    Memory is ``p0.numel()·(shots + 1)`` f64 values."""
    p = p0.detach().double()[..., None]
    c = torch.arange(shots + 1, dtype=torch.float64, device=p.device)
    log_pmf = (math.lgamma(shots + 1) - torch.lgamma(c + 1.0)
               - torch.lgamma(shots - c + 1.0)
               + torch.xlogy(c, p) + torch.xlogy(shots - c, 1.0 - p))
    cdf = torch.cumsum(torch.exp(log_pmf), dim=-1)
    u = torch.as_tensor(u, device=p.device).double()[..., None]
    return (cdf[..., :shots] <= u).sum(dim=-1).to(p0.dtype)


# --- the model-facing bundle ----------------------------------------------


@dataclass(frozen=True)
class NoiseModel:
    """Readout-time noise bundle, pluggable into ``make_vqc_classifier``.

    Channel order (circuit noise, then measurement): depolarizing →
    amplitude damping → readout confusion → finite shots. ``shots=None``
    is the exact expectation. ``circuit_level=True``: in training,
    depolarizing and damping act as sampled Kraus trajectories after
    every ansatz layer (``noise/trajectory.py``); evaluation stays
    analytic on the layer-composed strengths (``composed``)."""

    depolarizing_p: float = 0.0
    amp_damping_gamma: float = 0.0
    readout_e01: float = 0.0  # P(read 1 | true 0)
    readout_e10: float = 0.0  # P(read 0 | true 1)
    shots: int | None = None
    circuit_level: bool = False

    def composed(self, n: int) -> "NoiseModel":
        """Analytic strengths after ``n`` sequential applications. One
        application is the affine map T(z) = a·z + γ with a = (1−γ)(1−p);
        Tⁿ has slope aⁿ and offset γ(1−aⁿ)/(1−a), realised exactly by an
        effective (p_eff, γ_eff). Confusion and shots act once."""
        if n <= 1:
            return self
        p, g = self.depolarizing_p, self.amp_damping_gamma
        a = (1.0 - g) * (1.0 - p)
        slope = a**n
        offset = 0.0 if g == 0.0 else g * (1.0 - slope) / (1.0 - a)
        gamma_eff = offset
        if gamma_eff >= 1.0:  # fully damped: z → 1 regardless of input
            p_eff, gamma_eff = 0.0, 1.0
        else:
            p_eff = max(0.0, 1.0 - slope / (1.0 - gamma_eff))
        return replace(self, depolarizing_p=p_eff,
                       amp_damping_gamma=gamma_eff)

    def kraus_channels(self, device=None) -> list:
        """Stacked Kraus sets of the circuit-level channels that are on,
        on ``device`` (None = the card)."""
        out = []
        if self.depolarizing_p > 0.0:
            out.append(depolarizing_kraus(self.depolarizing_p, device))
        if self.amp_damping_gamma > 0.0:
            out.append(amplitude_damping_kraus(self.amp_damping_gamma,
                                               device))
        return out

    def exact_shots(self) -> "NoiseModel":
        """This model in the infinite-shot limit (deterministic eval).
        As in the reference, a model with shots comes back without
        ``circuit_level``."""
        if self.shots is None:
            return self
        return NoiseModel(
            depolarizing_p=self.depolarizing_p,
            amp_damping_gamma=self.amp_damping_gamma,
            readout_e01=self.readout_e01,
            readout_e10=self.readout_e10,
            shots=None,
        )

    def apply_to_z(self, z: torch.Tensor, shot_u: torch.Tensor | None = None
                   ) -> torch.Tensor:
        """The channels on ⟨Z⟩ values ``z``; finite shots take one
        U[0, 1) per value from ``shot_u`` (``z``'s shape)."""
        if self.depolarizing_p > 0.0:
            z = (1.0 - self.depolarizing_p) * z
        if self.amp_damping_gamma > 0.0:
            z = z + self.amp_damping_gamma * (1.0 - z)
        if self.readout_e01 > 0.0 or self.readout_e10 > 0.0:
            z = apply_confusion_to_z(z, self.readout_e01, self.readout_e10)
        if self.shots is not None:
            if shot_u is None:
                raise ValueError("finite-shot noise needs its shot uniforms")
            p0 = torch.clamp((1.0 + z) / 2.0, 0.0, 1.0)
            counts = binomial_counts(p0, self.shots, shot_u)
            z = 2.0 * counts / self.shots - 1.0
        return z

    def noisy_logits(self, state: CArray, readout_params: dict,
                     shot_u: torch.Tensor | None = None,
                     n: int | None = None) -> torch.Tensor:
        """Noisy ``circuits.readout.z_logits`` on a dense (*lead, 2, …, 2)
        state: logit_c = scale_c · noisy⟨Z_c⟩ + bias_c, (*lead, k);
        per-client (C, k) readouts left-align with a (C, B, …) state."""
        k = readout_params["scale"].shape[-1]
        z = self.apply_to_z(expect_z_all(state, n)[..., :k], shot_u)
        lead_nd = z.ndim - 1
        return (_align(readout_params["scale"], 1, lead_nd) * z
                + _align(readout_params["bias"], 1, lead_nd))
