"""Stochastic trajectory (quantum-jump) simulation of Kraus channels.

Counterpart of ``qfedx_tpu/noise/trajectory.py``. A statevector engine
holds no density matrix, so a mixed state is an average over pure
trajectories (O(2^n) each instead of O(4^n)):

    ψ → K_i ψ / ‖K_i ψ‖  with probability ‖K_i ψ‖²

The branch is chosen by the Gumbel-max rule, i = argmax(log p_i + g_i),
with g a standard Gumbel draw per (state, branch) that comes from outside
(``fed/round.RoundDraws``, or the parity tests, which rebuild the
reference's ``jax.random.categorical`` draws: in jax that function IS
``argmax(logits + gumbel(key))``). A Gumbel tensor is laid out with the
branch axis last and as wide as the widest channel (4); a channel of k
branches reads the first k.

Gradient caveat, as in the reference: the sampled branch drops the
score-function term (the dependence of the branch probabilities on the
parameters), so trajectory gradients are biased; the gradient through
the chosen branch and its norm is kept.

``record_branches()`` collects the branch each ``apply_channel`` call
picks inside its block (device tensors, in call order), so two runs on
the same draws, on the card and on the CPU, compare choice by choice.
"""

from __future__ import annotations

import contextlib

import torch

from qfedx_tpu_torch.ops import statevector as sv
from qfedx_tpu_torch.ops.cpx import CArray

# The widest channel's branch count (depolarizing): the width of a
# Gumbel tensor's branch axis.
MAX_BRANCHES = 4
_branch_log: list | None = None


@contextlib.contextmanager
def record_branches():
    """Yield a list that receives each ``apply_channel`` call's (*lead,)
    branch indices made inside the block."""
    global _branch_log
    before, _branch_log = _branch_log, []
    try:
        yield _branch_log
    finally:
        _branch_log = before


def _kraus_op(kraus: CArray, i: int) -> CArray:
    return CArray(kraus.re[i], None if kraus.im is None else kraus.im[i])


def _select(stack: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """stack (k, *lead, …) and idx (*lead,) → stack[idx[l], l, …]."""
    view = idx.reshape((1,) + tuple(idx.shape)
                       + (1,) * (stack.ndim - 1 - idx.ndim))
    return torch.gather(stack, 0, view.expand((1,) + tuple(stack.shape[1:]))
                        )[0]


def apply_channel(state: CArray, kraus: CArray, qubit: int,
                  gumbel: torch.Tensor, n: int | None = None) -> CArray:
    """One sampled Kraus branch of a single-qubit channel on ``qubit`` of
    a dense (*lead, 2, …, 2) state. ``kraus``: stacked (k, 2, 2);
    ``gumbel``: (*lead, ≥k) Gumbel draws. Every branch is applied, the
    Born weights taken in f32 whatever the state dtype, one branch picked
    per state and renormalised (``1e-30`` floors, as the reference)."""
    n = sv._width(state, n)
    lead = sv._lead(state, n)
    n_k = kraus.re.shape[0]
    outs = [sv.apply_gate(state, _kraus_op(kraus, i), qubit, n)
            for i in range(n_k)]
    probs = torch.stack([sv.probabilities(o, n).sum(dim=-1) for o in outs])
    with torch.no_grad():
        logits = torch.log(torch.clamp(probs, min=1e-30))
        g = torch.as_tensor(gumbel, device=probs.device)[..., :n_k]
        idx = torch.argmax(logits + torch.movedim(g, -1, 0), dim=0)
    if _branch_log is not None:
        _branch_log.append(idx)
    re = _select(torch.stack([o.re for o in outs]), idx)
    any_im = any(o.im is not None for o in outs)
    im = (_select(torch.stack([o.imag_or_zeros() for o in outs]), idx)
          if any_im else None)
    norm = torch.sqrt(torch.clamp(_select(probs, idx), min=1e-30)).to(
        re.dtype).reshape(lead + (1,) * n)
    return CArray(re / norm, None if im is None else im / norm)


def apply_channel_all(state: CArray, kraus: CArray, gumbel: torch.Tensor,
                      n: int | None = None) -> CArray:
    """The channel on every qubit in turn, qubit 0 first; ``gumbel``:
    (*lead, n, ≥k), row q for qubit q (the reference's one key per
    qubit)."""
    n = sv._width(state, n)
    for q in range(n):
        state = apply_channel(state, kraus, q, gumbel[..., q, :], n)
    return state


def trajectory_average(observable_fn, n_trajectories: int):
    """Monte-Carlo channel average. ``observable_fn(draws)`` runs a batch
    of trajectories, the draws' leading axis one per trajectory, and
    returns one value per trajectory along a leading axis; the returned
    ``averaged(draws)`` takes ``n_trajectories`` of them and averages —
    the density-matrix expectation to O(1/√T). The reference vmaps one
    trajectory over T keys; here the trajectories are a batch axis."""

    def averaged(draws):
        lead = {int(t.shape[0]) for t in (
            draws.values() if isinstance(draws, dict) else [draws])}
        if lead != {n_trajectories}:
            raise ValueError(f"draws for {sorted(lead)} trajectories, "
                             f"expected {n_trajectories}")
        return torch.mean(observable_fn(draws), dim=0)

    return averaged
