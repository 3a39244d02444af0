"""The model contract.

Counterpart of ``qfedx_tpu/models/api.py`` (``Model``): a model is pure
functions over a plain dict of parameter tensors keyed like the
reference's pytree.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from qfedx_tpu_torch.utils import pins, trees

Params = Any


class StepDraw(NamedTuple):
    """One stream of draws ``apply_train`` takes at every local step, for
    each sample of the step's batch a draw of ``shape``. ``stream`` names
    it in ``fed/round.RoundDraws``; ``kind`` says what it holds:

    - "keep": bools, each True with probability ``prob`` (the TinyCNN's
      dropout keep mask, ``dropout_keep``, (64,), 0.5);
    - "uniform": U[0, 1) in f64 (the VQC's finite-shot uniforms,
      ``shot_uniform``, (k,));
    - "gumbel": standard Gumbel in f32 (the VQC's Kraus branch draws,
      ``branch_gumbel``, (L, channels, n, 4))."""

    stream: str
    kind: str
    shape: tuple[int, ...]
    prob: float = 1.0


def _identity(delta: Params) -> Params:
    return delta


@dataclass(frozen=True)
class Model:
    """- ``init(seed) -> params`` — build the parameter dict.
    - ``apply(params, x) -> logits`` — batched forward: x [B, ...] → [B, K].
    - ``wrap_delta(delta) -> delta`` — post-process a parameter update
      before aggregation (VQC angle deltas wrap to [−π, π)).
    - ``apply_train`` — optional stochastic training forward
      ``(params, x, draws) -> logits`` with ``draws`` a dict from each
      stream of ``train_draws`` to its (B, *shape) draw; None uses
      ``apply``. The reference passes a PRNG key instead; the port's
      draws come from ``fed/round.RoundDraws`` (or the parity tests), so
      the card and the CPU draw the same.
    - ``train_draws`` — the ``StepDraw`` streams ``apply_train`` takes.
    - ``apply_clients`` — optional client-folded forward
      ``(cparams, x) -> logits``: every params leaf carries a leading
      client axis C and x is [C, B, ...] → [C, B, K]. The federated round
      folds per-client parameters into the engine batch through it.
    - ``engine`` — optional ``() -> str``: the engine ``apply`` runs now
      (the VQC's "batched" or "vmap"; the reference's ``engine.trace``
      span names it).
    - ``sv_size`` — slots per statevector: > 1 for a model whose forward
      runs on a sharded state (``models/vqc_sharded.py``), whose
      ``apply`` then runs inside an sv group of that many slots
      (``parallel.sharded.sv_group``); ``sv_axis`` names the mesh axis."""

    init: Callable[[Any], Params]
    apply: Callable[[Params, Any], Any]
    wrap_delta: Callable[[Params], Params] = field(default=_identity)
    name: str = "model"
    apply_train: Callable[..., Any] | None = None
    train_draws: tuple[StepDraw, ...] = ()
    apply_clients: Callable[[Params, Any], Any] | None = None
    engine: Callable[[], str] | None = None
    sv_size: int = 1
    sv_axis: str = "sv"


def params_from_jax(tree, device=None) -> dict:
    """A reference parameter pytree (a dict of numpy or array-like
    leaves, nested or flat) → the port's dict of f32 tensors on
    ``device`` (None = the card). Every family keeps the reference's keys
    and leaf layouts, so shapes carry over as they are: a client-stacked
    tree converts the same way."""
    dev = pins.resolve_device(device)
    return trees.tree_map(
        lambda v: torch.as_tensor(np.array(v, dtype=np.float32), device=dev),
        dict(tree))
