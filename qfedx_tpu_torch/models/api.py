"""The model contract.

Counterpart of ``qfedx_tpu/models/api.py`` (``Model``): a model is pure
functions over a plain dict of parameter tensors keyed like the
reference's pytree.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

Params = Any


def _identity(delta: Params) -> Params:
    return delta


@dataclass(frozen=True)
class Model:
    """- ``init(seed) -> params`` — build the parameter dict.
    - ``apply(params, x) -> logits`` — batched forward: x [B, ...] → [B, K].
    - ``wrap_delta(delta) -> delta`` — post-process a parameter update
      before aggregation (VQC angle deltas wrap to [−π, π)).
    - ``apply_train`` — optional stochastic training forward
      ``(params, x, generator) -> logits``; None uses ``apply``.
    - ``apply_clients`` — optional client-folded forward
      ``(cparams, x) -> logits``: every params leaf carries a leading
      client axis C and x is [C, B, ...] → [C, B, K]. The federated round
      folds per-client parameters into the engine batch through it.
    - ``engine`` — optional ``() -> str``: the engine ``apply`` runs now
      (the VQC's "batched" or "vmap"; the reference's ``engine.trace``
      span names it)."""

    init: Callable[[Any], Params]
    apply: Callable[[Params, Any], Any]
    wrap_delta: Callable[[Params], Params] = field(default=_identity)
    name: str = "model"
    apply_train: Callable[..., Any] | None = None
    apply_clients: Callable[[Params, Any], Any] | None = None
    engine: Callable[[], str] | None = None
