"""The model contract.

Counterpart of ``qfedx_tpu/models/api.py`` (``Model``): a model is pure
functions over a plain dict of parameter tensors keyed like the
reference's pytree.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

Params = Any


@dataclass(frozen=True)
class Model:
    """- ``init(seed) -> params`` — build the parameter dict.
    - ``apply(params, x) -> logits`` — batched forward: x [B, ...] → [B, K].
    (The reference's training hooks — ``wrap_delta``, ``apply_train``, ``apply_clients`` —
    arrive with the training slice.)"""

    init: Callable[[Any], Params]
    apply: Callable[[Params, Any], Any]
    name: str = "model"
