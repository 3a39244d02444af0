"""The persistent-forward facade: ONE shared forward per model per route.

Counterpart of ``qfedx_tpu/serve/forward.py``. The reference keeps one
``jax.jit`` wrapper per (forward, routing-pin snapshot) so evaluation and
serving hit one executable per route. PyTorch runs eagerly and there is
nothing to compile, so here the facade holds ROUTE IDENTITY and nothing
else: the routing pins are resolved per call and each distinct snapshot
registers one route entry (``cached_routes``) — the seam where captured
programs will live once the port captures them.
"""

from __future__ import annotations

import threading
from typing import Callable

from qfedx_tpu_torch.utils import pins

# Pins consulted while building an engine program (build-time routing).
_ROUTING_PINS = (
    "QFEDX_DTYPE",
    "QFEDX_FUSE",
    "QFEDX_SCAN_LAYERS",
    "QFEDX_PALLAS",
    "QFEDX_BATCHED",
    "QFEDX_GATE_FORM",
    "QFEDX_SLAB_LANES",
    "QFEDX_FOLD_CLIENTS",
)

_ATTR = "_qfedx_persistent_forward"
_LOCK = threading.Lock()


def _routing_key() -> tuple:
    return tuple(pins.str_pin(p, "") for p in _ROUTING_PINS)


def persistent_forward(fwd: Callable) -> Callable:
    """THE shared forward for ``fwd``: one facade per callable (anchored
    on the callable, so its lifetime is the model's), which resolves the
    routing key per call and records the route it dispatched."""
    with _LOCK:
        shared = getattr(fwd, _ATTR, None)
        if shared is not None:
            return shared
        routes: dict = {}

        def shared(*args, **kwargs):
            key = _routing_key()
            with _LOCK:
                routes.setdefault(key, fwd)
            return fwd(*args, **kwargs)

        shared._routes = routes
        setattr(fwd, _ATTR, shared)
        return shared


def cached_routes(fwd: Callable) -> int:
    """Routes dispatched through ``fwd``'s shared forward — tests only."""
    shared = getattr(fwd, _ATTR, None)
    return len(shared._routes) if shared is not None else 0
