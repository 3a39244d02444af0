"""Serving for the PyTorch/CUDA port (counterpart of ``qfedx_tpu/serve``)."""

from qfedx_tpu_torch.serve.batcher import (
    Future,
    MicroBatcher,
    Overloaded,
    RequestError,
    ShuttingDown,
)
from qfedx_tpu_torch.serve.engine import (
    ServeConfig,
    ServeEngine,
    engine_from_run_dir,
)
from qfedx_tpu_torch.serve.forward import cached_routes, persistent_forward

__all__ = [
    "Future",
    "MicroBatcher",
    "Overloaded",
    "RequestError",
    "ServeConfig",
    "ServeEngine",
    "ShuttingDown",
    "cached_routes",
    "engine_from_run_dir",
    "persistent_forward",
]
