"""Data loading, partitioning and preprocessing for the PyTorch/CUDA port.

Counterpart of ``qfedx_tpu/data``: numpy copies of the reference's
modules, so the port's arrays equal the reference's bit for bit, with
the streamed registries (``data/stream.py``) and the plots
(``data/viz.py``, matplotlib imported inside each function).
"""

from qfedx_tpu_torch.data.datasets import load_dataset  # noqa: F401
from qfedx_tpu_torch.data.partition import (  # noqa: F401
    dirichlet_partition,
    iid_partition,
    pack_clients,
)
from qfedx_tpu_torch.data.pipeline import preprocess  # noqa: F401
