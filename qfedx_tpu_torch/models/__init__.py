"""models of the PyTorch/CUDA port (counterpart of ``qfedx_tpu/models``)."""

from qfedx_tpu_torch.models.api import (  # noqa: F401
    Model,
    StepDraw,
    params_from_jax,
)
from qfedx_tpu_torch.models.cnn import make_tiny_cnn  # noqa: F401
from qfedx_tpu_torch.models.kernel import (  # noqa: F401
    init_landmarks_from_data,
    kernel_matrix,
    make_quantum_kernel_classifier,
)
from qfedx_tpu_torch.models.vqc import make_vqc_classifier  # noqa: F401
from qfedx_tpu_torch.models.vqc_mps import make_mps_classifier  # noqa: F401
