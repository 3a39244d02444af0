"""noise of the PyTorch/CUDA port (counterpart of ``qfedx_tpu/noise``)."""

from qfedx_tpu_torch.noise.channels import (  # noqa: F401
    NoiseModel,
    amplitude_damping_kraus,
    apply_confusion_to_z,
    binomial_counts,
    bit_flip_kraus,
    confusion_matrix,
    depolarizing_kraus,
    phase_flip_kraus,
)
from qfedx_tpu_torch.noise.trajectory import (  # noqa: F401
    apply_channel,
    apply_channel_all,
    trajectory_average,
)
