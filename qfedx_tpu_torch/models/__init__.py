"""models of the PyTorch/CUDA port (counterpart of ``qfedx_tpu/models``)."""
