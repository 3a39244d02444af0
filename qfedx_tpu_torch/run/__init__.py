"""The runner of the PyTorch/CUDA port (counterpart of ``qfedx_tpu/run``):
experiment config, metrics, checkpoints, the trainer and the CLI."""
