"""The runner of the PyTorch/CUDA port (counterpart of ``qfedx_tpu/run``):
experiment config, metrics, checkpoints, the trainer, the CLI, the sweep
harness and the encoder demo."""
