"""qfedx_tpu_torch — the PyTorch/CUDA port of ``qfedx_tpu``.

A package of its own beside the JAX reference, module for module
(``ops/``, ``circuits/``, ``models/``, ``fed/``, ``data/``, ``run/``,
``serve/``, ``noise/``, ``obs/``, ``tune/``, ``parallel/``,
``analysis/``, ``utils/``). It
imports ``torch`` and numpy, never ``jax`` and nothing of ``qfedx_tpu``.
The reference's one TPU kernel (the Pallas scan-body kernel) is a CUDA
C++ kernel for Hopper here (``ops/csrc/scan_body.cu``, bound in
``ops/scan_body.py``). Entry points run on the card (``device=None``)
and raise without one; the CPU runs only when a caller passes
``device="cpu"``, and there every kernel wrapper takes its plain PyTorch
version.
"""

__version__ = "0.4.0"
