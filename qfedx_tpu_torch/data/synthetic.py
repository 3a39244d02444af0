"""Deterministic synthetic image datasets.

Counterpart of ``qfedx_tpu/data/synthetic.py`` (a copy, numpy only:
the port's arrays equal the reference's bit for bit at every seed).

The reference mounts MNIST IDX files from disk (reference
src/CFed/Preprocess.py:164-167); in environments without the raw files (and
with no network egress) the framework falls back to a synthetic,
class-structured dataset so every pipeline — preprocessing, partitioning,
federated training, benchmarking — runs end-to-end and is *learnable*
(accuracy tests are meaningful, not vacuous).

Construction: each class gets a fixed smooth template built from a few
low-frequency 2-D cosine modes whose coefficients are drawn from a seeded
PRNG; samples are template + per-sample Gaussian pixel noise + a small random
global shift, clipped to [0, 255] uint8. Classes are well-separated at low
noise and overlap as noise grows, mimicking the difficulty knob of real data.
"""

from __future__ import annotations

import numpy as np


def _class_templates(
    num_classes: int, height: int, width: int, channels: int, seed: int
) -> np.ndarray:
    """(num_classes, H, W, C) float templates in [0, 1]."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(
        np.linspace(0.0, 1.0, height), np.linspace(0.0, 1.0, width), indexing="ij"
    )
    n_modes = 6
    templates = np.zeros((num_classes, height, width, channels), dtype=np.float64)
    for c in range(num_classes):
        for ch in range(channels):
            img = np.zeros((height, width))
            for _ in range(n_modes):
                fy, fx = rng.integers(1, 4, size=2)
                phase_y, phase_x = rng.uniform(0, 2 * np.pi, size=2)
                amp = rng.uniform(0.5, 1.0)
                img += amp * np.cos(2 * np.pi * fy * yy + phase_y) * np.cos(
                    2 * np.pi * fx * xx + phase_x
                )
            img -= img.min()
            if img.max() > 0:
                img /= img.max()
            templates[c, :, :, ch] = img
    return templates


def make_synthetic(
    num_train: int,
    num_test: int,
    num_classes: int = 10,
    height: int = 28,
    width: int = 28,
    channels: int = 1,
    noise: float = 0.25,
    seed: int = 0,
):
    """Return ((train_x, train_y), (test_x, test_y)).

    Images are uint8 with shape (N, H, W) when channels == 1 (MNIST layout)
    or (N, H, W, C) otherwise (CIFAR layout); labels are uint8.
    """
    rng = np.random.default_rng(seed + 1)
    templates = _class_templates(num_classes, height, width, channels, seed)

    def _sample(n: int) -> tuple[np.ndarray, np.ndarray]:
        labels = rng.integers(0, num_classes, size=n).astype(np.uint8)
        base = templates[labels]
        # Small random global shift per sample (keeps classes learnable but
        # prevents single-pixel shortcuts).
        shifts = rng.integers(-2, 3, size=(n, 2))
        imgs = np.empty_like(base)
        for i in range(n):
            imgs[i] = np.roll(base[i], tuple(shifts[i]), axis=(0, 1))
        imgs = imgs + rng.normal(0.0, noise, size=imgs.shape)
        imgs = np.clip(imgs, 0.0, 1.0)
        out = (imgs * 255.0).astype(np.uint8)
        if channels == 1:
            out = out[..., 0]
        return out, labels

    return _sample(num_train), _sample(num_test)
