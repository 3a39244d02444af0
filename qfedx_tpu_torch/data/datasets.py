"""Dataset registry: MNIST / Fashion-MNIST / CIFAR-10 with synthetic fallback.

Counterpart of ``qfedx_tpu/data/datasets.py`` (a copy, numpy only).

Capability parity with reference src/CFed/Preprocess.py:137-228 (MNIST-only)
extended to the BASELINE.md target grid (Fashion-MNIST config 4, CIFAR-10
config 3). Real files are used when present; otherwise a deterministic
synthetic stand-in with the same shape contract is generated (no network
egress is assumed anywhere in the framework).
"""

from __future__ import annotations

import pickle
import zlib
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from qfedx_tpu_torch.data.idx import read_idx_images, read_idx_labels
from qfedx_tpu_torch.data.synthetic import make_synthetic


@dataclass(frozen=True)
class DatasetSpec:
    name: str
    height: int
    width: int
    channels: int
    num_classes: int


SPECS = {
    "mnist": DatasetSpec("mnist", 28, 28, 1, 10),
    "fashion_mnist": DatasetSpec("fashion_mnist", 28, 28, 1, 10),
    "cifar10": DatasetSpec("cifar10", 32, 32, 3, 10),
    # Iris (reference ROADMAP.md:102-105 names it alongside MNIST-PCA as
    # the small-qubit evaluation dataset): 4 tabular features carried as
    # 1×4 "images" so the whole pipeline contract applies unchanged.
    # Quantum models use it directly (4 features ↔ 2–4 qubits); the CNN
    # path is image-shaped and not meaningful here.
    "iris": DatasetSpec("iris", 1, 4, 1, 3),
}

# MNIST/Fashion-MNIST raw filename convention (reference Preprocess.py:164-167).
_IDX_FILES = {
    "train_images": "train-images.idx3-ubyte",
    "train_labels": "train-labels.idx1-ubyte",
    "test_images": "t10k-images.idx3-ubyte",
    "test_labels": "t10k-labels.idx1-ubyte",
}


def _try_load_idx(raw_folder: Path):
    paths = {k: raw_folder / v for k, v in _IDX_FILES.items()}
    if not all(p.exists() for p in paths.values()):
        return None
    return (
        (read_idx_images(paths["train_images"]), read_idx_labels(paths["train_labels"])),
        (read_idx_images(paths["test_images"]), read_idx_labels(paths["test_labels"])),
    )


def _try_load_cifar10(raw_folder: Path):
    """CIFAR-10 python-pickle batch format, if present on disk."""
    batches = sorted(raw_folder.glob("data_batch_*"))
    test = raw_folder / "test_batch"
    if not batches or not test.exists():
        return None

    def _read(path: Path):
        with open(path, "rb") as f:
            d = pickle.load(f, encoding="bytes")
        x = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        y = np.asarray(d[b"labels"], dtype=np.uint8)
        return x, y

    xs, ys = zip(*[_read(p) for p in batches])
    return (np.concatenate(xs), np.concatenate(ys)), _read(test)


def _load_iris(seed: int):
    """Iris from the bundled table (data/_iris.py — no loader deps):
    150×4 floats → uint8 in the (N, 1, 4) image contract (features span
    ~0–8 cm, so /8·255 keeps ~0.03 cm resolution), stratified 120/30
    split via the framework's own splitter."""
    from qfedx_tpu_torch.data._iris import iris_table
    from qfedx_tpu_torch.data.pipeline import stratified_split

    x, y = iris_table()
    x = np.clip(x / 8.0, 0.0, 1.0)
    x = (x * 255.0).astype(np.uint8).reshape(-1, 1, 4)
    (tr_x, tr_y), (te_x, te_y) = stratified_split(x, y, frac=0.2, seed=seed)
    return (tr_x, tr_y), (te_x, te_y)


def load_dataset(
    name: str = "mnist",
    raw_folder: str | Path | None = None,
    synthetic_train: int = 4096,
    synthetic_test: int = 1024,
    synthetic_noise: float = 0.25,
    seed: int = 0,
):
    """Return (spec, (train_x, train_y), (test_x, test_y)) as uint8 arrays.

    Tries real files under ``raw_folder`` first; falls back to the synthetic
    generator with identical shapes. Image layout: (N, H, W) for grayscale,
    (N, H, W, C) for color. Exception: ``iris`` is a real bundled table —
    it always returns the fixed 120/30 stratified split, and the
    raw_folder/synthetic_* knobs do not apply to it.
    """
    if name not in SPECS:
        raise ValueError(f"unknown dataset {name!r}; available: {sorted(SPECS)}")
    spec = SPECS[name]
    if name == "iris":
        return spec, *_load_iris(seed)
    if raw_folder is not None:
        raw = Path(raw_folder)
        loaded = (
            _try_load_cifar10(raw) if name == "cifar10" else _try_load_idx(raw)
        )
        if loaded is not None:
            return spec, loaded[0], loaded[1]
    # Seed offset per dataset name so "mnist" and "fashion_mnist" synthetics
    # differ even at the same user seed (crc32: stable across processes,
    # unlike builtin hash under PYTHONHASHSEED randomization).
    name_seed = seed * 131 + (zlib.crc32(name.encode()) % 1000)
    train, test = make_synthetic(
        synthetic_train,
        synthetic_test,
        num_classes=spec.num_classes,
        height=spec.height,
        width=spec.width,
        channels=spec.channels,
        noise=synthetic_noise,
        seed=name_seed,
    )
    return spec, train, test
