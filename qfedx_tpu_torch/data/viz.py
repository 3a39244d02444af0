"""Data inspection plots: per-client samples and class distributions.

Counterpart of ``qfedx_tpu/data/viz.py`` (``save_client_samples``, a grid
of sample images per client, and ``save_class_distribution``, a stacked
bar chart of per-client label counts), drawn the same way. matplotlib
is imported inside each function with the Agg backend forced, so
importing this module loads no matplotlib; where matplotlib is absent a
call raises ``ModuleNotFoundError``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def save_client_samples(
    x: np.ndarray,
    parts: list[np.ndarray],
    path: str | Path,
    samples_per_client: int = 5,
    image_shape: tuple[int, int] | None = None,
) -> Path:
    """Grid of sample images, one row per client.

    ``x``: dataset images/features, indexed by the partition's indices.
    Flat feature vectors are reshaped to ``image_shape`` (or the nearest
    square) for display.
    """
    plt = _pyplot()
    num_clients = len(parts)
    fig, axes = plt.subplots(
        num_clients,
        samples_per_client,
        figsize=(1.6 * samples_per_client, 1.6 * num_clients),
        squeeze=False,
    )
    for c, idx in enumerate(parts):
        for s in range(samples_per_client):
            ax = axes[c][s]
            ax.axis("off")
            if s >= len(idx):
                continue  # an empty client is legal here
            img = np.asarray(x[idx[s]])
            if img.ndim == 1:
                if image_shape is not None:
                    img = img.reshape(image_shape)
                else:
                    side = int(np.ceil(np.sqrt(img.size)))
                    img = np.pad(img, (0, side * side - img.size)).reshape(side, side)
            ax.imshow(img.squeeze(), cmap="gray")
            if s == 0:
                ax.set_title(f"client {c}", fontsize=8, loc="left")
    fig.tight_layout()
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(path, dpi=100)
    plt.close(fig)
    return path


def save_class_distribution(
    stats: np.ndarray, path: str | Path, class_names: list[str] | None = None
) -> Path:
    """Stacked bar chart of per-client label counts.

    ``stats``: (num_clients, num_classes) count table from
    ``data.partition.partition_stats``.
    """
    plt = _pyplot()
    stats = np.asarray(stats)
    num_clients, num_classes = stats.shape
    names = class_names or [str(k) for k in range(num_classes)]
    fig, ax = plt.subplots(figsize=(max(6, 0.8 * num_clients), 4))
    bottom = np.zeros(num_clients)
    xs = np.arange(num_clients)
    for k in range(num_classes):
        ax.bar(xs, stats[:, k], bottom=bottom, label=names[k])
        bottom += stats[:, k]
    ax.set_xlabel("client")
    ax.set_ylabel("samples")
    ax.set_title("per-client class distribution")
    ax.set_xticks(xs)
    ax.legend(fontsize=8)
    fig.tight_layout()
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(path, dpi=100)
    plt.close(fig)
    return path
