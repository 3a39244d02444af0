"""Federated data partitioning → static sharding metadata.

Counterpart of ``qfedx_tpu/data/partition.py`` (a copy, numpy only).

Capability parity: IID partitioner (reference src/CFed/Preprocess.py:23-37)
and Dirichlet(α) label-skew non-IID partitioner (reference
src/CFed/Preprocess.py:40-68). Two TPU-first departures from the reference:

1. **Empty clients are legal.** The reference's Dirichlet partitioner can
   hand a client zero samples at small α with no guard (SURVEY.md §7.4);
   here every downstream consumer weights by sample count, so an empty
   client simply contributes weight 0 to aggregation.
2. **Padding to a static layout.** ``pack_clients`` lays the partition out
   as dense ``[clients, max_samples, ...]`` arrays plus a validity mask, so
   a client axis maps directly onto a device mesh and every per-client
   computation has a static shape (XLA requirement). Weighted FedAvg stays
   exact under padding because masked samples carry zero loss weight.
"""

from __future__ import annotations

import numpy as np


def iid_partition(
    num_samples: int, num_clients: int, seed: int = 0
) -> list[np.ndarray]:
    """Shuffle indices and deal them round-robin into equal-size chunks.

    Same capability as reference Preprocess.py:23-37 (shuffle + contiguous
    slices, remainder to the last client); round-robin dealing keeps client
    sizes within 1 of each other instead of dumping the remainder on one
    client.
    """
    rng = np.random.default_rng(seed)
    idx = rng.permutation(num_samples)
    return [idx[c::num_clients].copy() for c in range(num_clients)]


def dirichlet_partition(
    labels: np.ndarray, num_clients: int, alpha: float = 0.5, seed: int = 0
) -> list[np.ndarray]:
    """Label-skew non-IID split: per class, client shares ~ Dirichlet(α·1).

    Same capability as reference Preprocess.py:40-68. Low α → each class
    concentrated on few clients; high α → approaches IID.
    """
    labels = np.asarray(labels)
    rng = np.random.default_rng(seed)
    client_indices: list[list[np.ndarray]] = [[] for _ in range(num_clients)]
    for cls in np.unique(labels):
        cls_idx = rng.permutation(np.flatnonzero(labels == cls))
        props = rng.dirichlet(np.full(num_clients, alpha))
        # Cumulative proportions → split points; remainder goes to last client.
        splits = (np.cumsum(props)[:-1] * len(cls_idx)).astype(int)
        for c, chunk in enumerate(np.split(cls_idx, splits)):
            client_indices[c].append(chunk)
    out = []
    for c in range(num_clients):
        merged = (
            np.concatenate(client_indices[c])
            if client_indices[c]
            else np.empty(0, dtype=np.int64)
        )
        out.append(rng.permutation(merged))
    return out


def partition_stats(
    labels: np.ndarray, parts: list[np.ndarray], num_classes: int
) -> np.ndarray:
    """(num_clients, num_classes) label-count table — the data behind the
    reference's class-distribution plot (Preprocess.py:96-134)."""
    labels = np.asarray(labels)
    stats = np.zeros((len(parts), num_classes), dtype=np.int64)
    for c, idx in enumerate(parts):
        if len(idx):
            cls, cnt = np.unique(labels[idx], return_counts=True)
            stats[c, cls] = cnt
    return stats


def pack_clients(
    x: np.ndarray,
    y: np.ndarray,
    parts: list[np.ndarray],
    max_samples: int | None = None,
    pad_multiple: int | None = None,
):
    """Dense static client layout for SPMD execution.

    Returns ``(cx, cy, mask)`` with shapes ``[C, S, ...feature]``, ``[C, S]``,
    ``[C, S]`` where ``S`` = max client size (optionally rounded up to
    ``pad_multiple`` for batch-size alignment). ``mask`` is 1.0 on real
    samples, 0.0 on padding; padded labels are 0 (never trained on — all
    loss/metric computations multiply by the mask).
    """
    x, y = np.asarray(x), np.asarray(y)
    num_clients = len(parts)
    sizes = [len(p) for p in parts]
    s = max_samples if max_samples is not None else max(sizes + [1])
    if pad_multiple:
        s = ((s + pad_multiple - 1) // pad_multiple) * pad_multiple
    cx = np.zeros((num_clients, s) + x.shape[1:], dtype=x.dtype)
    cy = np.zeros((num_clients, s), dtype=np.int32)
    mask = np.zeros((num_clients, s), dtype=np.float32)
    for c, idx in enumerate(parts):
        idx = idx[:s]
        n = len(idx)
        cx[c, :n] = x[idx]
        cy[c, :n] = y[idx]
        mask[c, :n] = 1.0
    return cx, cy, mask
