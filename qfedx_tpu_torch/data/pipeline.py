"""Preprocessing pipeline: filter → normalize → split → feature-reduce.

Counterpart of ``qfedx_tpu/data/pipeline.py`` (a copy, numpy only;
the reference's ``data.preprocess`` span waits for the port's ``obs``).

Capability parity with reference src/CFed/Preprocess.py:137-228
(``preprocess_mnist``: digit-subset filter, /255 normalization, stratified
train/val split) plus the feature reducers used on the quantum side:
block-average image downsampling (reference src/QFed/testEncoder.py:20-40),
chunk-average pooling (reference src/QFed/qAngle.py:9-24), and PCA fitted on
the training set (the reference's roadmap Phase-1 spec, ROADMAP.md:19 —
"standardize, PCA, save transformer" — which also fixes the reference quirk
of per-sample min-max normalization inside the encoder, SURVEY.md §7.4).

All transforms are numpy on host (one-time data prep); outputs feed the
static client layout in ``partition.pack_clients``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


def filter_classes(x: np.ndarray, y: np.ndarray, classes) -> tuple[np.ndarray, np.ndarray]:
    """Keep only ``classes`` and remap labels to 0..k-1 (reference
    Preprocess.py:176-182 keeps digits (0,1,2) by default)."""
    classes = list(classes)
    keep = np.isin(y, classes)
    x, y = x[keep], y[keep]
    remap = np.zeros(int(max(classes)) + 1, dtype=np.int32)
    for new, old in enumerate(classes):
        remap[old] = new
    return x, remap[y]


def normalize_images(x: np.ndarray) -> np.ndarray:
    """uint8 [0,255] → float32 [0,1] (reference Preprocess.py:178)."""
    return np.asarray(x, dtype=np.float32) / 255.0


def stratified_split(
    x: np.ndarray, y: np.ndarray, frac: float, seed: int = 42
) -> tuple[tuple[np.ndarray, np.ndarray], tuple[np.ndarray, np.ndarray]]:
    """Per-class shuffled split; returns ((rest_x, rest_y), (held_x, held_y)).

    Same capability as the reference's sklearn ``train_test_split(...,
    stratify=y)`` call (Preprocess.py:187-189), implemented directly.
    """
    rng = np.random.default_rng(seed)
    held_idx = []
    for cls in np.unique(y):
        cls_idx = rng.permutation(np.flatnonzero(y == cls))
        n_held = int(round(frac * len(cls_idx)))
        held_idx.append(cls_idx[:n_held])
    held = np.concatenate(held_idx) if held_idx else np.empty(0, dtype=np.int64)
    held_mask = np.zeros(len(y), dtype=bool)
    held_mask[held] = True
    return (x[~held_mask], y[~held_mask]), (x[held_mask], y[held_mask])


def block_downsample(images: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Block-average (N, H, W[, C]) images to (N, out_h, out_w[, C]).

    Capability of reference testEncoder.py:20-40 (28×28 → 4×4 block mean,
    including non-integer strides), vectorized over the batch via edge-index
    binning instead of a per-pixel Python loop.
    """
    images = np.asarray(images)
    squeeze = images.ndim == 3
    if squeeze:
        images = images[..., None]
    n, h, w, c = images.shape
    ys = (np.arange(h) * out_h) // h
    xs = (np.arange(w) * out_w) // w
    out = np.zeros((n, out_h, out_w, c), dtype=np.float64)
    cnt = np.zeros((out_h, out_w), dtype=np.int64)
    np.add.at(cnt, (ys[:, None].repeat(w, 1), xs[None, :].repeat(h, 0)), 1)
    np.add.at(
        out.transpose(1, 2, 0, 3),
        (ys[:, None].repeat(w, 1), xs[None, :].repeat(h, 0)),
        images.transpose(1, 2, 0, 3),
    )
    out /= cnt[None, :, :, None]
    out = out.astype(np.float32)
    return out[..., 0] if squeeze else out


def pool_features(v: np.ndarray, n_features: int) -> np.ndarray:
    """Chunk-average the last axis down to ``n_features`` (zero-pad if
    shorter). Batched equivalent of reference qAngle.py:9-24."""
    v = np.asarray(v, dtype=np.float32)
    L = v.shape[-1]
    if n_features >= L:
        pad = [(0, 0)] * (v.ndim - 1) + [(0, n_features - L)]
        return np.pad(v, pad)
    chunk = L // n_features
    out = np.empty(v.shape[:-1] + (n_features,), dtype=np.float32)
    for i in range(n_features):
        start = i * chunk
        end = (i + 1) * chunk if i < n_features - 1 else L
        out[..., i] = v[..., start:end].mean(axis=-1)
    return out


@dataclass
class PCATransform:
    """Standardize + PCA fitted on the training set (ROADMAP.md:19)."""

    mean: np.ndarray = field(default=None)  # type: ignore[assignment]
    scale: np.ndarray = field(default=None)  # type: ignore[assignment]
    components: np.ndarray = field(default=None)  # type: ignore[assignment]

    @classmethod
    def fit(cls, x: np.ndarray, n_components: int) -> "PCATransform":
        x = np.asarray(x, dtype=np.float64).reshape(len(x), -1)
        mean = x.mean(axis=0)
        scale = x.std(axis=0)
        scale[scale == 0] = 1.0
        xs = (x - mean) / scale
        # SVD of the centered/standardized data; top right-singular vectors.
        _, _, vt = np.linalg.svd(xs, full_matrices=False)
        return cls(
            mean=mean.astype(np.float32),
            scale=scale.astype(np.float32),
            components=vt[:n_components].astype(np.float32),
        )

    def __call__(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, dtype=np.float32).reshape(len(x), -1)
        return ((x - self.mean) / self.scale) @ self.components.T


def minmax_fit(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-feature (lo, hi) fitted on training data — used to map features
    to rotation angles in [0, π] *consistently across samples* (fixing the
    reference's per-sample min-max inside angle_encode, qAngle.py:36-41)."""
    x = np.asarray(x, dtype=np.float32).reshape(len(x), -1)
    lo, hi = x.min(axis=0), x.max(axis=0)
    hi = np.where(hi == lo, lo + 1.0, hi)
    return lo, hi


def minmax_apply(x: np.ndarray, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    x = np.asarray(x, dtype=np.float32).reshape(len(x), -1)
    return np.clip((x - lo) / (hi - lo), 0.0, 1.0)


@dataclass
class Preprocessed:
    train: tuple[np.ndarray, np.ndarray]
    val: tuple[np.ndarray, np.ndarray]
    test: tuple[np.ndarray, np.ndarray]
    num_classes: int

    def save(self, path) -> None:
        """Persist all splits to one compressed .npz (the reference saves
        train/val/test.pt via torch.save, Preprocess.py:192-199)."""
        np.savez_compressed(
            path,
            train_x=self.train[0], train_y=self.train[1],
            val_x=self.val[0], val_y=self.val[1],
            test_x=self.test[0], test_y=self.test[1],
            num_classes=np.int64(self.num_classes),
        )

    @classmethod
    def load(cls, path) -> "Preprocessed":
        with np.load(path) as d:
            return cls(
                train=(d["train_x"], d["train_y"]),
                val=(d["val_x"], d["val_y"]),
                test=(d["test_x"], d["test_y"]),
                num_classes=int(d["num_classes"]),
            )


def preprocess(
    train_xy,
    test_xy,
    classes=None,
    val_split: float = 0.1,
    features: str = "image",
    n_features: int | None = None,
    seed: int = 42,
) -> Preprocessed:
    """End-to-end preprocessing (reference Preprocess.py:137-228 parity).

    ``features``: "image" keeps (N, H, W[, C]) images (CNN path, channel dim
    added by the model); "downsample" block-averages to √n_features per side
    then flattens; "pool" chunk-averages the flat image; "pca" standardizes
    + projects (quantum path; ROADMAP.md:19).
    """
    from qfedx_tpu_torch import obs

    with obs.span("data.preprocess", features=features):
        return _preprocess(
            train_xy, test_xy, classes, val_split, features, n_features, seed
        )


def _preprocess(
    train_xy, test_xy, classes, val_split, features, n_features, seed
) -> Preprocessed:
    (tx, ty), (ex, ey) = train_xy, test_xy
    if classes is not None:
        tx, ty = filter_classes(tx, ty, classes)
        ex, ey = filter_classes(ex, ey, classes)
        num_classes = len(list(classes))
    else:
        num_classes = int(max(ty.max(), ey.max())) + 1
    tx, ex = normalize_images(tx), normalize_images(ex)

    if features == "downsample":
        assert n_features is not None
        side = int(round(n_features**0.5))
        assert side * side == n_features, "downsample needs a square feature count"
        tx = block_downsample(tx, side, side).reshape(len(tx), -1)
        ex = block_downsample(ex, side, side).reshape(len(ex), -1)
    elif features == "pool":
        assert n_features is not None
        tx = pool_features(tx.reshape(len(tx), -1), n_features)
        ex = pool_features(ex.reshape(len(ex), -1), n_features)
    elif features == "pca":
        assert n_features is not None
        pca = PCATransform.fit(tx, n_features)
        tx, ex = pca(tx), pca(ex)
        lo, hi = minmax_fit(tx)
        tx, ex = minmax_apply(tx, lo, hi), minmax_apply(ex, lo, hi)
    elif features != "image":
        raise ValueError(f"unknown feature mode {features!r}")

    (tr_x, tr_y), (va_x, va_y) = stratified_split(tx, ty, val_split, seed)
    return Preprocessed(
        train=(tr_x, tr_y.astype(np.int32)),
        val=(va_x, va_y.astype(np.int32)),
        test=(ex, ey.astype(np.int32)),
        num_classes=num_classes,
    )
