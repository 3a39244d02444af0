"""Port vs reference: the data modules (qfedx_tpu_torch/data/).

The port keeps numpy copies of the reference's data modules, so every
output array must equal the reference's BIT FOR BIT — same values, same
dtype, same shape — on the same seeded inputs: the synthetic datasets,
the bundled iris table, IDX files written here, the iid and Dirichlet
partitions, the packed client layout and its label table, and every
preprocessing mode.
"""

import struct

import numpy as np
import pytest

from qfedx_tpu.data import datasets as rdatasets
from qfedx_tpu.data import idx as ridx
from qfedx_tpu.data import partition as rpartition
from qfedx_tpu.data import pipeline as rpipeline
from qfedx_tpu_torch.data import datasets as pdatasets
from qfedx_tpu_torch.data import idx as pidx
from qfedx_tpu_torch.data import partition as ppartition
from qfedx_tpu_torch.data import pipeline as ppipeline


def _same(a, b):
    """Bit-for-bit equality of (nested tuples/lists of) arrays."""
    if isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("name,seed", [
    ("mnist", 0), ("mnist", 7), ("fashion_mnist", 3), ("cifar10", 1),
    ("iris", 0), ("iris", 5),
])
def test_load_dataset_matches_reference(name, seed):
    kw = dict(synthetic_train=48, synthetic_test=16, synthetic_noise=0.3,
              seed=seed)
    rspec, rtrain, rtest = rdatasets.load_dataset(name, **kw)
    pspec, ptrain, ptest = pdatasets.load_dataset(name, **kw)
    assert tuple(rspec.__dict__.values()) == tuple(pspec.__dict__.values())
    _same((rtrain, rtest), (ptrain, ptest))


def _write_idx(path, arr, code):
    with open(path, "wb") as f:
        f.write(struct.pack(">BBBB", 0, 0, code, arr.ndim))
        f.write(struct.pack(f">{arr.ndim}I", *arr.shape))
        f.write(arr.tobytes())


@pytest.mark.parametrize("dtype,code", [
    (np.uint8, 0x08), (np.int8, 0x09), (">i2", 0x0B), (">i4", 0x0C),
    (">f4", 0x0D), (">f8", 0x0E),
])
def test_read_idx_matches_reference(tmp_path, dtype, code):
    arr = (np.random.default_rng(code).normal(size=(3, 5, 4)) * 50).astype(
        dtype)
    _write_idx(tmp_path / "t.idx", arr, code)
    _same(ridx.read_idx(tmp_path / "t.idx"), pidx.read_idx(tmp_path / "t.idx"))


def test_load_dataset_from_idx_files_matches_reference(tmp_path):
    rng = np.random.default_rng(4)
    for split, n in (("train", 30), ("t10k", 10)):
        _write_idx(tmp_path / f"{split}-images.idx3-ubyte",
                   rng.integers(0, 256, (n, 28, 28), dtype=np.uint8), 0x08)
        _write_idx(tmp_path / f"{split}-labels.idx1-ubyte",
                   rng.integers(0, 10, n, dtype=np.uint8), 0x08)
    r = rdatasets.load_dataset("mnist", raw_folder=tmp_path)
    p = pdatasets.load_dataset("mnist", raw_folder=tmp_path)
    _same(r[1:], p[1:])
    assert p[1][0].shape == (30, 28, 28)


@pytest.mark.parametrize("scheme,clients,arg,seed", [
    ("iid", 4, None, 0), ("iid", 3, None, 9),
    ("dirichlet", 4, 0.5, 0), ("dirichlet", 5, 0.1, 3),
])
def test_partitions_match_reference(scheme, clients, arg, seed):
    labels = np.random.default_rng(seed).integers(0, 3, 90)
    if scheme == "iid":
        r = rpartition.iid_partition(len(labels), clients, seed=seed)
        p = ppartition.iid_partition(len(labels), clients, seed=seed)
    else:
        r = rpartition.dirichlet_partition(labels, clients, arg, seed=seed)
        p = ppartition.dirichlet_partition(labels, clients, arg, seed=seed)
    _same(r, p)
    _same(rpartition.partition_stats(labels, r, 3),
          ppartition.partition_stats(labels, p, 3))


@pytest.mark.parametrize("max_samples,pad_multiple", [
    (None, None), (None, 8), (10, None), (10, 4),
])
def test_pack_clients_matches_reference(max_samples, pad_multiple):
    rng = np.random.default_rng(2)
    x = rng.uniform(0, 1, (40, 6)).astype(np.float32)
    y = rng.integers(0, 3, 40)
    parts = ppartition.dirichlet_partition(y, 3, 0.3, seed=1)
    _same(rpartition.pack_clients(x, y, parts, max_samples, pad_multiple),
          ppartition.pack_clients(x, y, parts, max_samples, pad_multiple))


@pytest.mark.parametrize("features,n_features,classes", [
    ("pca", 10, (0, 1)), ("pca", 4, None), ("downsample", 16, (0, 1, 2)),
    ("pool", 12, (1, 3)), ("image", None, (0, 1)),
])
def test_preprocess_matches_reference(features, n_features, classes):
    _, train, test = rdatasets.load_dataset(
        "mnist", synthetic_train=80, synthetic_test=20, seed=1)
    kw = dict(classes=classes, val_split=0.2, features=features,
              n_features=n_features, seed=5)
    r = rpipeline.preprocess(train, test, **kw)
    p = ppipeline.preprocess(train, test, **kw)
    _same((r.train, r.val, r.test), (p.train, p.val, p.test))
    assert r.num_classes == p.num_classes


def test_feature_helpers_match_reference():
    rng = np.random.default_rng(8)
    imgs = rng.uniform(0, 255, (5, 28, 28))
    _same(rpipeline.block_downsample(imgs, 3, 5),
          ppipeline.block_downsample(imgs, 3, 5))
    v = rng.normal(size=(4, 33)).astype(np.float32)
    _same(rpipeline.pool_features(v, 5), ppipeline.pool_features(v, 5))
    _same(rpipeline.pool_features(v, 40), ppipeline.pool_features(v, 40))
    rt, pt = rpipeline.PCATransform.fit(v, 3), ppipeline.PCATransform.fit(v, 3)
    _same(rt(v), pt(v))
    lo, hi = rpipeline.minmax_fit(v)
    _same((lo, hi), ppipeline.minmax_fit(v))
    _same(rpipeline.minmax_apply(v, lo, hi), ppipeline.minmax_apply(v, lo, hi))
    y = rng.integers(0, 3, 33)
    _same(rpipeline.stratified_split(v.T, y, 0.3, seed=2),
          ppipeline.stratified_split(v.T, y, 0.3, seed=2))
