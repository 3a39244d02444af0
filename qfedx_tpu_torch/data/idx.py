"""IDX (MNIST-format) binary file reader.

Counterpart of ``qfedx_tpu/data/idx.py`` (a copy, numpy only: the
port imports nothing of the JAX package).

Capability parity with the reference's hand-rolled reader
(reference src/CFed/Preprocess.py:11-20, which skips fixed 16/8-byte headers
for images/labels). This implementation parses the actual IDX header —
magic number encoding dtype + rank, followed by big-endian dimension sizes —
so it handles any IDX tensor (images, labels, Fashion-MNIST, EMNIST, ...)
rather than only the two hard-coded layouts.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

# IDX type codes → numpy dtypes (big-endian where multi-byte).
_IDX_DTYPES = {
    0x08: np.dtype(np.uint8),
    0x09: np.dtype(np.int8),
    0x0B: np.dtype(">i2"),
    0x0C: np.dtype(">i4"),
    0x0D: np.dtype(">f4"),
    0x0E: np.dtype(">f8"),
}


def read_idx(path: str | Path) -> np.ndarray:
    """Read an IDX file into a numpy array of its declared shape."""
    data = Path(path).read_bytes()
    if len(data) < 4:
        raise ValueError(f"{path}: truncated IDX header")
    zero1, zero2, type_code, rank = struct.unpack(">BBBB", data[:4])
    if zero1 != 0 or zero2 != 0:
        raise ValueError(f"{path}: bad IDX magic {data[:4]!r}")
    if type_code not in _IDX_DTYPES:
        raise ValueError(f"{path}: unknown IDX type code 0x{type_code:02x}")
    dtype = _IDX_DTYPES[type_code]
    header_end = 4 + 4 * rank
    dims = struct.unpack(f">{rank}I", data[4:header_end])
    count = int(np.prod(dims)) if dims else 0
    body = np.frombuffer(data, dtype=dtype, count=count, offset=header_end)
    if body.size != count:
        raise ValueError(
            f"{path}: expected {count} elements for shape {dims}, got {body.size}"
        )
    return body.reshape(dims)


def read_idx_images(path: str | Path) -> np.ndarray:
    """Images as (N, H, W) uint8 (reference Preprocess.py:11-15 equivalent)."""
    arr = read_idx(path)
    if arr.ndim != 3:
        raise ValueError(f"{path}: expected rank-3 image tensor, got {arr.shape}")
    return arr


def read_idx_labels(path: str | Path) -> np.ndarray:
    """Labels as (N,) uint8 (reference Preprocess.py:17-20 equivalent)."""
    arr = read_idx(path)
    if arr.ndim != 1:
        raise ValueError(f"{path}: expected rank-1 label tensor, got {arr.shape}")
    return arr
