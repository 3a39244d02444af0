"""Complex arithmetic as real (re, im) float pairs.

Counterpart of ``qfedx_tpu/ops/cpx.py``. A statevector is a ``CArray``:
a NamedTuple of two real tensors with the reference's layouts
(``(B, 2^n)`` batched slabs, ``(B, R, 128)`` kernel blocks). The kernel
multiplies real matrices, so the pair form is what it consumes; and
``im=None`` marks a known-real value (RY rotations, CNOTs, the
angle-encoded product state) whose cross terms every op skips.

States are f32 by default; ``QFEDX_DTYPE=bf16`` (or ``bfloat16``) makes
them bf16 — the reference's bf16-state / f32-accumulate recipe: gate
coefficients and parameters stay f32 (``RDTYPE``) and are cast where
they are applied, every product accumulates in f32 and rounds to bf16,
and readout reductions take the state to f32 first.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from qfedx_tpu_torch.utils import pins

RDTYPE = torch.float32


def state_dtype() -> torch.dtype:
    """dtype of statevector slabs: QFEDX_DTYPE=bf16|bfloat16 gives
    ``torch.bfloat16``, anything else (the default) ``torch.float32`` —
    the reference's grammar. Read at every call."""
    return (
        torch.bfloat16
        if pins.str_pin("QFEDX_DTYPE", "float32") in ("bf16", "bfloat16")
        else torch.float32
    )


class CArray(NamedTuple):
    """Complex tensor as (re, im); ``im=None`` ⇒ imaginary part is zero."""

    re: torch.Tensor
    im: torch.Tensor | None = None

    @property
    def shape(self):
        return self.re.shape

    @property
    def ndim(self):
        return self.re.ndim

    def imag_or_zeros(self) -> torch.Tensor:
        return torch.zeros_like(self.re) if self.im is None else self.im


def from_complex(x, device=None) -> CArray:
    """numpy complex array → CArray on ``device`` (None = the card)."""
    dev = pins.resolve_device(device)
    x = np.asarray(x)
    return CArray(
        torch.as_tensor(np.ascontiguousarray(x.real), dtype=RDTYPE,
                        device=dev),
        torch.as_tensor(np.ascontiguousarray(x.imag), dtype=RDTYPE,
                        device=dev),
    )


def to_complex(c: CArray) -> np.ndarray:
    """CArray → numpy complex64 (host/test convenience)."""
    re = c.re.detach().cpu().numpy()
    im = np.zeros_like(re) if c.im is None else c.im.detach().cpu().numpy()
    return (re + 1j * im).astype(np.complex64)


def cmul(a: CArray, b: CArray) -> CArray:
    """Elementwise complex multiply with known-real shortcuts."""
    if a.im is None and b.im is None:
        return CArray(a.re * b.re, None)
    if a.im is None:
        return CArray(a.re * b.re, a.re * b.im)
    if b.im is None:
        return CArray(a.re * b.re, a.im * b.re)
    return CArray(a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re)
