"""Differentiable linear algebra: a thin SVD with a safe backward.

Counterpart of ``qfedx_tpu/ops/linalg.py`` (``safe_svd``,
``truncated_svd``). The MPS engine (``ops/mps.py``) splits two-site
tensors with an SVD after every entangling gate, and those matrices are
structurally rank-deficient (a product state through a CNOT has one
nonzero singular value; padded bonds add exact zeros). The stock
reverse-mode formula divides by s_j² − s_i² and by s, so it gives inf or
NaN exactly where every training run starts (small-angle init ≈ product
states). ``safe_svd`` keeps the formula with every singular inverse x⁻¹
broadened to x/(x² + ε) (Lorentzian broadening, as in differentiable
DMRG): at separated spectra it agrees with the exact gradient to O(ε),
at degeneracies it stays finite.

Real f32, batched over leading axes; the forward is
``torch.linalg.svd(m, full_matrices=False)``, which on the card is
cuSOLVER's batched SVD.
"""

from __future__ import annotations

import torch


def _t(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(-1, -2)


def safe_svd_bwd(u, s, vh, du, ds, dvh, eps: float = 1e-10):
    """The broadened SVD cotangent: (U, S, Vh) of M (…, m, p) with k =
    min(m, p), and the cotangents of the three (None = zero) → M̄.

        M̄ = U [F∘(UᵀŪ − ŪᵀU) S + S F∘(VᵀV̄ − V̄ᵀV) + diag(S̄)] Vh
            + (I − UUᵀ) Ū S⁻¹ Vh            (m > k)
            + U S⁻¹ V̄ᵀ (I − VVᵀ)            (p > k)

    with F_ij = 1/(s_j² − s_i²) and S⁻¹ both broadened (x → x/(x² + ε),
    F's diagonal zero)."""
    du = torch.zeros_like(u) if du is None else du
    ds = torch.zeros_like(s) if ds is None else ds
    dvh = torch.zeros_like(vh) if dvh is None else dvh
    v, dv = _t(vh), _t(dvh)
    k = s.shape[-1]
    s2 = s * s
    diff = s2[..., None, :] - s2[..., :, None]  # s_j² − s_i²
    f = diff / (diff * diff + eps)
    f = f * (1.0 - torch.eye(k, dtype=f.dtype, device=f.device))
    sinv = s / (s2 + eps)

    utdu = _t(u) @ du
    vtdv = _t(v) @ dv
    su = f * (utdu - _t(utdu))
    sv = f * (vtdv - _t(vtdv))
    mid = (su * s[..., None, :] + s[..., :, None] * sv
           + torch.diag_embed(ds))
    dm = u @ mid @ vh
    m_, p = u.shape[-2], v.shape[-2]
    if m_ > k:  # the column-space complement of U contributes
        proj_u = torch.eye(m_, dtype=u.dtype, device=u.device) - u @ _t(u)
        dm = dm + ((proj_u @ du) * sinv[..., None, :]) @ vh
    if p > k:  # the row-space complement of V contributes
        proj_v = torch.eye(p, dtype=v.dtype, device=v.device) - v @ _t(v)
        dm = dm + ((u * sinv[..., None, :]) @ _t(dv)) @ proj_v
    return dm


class SafeSVD(torch.autograd.Function):
    """Thin SVD (U, S, Vh) of a real (…, m, p) matrix whose backward is
    ``safe_svd_bwd``."""

    @staticmethod
    def forward(ctx, m, eps):
        u, s, vh = torch.linalg.svd(m, full_matrices=False)
        ctx.save_for_backward(u, s, vh)
        ctx.eps = eps
        return u, s, vh

    @staticmethod
    def backward(ctx, du, ds, dvh):
        u, s, vh = ctx.saved_tensors
        return safe_svd_bwd(u, s, vh, du, ds, dvh, ctx.eps), None


def safe_svd(m: torch.Tensor, eps: float = 1e-10):
    """Thin SVD of a real (…, m, p) matrix with NaN-free gradients."""
    return SafeSVD.apply(m, eps)


def truncated_svd(m: torch.Tensor, chi: int, eps: float = 1e-10):
    """``safe_svd`` truncated to the top-``chi`` singular triples:
    (U[…, :, :χ], S[…, :χ], Vh[…, :χ, :]). The slices come after the
    Function, so autograd pads the discarded triples' cotangents with
    zeros, as the reference's slices after its custom_vjp do."""
    u, s, vh = safe_svd(m, eps)
    return u[..., :, :chi], s[..., :chi], vh[..., :chi, :]
