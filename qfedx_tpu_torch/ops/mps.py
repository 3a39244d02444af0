"""Matrix-product-state (MPS) simulator — past the dense 2^n wall.

Counterpart of ``qfedx_tpu/ops/mps.py``. An MPS is n small real tensors,
every gate a small contraction, memory O(n·χ²) instead of O(2^n), so
24- and 32-qubit circuits run where a dense state would not fit. It
simulates the real-amplitudes family only (RY rotations and CNOT lines
on RY-encoded product states: everything stays in ℝ, in f32 whatever
``QFEDX_DTYPE`` says, as the reference's ``RDTYPE``).

Representation: a list of n site tensors, each (B, χ, 2, χ) — the
reference's (n, χ, 2, χ) array per sample, with the batch as a leading
axis where the reference vmaps one sample. Site k holds A[k][b, l, s, r]
with a uniform zero-padded bond dimension χ; the boundary bonds use
index 0. Sites are replaced, never written in place, so autograd's saved
tensors stay valid. Truncation after each two-site gate is
``ops/linalg.truncated_svd`` (batched, with the broadened backward).

Gate order is the open line: CNOT (k→k+1) for k = 0..n−2.

**One deliberate difference from the reference: the split's null space
is zeroed.** An SVD returns U's columns for the (numerically) zero
singular values as an arbitrary orthonormal completion, whichever basis
the routine happens to pick. The reference keeps them in the left site;
they multiply zero rows of the right one, so the state does not see
them, but they reach the NEXT two-site matrices merged across that bond,
inflate their rank and compete in their truncation. So the reference's
⟨Z⟩ at χ < 2^{n/2}, and its gradients from L = 2 on even at χ = 2^{n/2},
depend on the SVD routine: rotating that null basis moves its logits by
~0.4 at n = 8, χ = 16, and its ∂/∂θ misses the dense engine's by
0.02–1.6 at n = 4–8, L = 2, where LAPACK, XLA and cuSOLVER choose
differently (``tests/test_torch_mps.py``). ``apply_2q_neighbor`` zeroes
U's columns and S below ``NULL_RTOL``·s_max (f32 SVD noise sits at
≤ 1e-6·s_max, the singular values of these circuits at ≥ 1e-4·s_max): the
state is unchanged, the result no longer depends on the routine, and at
L ≤ 2 the gradient equals the dense engine's. From L = 3 on the
broadened backward still misses it (0.001–0.7 at n = 6–7, in both
packages; ROADMAP Queue 3).
"""

from __future__ import annotations

import torch

from qfedx_tpu_torch.ops.linalg import truncated_svd

RDTYPE = torch.float32
# Singular values at or below this fraction of the largest are the
# split's null space (see the module docstring).
NULL_RTOL = 1e-5


def _cnot() -> torch.Tensor:
    """CNOT as a (2,2,2,2) real tensor G[s1', s2', s1, s2], control =
    index 1."""
    g = torch.zeros((2, 2, 2, 2), dtype=RDTYPE)
    for c in range(2):
        for t in range(2):
            g[c, t ^ c, c, t] = 1.0
    return g


_CNOT = _cnot()


def product_mps(amps: torch.Tensor, chi: int) -> list[torch.Tensor]:
    """Product state from per-qubit 2-vectors: amps (B, n, 2) → n sites of
    (B, χ, 2, χ)."""
    bsz, n = amps.shape[0], amps.shape[1]
    sites = []
    for k in range(n):
        a = amps.new_zeros((bsz, chi, 2, chi), dtype=RDTYPE)
        a[:, 0, :, 0] = amps[:, k].to(RDTYPE)
        sites.append(a)
    return sites


def zero_mps(n: int, chi: int, batch: int = 1,
             device=None) -> list[torch.Tensor]:
    """|0…0⟩ for ``batch`` samples."""
    amps = torch.zeros((batch, n, 2), dtype=RDTYPE, device=device)
    amps[..., 0] = 1.0
    return product_mps(amps, chi)


def apply_1q(sites: list, k: int, g: torch.Tensor) -> list[torch.Tensor]:
    """Real 2×2 gate on site k: A_k[b,l,s,r] ← Σ_t g[s,t] A_k[b,l,t,r]."""
    out = list(sites)
    out[k] = torch.einsum("st,bltr->blsr", g, sites[k])
    return out


def apply_1q_all(sites: list, gs: torch.Tensor) -> list[torch.Tensor]:
    """Per-site 2×2 gates, gs (n, 2, 2) shared by the batch."""
    return [torch.einsum("st,bltr->blsr", g, a) for g, a in zip(gs, sites)]


def apply_2q_neighbor(sites: list, k: int, g4: torch.Tensor,
                      eps: float = 1e-10) -> list[torch.Tensor]:
    """Real two-site gate G[s1',s2',s1,s2] on (k, k+1), SVD-truncated to
    χ: merge → gate → split (one batched SVD of B (2χ, 2χ) matrices),
    the null space zeroed, singular values absorbed into the right
    tensor; not renormalized (the readout divides by the norm)."""
    a, b = sites[k], sites[k + 1]
    bsz, chi = a.shape[0], a.shape[1]
    theta = torch.einsum("zlsm,zmtr->zlstr", a, b)  # (B, χ, 2, 2, χ)
    theta = torch.einsum("uvst,zlstr->zluvr", g4.to(a.device), theta)
    u, s, vh = truncated_svd(theta.reshape(bsz, 2 * chi, 2 * chi), chi, eps)
    live = (s > NULL_RTOL * s[..., :1]).to(s.dtype)
    u, s = u * live[..., None, :], s * live
    out = list(sites)
    out[k] = u.reshape(bsz, chi, 2, chi)
    out[k + 1] = (s[..., :, None] * vh).reshape(bsz, chi, 2, chi)
    return out


def apply_cnot_chain(sites: list) -> list[torch.Tensor]:
    """CNOT (k→k+1) for k = 0..n−2 — the line entangler: n − 1 batched
    SVDs."""
    for k in range(len(sites) - 1):
        sites = apply_2q_neighbor(sites, k, _CNOT)
    return sites


def _boundary(site: torch.Tensor) -> torch.Tensor:
    """The (B, χ, χ) transfer boundary e₀e₀ᵀ."""
    bsz, chi = site.shape[0], site.shape[1]
    e = site.new_zeros((bsz, chi, chi))
    e[:, 0, 0] = 1.0
    return e


def _transfer(left: torch.Tensor, site: torch.Tensor,
              weight: torch.Tensor | None = None) -> torch.Tensor:
    """L' = Σ_s w_s · A[s]ᵀ L A[s] — one site of the norm/⟨Z⟩
    contraction."""
    if weight is None:
        return torch.einsum("zlm,zlsa,zmsc->zac", left, site, site)
    return torch.einsum("s,zlm,zlsa,zmsc->zac", weight, left, site, site)


def norm_sq(sites: list) -> torch.Tensor:
    """⟨ψ|ψ⟩ per sample, (B,) (truncation makes it < 1)."""
    left = _boundary(sites[0])
    for a in sites:
        left = _transfer(left, a)
    return left[:, 0, 0]


def expect_z_all(sites: list) -> torch.Tensor:
    """⟨Z_k⟩/⟨ψ|ψ⟩ for every site, (B, n): one prefix sweep and one
    suffix sweep of transfer matrices, O(n·χ³) per sample."""
    n = len(sites)
    z = torch.tensor([1.0, -1.0], dtype=RDTYPE, device=sites[0].device)
    lefts = [_boundary(sites[0])]
    for a in sites:
        lefts.append(_transfer(lefts[-1], a))
    rights = [_boundary(sites[0])]
    for a in reversed(sites):
        # Suffix transfer: R' = Σ_s A[s] R A[s]ᵀ.
        rights.append(torch.einsum("zac,zlsa,zmsc->zlm", rights[-1], a, a))
    rights.reverse()  # rights[k] closes sites k..n−1
    nrm = lefts[n][:, 0, 0]
    out = [torch.sum(_transfer(lefts[k], sites[k], z) * rights[k + 1],
                     dim=(-2, -1)) for k in range(n)]
    return torch.stack(out, dim=-1) / torch.clamp(nrm, min=1e-12)[:, None]
