"""Closed-form eigendecomposition of symmetric 3x3 matrices (port of
pytorch3d_tpu/common/symeig3x3.py).

The JAX package's algorithm, step for step, so that both give the same
values element by element (not `torch.linalg.eigh`): eigenvalues from the
trigonometric solution of the characteristic cubic (Smith 1961),
eigenvectors from cross products of shifted-matrix rows, all branch-free.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def _pick(cands: torch.Tensor, scores: torch.Tensor) -> torch.Tensor:
    """The row of cands (..., 3, 3) at the first largest score (..., 3),
    blended by a one-hot as the JAX package does."""
    best = torch.argmax(scores, dim=-1)
    onehot = (best[..., None] == torch.arange(3, device=scores.device)).to(cands.dtype)
    return torch.sum(cands * onehot[..., None], dim=-2)


def _eigenvalues(A: torch.Tensor, eps: float) -> torch.Tensor:
    """Eigenvalues of symmetric (..., 3, 3), ascending, shape (..., 3)."""
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    q = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1) / 3.0
    B = A - q[..., None, None] * eye
    p2 = torch.sum(B * B, dim=(-2, -1)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=eps))
    # r = det(B) / (2 p^3), clipped into acos' domain.
    r = torch.linalg.det(B) / (2.0 * p * p * p)
    r = torch.clamp(r, -1.0 + eps, 1.0 - eps)
    phi = torch.arccos(r) / 3.0
    eig1 = q + 2.0 * p * torch.cos(phi)  # largest
    eig3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)  # smallest
    eig2 = 3.0 * q - eig1 - eig3
    evals = torch.stack([eig3, eig2, eig1], dim=-1)
    # Degenerate (near-spherical) case: all eigenvalues equal q.
    return torch.where((p2 < eps)[..., None], q[..., None].expand_as(evals), evals)


def _robust_eigenvector(A_shift: torch.Tensor, eps: float) -> torch.Tensor:
    """Null-space direction of a (near-)rank-2 symmetric matrix: the largest
    of the three pairwise cross products of its rows, with rank-1 and
    rank-0 fallbacks."""
    r0, r1, r2 = A_shift[..., 0, :], A_shift[..., 1, :], A_shift[..., 2, :]
    cands = torch.stack([_cross(r0, r1), _cross(r1, r2), _cross(r2, r0)], dim=-2)
    v = _pick(cands, torch.sum(cands * cands, dim=-1))
    vnorm2 = torch.sum(v * v, dim=-1, keepdim=True)
    v = v / torch.sqrt(torch.clamp(vnorm2, min=eps))

    # Rank 1 (eigenvalue multiplicity 2): every row cross product vanishes;
    # the null space is the plane orthogonal to the largest row.
    rows = A_shift
    row_norms = torch.sum(rows * rows, dim=-1)
    u = _pick(rows, row_norms)
    eye = torch.eye(3, dtype=A_shift.dtype, device=A_shift.device)
    w0, w1 = _cross(u, eye[0]), _cross(u, eye[1])
    w0n2 = torch.sum(w0 * w0, dim=-1, keepdim=True)
    w1n2 = torch.sum(w1 * w1, dim=-1, keepdim=True)
    w = torch.where(w0n2 > w1n2, w0, w1)
    w = w / torch.sqrt(torch.clamp(torch.maximum(w0n2, w1n2), min=eps))

    # Rank 0 (spherical): any unit vector.
    rank1 = vnorm2[..., 0] < eps
    rank0 = rank1 & (row_norms.amax(dim=-1) < eps)
    out = torch.where(rank1[..., None], w, v)
    return torch.where(rank0[..., None], eye[0].expand_as(v), out)


def symeig3x3(
    inputs: torch.Tensor, eigenvectors: bool = True, eps: Optional[float] = None
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Eigenvalues (ascending) and optionally eigenvectors of symmetric 3x3.

    Args:
        inputs: (..., 3, 3) symmetric matrices.
        eigenvectors: also return eigenvectors as columns of (..., 3, 3).
        eps: numerical floor; 1e-10 by default.

    Returns:
        (eigenvalues (..., 3), eigenvectors (..., 3, 3) or None); column
        eigenvectors[..., :, i] belongs to eigenvalues[..., i].
    """
    if inputs.shape[-2:] != (3, 3):
        raise ValueError("Only inputs of shape (..., 3, 3) are supported.")
    if eps is None:
        eps = 1e-10
    A = 0.5 * (inputs + inputs.transpose(-1, -2))
    # Scale for conditioning (keeps the cubic well-behaved across magnitudes).
    scale = torch.clamp(A.abs().amax(dim=(-2, -1), keepdim=True), min=eps)
    As = A / scale
    evals = _eigenvalues(As, eps)
    if not eigenvectors:
        return evals * scale[..., 0], None

    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    # First eigenvector from (A - l0 I), third from (A - l2 I); the second
    # is their cross product.
    v0 = _robust_eigenvector(As - evals[..., 0, None, None] * eye, eps)
    v2 = _robust_eigenvector(As - evals[..., 2, None, None] * eye, eps)
    # Re-orthogonalize v2 against v0 (l0 ~ l2: near-spherical).
    v2 = v2 - torch.sum(v0 * v2, dim=-1, keepdim=True) * v0
    v2n2 = torch.sum(v2 * v2, dim=-1, keepdim=True)
    # If v2 collapsed (all eigenvalues equal), an arbitrary orthogonal one.
    fallback = _cross(v0, eye[0])
    fallback_n2 = torch.sum(fallback * fallback, dim=-1, keepdim=True)
    alt = _cross(v0, eye[1])
    alt_n2 = torch.sum(alt * alt, dim=-1, keepdim=True)
    fallback = torch.where(
        fallback_n2 > 0.01,
        fallback / torch.sqrt(torch.clamp(fallback_n2, min=eps)),
        alt / torch.sqrt(torch.clamp(alt_n2, min=eps)),
    )
    collapsed = v2n2[..., 0] < 1e-6
    v2 = torch.where(collapsed[..., None], fallback, v2 / torch.sqrt(torch.clamp(v2n2, min=eps)))
    v1 = _cross(v2, v0)
    return evals * scale[..., 0], torch.stack([v0, v1, v2], dim=-1)
