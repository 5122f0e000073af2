"""Mesh Laplacian matrices: uniform, cotangent and edge-length weighted
(port of pytorch3d_tpu/ops/laplacian_matrices.py).

The matrices are `torch.sparse_coo_tensor`s (the JAX package's are BCOO)
with the same entries, duplicates included: a -1 padded edge or face row
adds zero-valued entries at (0, 0), and `to_dense()` sums duplicates as
BCOO's `todense()` does.  Degree and area sums are `index_add`.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..common.math_utils import safe_norm


def _segment_sum(values: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    return torch.zeros(n, dtype=values.dtype, device=values.device).index_add(0, ids, values)


def _sparse(rows, cols, vals, V: int) -> torch.Tensor:
    return torch.sparse_coo_tensor(torch.stack([rows, cols]), vals, (V, V), check_invariants=False)


def laplacian(verts: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """Uniform Laplacian (V, V): L[i, j] = 1/deg(i) for each edge, L[i, i]
    = -1 where deg(i) > 0.  edges: (E, 2), -1 padded rows allowed."""
    V = verts.shape[0]
    valid = (edges >= 0).all(dim=-1)
    e0 = torch.where(valid, edges[:, 0], 0).long()
    e1 = torch.where(valid, edges[:, 1], 0).long()
    ones = valid.to(verts.dtype)
    deg = _segment_sum(ones, e0, V) + _segment_sum(ones, e1, V)
    inv_deg = torch.where(deg > 0, 1.0 / torch.clamp(deg, min=1.0), 0.0)
    diag = torch.arange(V, device=verts.device)
    rows = torch.cat([e0, e1, diag])
    cols = torch.cat([e1, e0, diag])
    vals = torch.cat([
        torch.where(valid, inv_deg[e0], 0.0),
        torch.where(valid, inv_deg[e1], 0.0),
        torch.where(deg > 0, -1.0, 0.0).to(verts.dtype),
    ])
    return _sparse(rows, cols, vals, V)


def cot_laplacian(verts: torch.Tensor, faces: torch.Tensor, eps: float = 1e-12) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cotangent Laplacian and the inverse of the face areas summed per
    vertex: (L (V, V) with L[i, j] = (cot a_ij + cot b_ij) / 4 per face,
    inv_areas (V, 1)).  faces: (F, 3), -1 padded rows allowed."""
    V = verts.shape[0]
    valid = (faces >= 0).all(dim=-1)
    f = torch.clamp(faces, min=0).long()
    v0, v1, v2 = verts[f[:, 0]], verts[f[:, 1]], verts[f[:, 2]]
    A = safe_norm(v1 - v2, dim=1)
    B = safe_norm(v0 - v2, dim=1)
    C = safe_norm(v0 - v1, dim=1)
    A2, B2, C2 = A * A, B * B, C * C
    s = 0.5 * (A + B + C)
    area = torch.sqrt(torch.clamp(s * (s - A) * (s - B) * (s - C), min=eps))
    safe_area = torch.clamp(area, min=eps)
    cota = (B2 + C2 - A2) / safe_area  # opposite the edge (v1, v2)
    cotb = (A2 + C2 - B2) / safe_area  # opposite (v0, v2)
    cotc = (A2 + B2 - C2) / safe_area  # opposite (v0, v1)
    cot = torch.where(valid[:, None], torch.stack([cota, cotb, cotc], dim=1) / 4.0, 0.0)
    ii = torch.cat([f[:, 1], f[:, 2], f[:, 0]])
    jj = torch.cat([f[:, 2], f[:, 0], f[:, 1]])
    w = torch.where(valid.repeat(3), torch.cat([cot[:, 0], cot[:, 1], cot[:, 2]]), 0.0)
    L = _sparse(torch.cat([ii, jj]), torch.cat([jj, ii]), torch.cat([w, w]), V)
    face_area = torch.where(valid, area, 0.0)
    vert_area = _segment_sum(face_area, f[:, 0], V) + _segment_sum(face_area, f[:, 1], V) + _segment_sum(
        face_area, f[:, 2], V)
    inv_areas = torch.where(vert_area > 0, 1.0 / torch.clamp(vert_area, min=eps), 0.0)
    return L, inv_areas[:, None]


def norm_laplacian(verts: torch.Tensor, edges: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Edge-length-weighted Laplacian: L[i, j] = 1 / |v_i - v_j| per edge."""
    V = verts.shape[0]
    valid = (edges >= 0).all(dim=-1)
    e0 = torch.where(valid, edges[:, 0], 0).long()
    e1 = torch.where(valid, edges[:, 1], 0).long()
    d = safe_norm(verts[e0] - verts[e1], dim=1)
    w = torch.where(d > 0, 1.0 / torch.where(d > 0, d, 1.0), 0.0)
    w = torch.where(valid, w, 0.0)
    return _sparse(torch.cat([e0, e1]), torch.cat([e1, e0]), torch.cat([w, w]), V)
