"""Taubin mesh smoothing (port of pytorch3d_tpu/ops/mesh_filtering.py):
alternating lambda / mu steps of the norm-weighted (1 / edge length)
neighbour average, each a pair of `index_add_` segment sums over the
packed edges."""

from __future__ import annotations

import torch

from ..common.math_utils import safe_norm


def _segment_sum(values: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    return values.new_zeros((n,) + tuple(values.shape[1:])).index_add_(0, ids, values)


def _norm_weighted_average(verts: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """Each vertex's neighbours averaged with weights 1 / |edge| (0 for a
    zero-length or padding edge)."""
    V = verts.shape[0]
    valid = torch.all(edges >= 0, dim=-1)
    e0 = torch.where(valid, edges[:, 0], 0)
    e1 = torch.where(valid, edges[:, 1], 0)
    d = safe_norm(verts[e0] - verts[e1], dim=1)
    w = torch.where(d > 0, 1.0 / torch.where(d > 0, d, 1.0), 0.0)
    w = torch.where(valid, w, 0.0)
    num = _segment_sum(w[:, None] * verts[e1], e0, V) + _segment_sum(w[:, None] * verts[e0], e1, V)
    den = _segment_sum(w, e0, V) + _segment_sum(w, e1, V)
    return num / den.clamp(min=1e-10)[:, None]


def taubin_smoothing(meshes, lambd: float = 0.53, mu: float = -0.53, num_iter: int = 10):
    """Taubin smoothing of every mesh of the batch; returns a new `Meshes`."""
    verts = meshes.verts_packed()  # (N*V, 3)
    edges = meshes.edges_packed()
    vmask = meshes.verts_packed_mask()[:, None]
    for _ in range(num_iter):
        for coef in (lambd, mu):
            avg = _norm_weighted_average(verts, edges)
            verts = torch.where(vmask, (1 - coef) * verts + coef * avg, verts)
    N, V = meshes.verts_padded().shape[:2]
    return meshes.update_padded(verts.reshape(N, V, 3))
