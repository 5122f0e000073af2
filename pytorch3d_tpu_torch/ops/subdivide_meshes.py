"""Loop-style 1 -> 4 mesh subdivision (port of pytorch3d_tpu/ops/subdivide_meshes.py).

Each mesh keeps the static capacities of the JAX package: a vertex buffer of
V + 3F (the edge midpoints follow the mesh's own vertices; unique edges are
at most 3F) and a face buffer of 4F, with per-mesh counts, so the padded
layout stays prefix-contiguous.  The unique edges come from the same
lexsorted dedup as `Meshes` (a stable sort by the larger endpoint, then by
the smaller), so the midpoints, and the new vertices, come in JAX's order.
The batch runs at once, each mesh along its own row.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..structures.meshes import Meshes


def _rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table (N, R, C), ids (N, K) -> (N, K, C): each mesh's rows."""
    return torch.gather(table, 1, ids[..., None].expand(-1, -1, table.shape[-1]))


def _subdivide(verts, faces, nv, nf, feats: Optional[torch.Tensor]):
    """verts (N, V, 3), faces (N, F, 3) local ids (-1 padded), counts (N,),
    feats (N, V, D) or None -> the subdivided padded tensors and counts."""
    N, V, _ = verts.shape
    F = faces.shape[1]
    device = verts.device
    valid = torch.all(faces >= 0, dim=-1)  # (N, F)

    # Unique edges per mesh, as Meshes' edges: (v1, v2), (v0, v2), (v0, v1).
    edges_all = torch.cat([faces[:, :, 1:3], faces[:, :, 0:3:2], faces[:, :, 0:2]], dim=1)  # (N, 3F, 2)
    valid_all = valid.repeat(1, 3)
    a = torch.where(valid_all, edges_all.amin(dim=-1), V)
    b = torch.where(valid_all, edges_all.amax(dim=-1), V)
    order = torch.sort(b, dim=1, stable=True).indices
    order = torch.gather(order, 1, torch.sort(torch.gather(a, 1, order), dim=1, stable=True).indices)
    a_s, b_s = torch.gather(a, 1, order), torch.gather(b, 1, order)
    first = torch.ones_like(a_s, dtype=torch.bool)
    first[:, 1:] = (a_s[:, 1:] != a_s[:, :-1]) | (b_s[:, 1:] != b_s[:, :-1])
    uniq = first & (a_s < V)
    ranks = torch.cumsum(uniq, dim=1) - 1
    n_edges = uniq.sum(dim=1)

    # (face, slot) -> the mesh's edge rank.
    inverse = torch.empty_like(ranks).scatter_(1, order, ranks)
    f2e = torch.stack([inverse[:, 0:F], inverse[:, F : 2 * F], inverse[:, 2 * F :]], dim=2)  # (N, F, 3)

    # Midpoints: edge rank r becomes vertex nv + r.
    E_cap = 3 * F
    mid_src = torch.zeros((N, E_cap + 1, 2), dtype=torch.long, device=device)
    mid_src.scatter_(1, torch.where(uniq, ranks, E_cap)[..., None].expand(-1, -1, 2), torch.stack([a_s, b_s], -1))
    mid_src = mid_src[:, :E_cap].clamp(0, V - 1)
    erank = torch.arange(E_cap, device=device)
    dest = torch.where(erank < n_edges[:, None], nv[:, None] + erank, V + E_cap)

    def with_midpoints(table):
        mids = 0.5 * (_rows(table, mid_src[..., 0]) + _rows(table, mid_src[..., 1]))
        out = table.new_zeros((N, V + E_cap + 1, table.shape[-1]))
        out[:, :V] = table
        out.scatter_(1, dest[..., None].expand(-1, -1, table.shape[-1]), mids)
        return out[:, : V + E_cap]

    new_verts = with_midpoints(verts)
    new_feats = None if feats is None else with_midpoints(feats)

    # Four faces per face, in groups of 4, so the valid ones stay a prefix.
    m = nv[:, None, None] + f2e  # column k: the midpoint of the edge opposite vertex k
    v0, v1, v2 = faces.unbind(-1)
    m0, m1, m2 = m.unbind(-1)
    new_faces = torch.stack(
        [torch.stack(c, dim=-1) for c in ((v0, m2, m1), (v1, m0, m2), (v2, m1, m0), (m0, m1, m2))], dim=2
    ).reshape(N, 4 * F, 3)
    new_faces = torch.where(valid.repeat_interleave(4, dim=1)[..., None], new_faces, -1)
    return new_verts, new_faces, nv + n_edges, 4 * nf, new_feats


class SubdivideMeshes:
    """Subdivide each face into 4: three at the corners, one between the
    edge midpoints."""

    def __init__(self, meshes: Optional[Meshes] = None) -> None:
        # PyTorch3D precomputes the topology of a homogeneous batch; the
        # batched computation needs nothing precomputed.
        self._precomputed = meshes

    def __call__(self, meshes: Meshes, feats: Optional[torch.Tensor] = None):
        """The subdivided `Meshes` and, with packed per-vertex `feats`
        (N*V, D), the new packed features (N*(V + 3F), D), midpoints
        averaged."""
        verts = meshes.verts_padded()
        N, V, _ = verts.shape
        feats_padded = None if feats is None else feats.reshape(N, V, feats.shape[-1])
        nverts, nfaces, nnv, nnf, new_feats = _subdivide(
            verts, meshes.faces_padded(), meshes.num_verts_per_mesh(), meshes.num_faces_per_mesh(), feats_padded
        )
        new = Meshes.create(nverts, nfaces, num_verts_per_mesh=nnv, num_faces_per_mesh=nnf, device=verts.device)
        if feats is not None:
            return new, new_feats.reshape(-1, feats.shape[-1])
        return new
