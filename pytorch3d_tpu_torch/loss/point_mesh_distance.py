"""Point-to-mesh distances: face and edge (port of
pytorch3d_tpu/loss/point_mesh_distance.py).

Each mesh's dense (P, F) or (P, E) matrix of squared distances from the
closed-form point-triangle and point-segment formulas, then masked minima
both ways; autograd gives the backward.  `amin` splits a gradient evenly
among tied minima, as JAX's `min` does.
"""

from __future__ import annotations

import torch

_DEF_MIN_TRI_AREA = 5e-3


def point_line_segment_distance(p, a, b, eps: float = 1e-8):
    """Squared distance from points p (..., 3) to segments (a, b) (..., 3),
    broadcasting."""
    ab = b - a
    t = ((p - a) * ab).sum(dim=-1) / (ab * ab).sum(dim=-1).clamp(min=eps)
    proj = a + t.clamp(0.0, 1.0)[..., None] * ab
    return ((p - proj) ** 2).sum(dim=-1)


def point_triangle_distance(p, v0, v1, v2, min_triangle_area: float = _DEF_MIN_TRI_AREA, eps: float = 1e-8):
    """Squared distance from points to triangles (broadcasting shapes): the
    distance to the plane where the point projects inside a triangle of area
    >= min_triangle_area, else the least distance to its three edges."""
    n = torch.linalg.cross(v1 - v0, v2 - v0, dim=-1)
    area2 = (n * n).sum(dim=-1)
    area = 0.5 * torch.sqrt(area2.clamp(min=0.0))
    # barycentric coordinates of p's projection
    d = p - v0
    e1 = v1 - v0
    e2 = v2 - v0
    a11 = (e1 * e1).sum(dim=-1)
    a12 = (e1 * e2).sum(dim=-1)
    a22 = (e2 * e2).sum(dim=-1)
    b1 = (d * e1).sum(dim=-1)
    b2 = (d * e2).sum(dim=-1)
    det = (a11 * a22 - a12 * a12).clamp(min=eps)
    u = (a22 * b1 - a12 * b2) / det
    v = (a11 * b2 - a12 * b1) / det
    inside = (u >= 0) & (v >= 0) & (u + v <= 1)
    # max(sqrt(area2), eps) as sqrt(max(area2, eps^2)): JAX's form has a NaN
    # gradient at area2 = 0, the padding faces' (all three corners vertex 0)
    n_unit = n / torch.sqrt(area2.clamp(min=eps * eps))[..., None]
    d_plane = (d * n_unit).sum(dim=-1) ** 2
    d_edges = torch.minimum(
        torch.minimum(point_line_segment_distance(p, v0, v1, eps), point_line_segment_distance(p, v1, v2, eps)),
        point_line_segment_distance(p, v0, v2, eps),
    )
    return torch.where(inside & (area >= min_triangle_area), d_plane, d_edges)


def _tris_padded(meshes):
    """(N, F, 3, 3) each face's vertex positions, and the (N, F) mask of
    real faces."""
    verts = meshes.verts_padded()  # (N, V, 3)
    faces = meshes.faces_padded().clamp(min=0)  # (N, F, 3)
    batch = torch.arange(len(meshes), device=verts.device)[:, None, None]
    return verts[batch, faces], meshes.faces_padded_mask()


def _edges_padded(meshes):
    """(N, E, 2, 3) each mesh's edges' end points at E = 3 * max_faces
    slots, and the (N, E) mask of real edges.  The packed edges are sorted
    by global vertex id, so mesh n's are the num_edges_per_mesh[n] rows from
    the sum of the earlier meshes' counts."""
    verts = meshes.verts_packed()
    edges = meshes.edges_packed()  # (E_total, 2), -1 past the real ones
    num_per = meshes.num_edges_per_mesh()
    E = 3 * meshes.max_faces
    first = torch.cumsum(num_per, 0) - num_per
    slot = torch.arange(E, device=verts.device)
    mask = slot[None, :] < num_per[:, None]
    src = torch.where(mask, first[:, None] + slot[None, :], 0)
    ev = verts[edges[src].clamp(min=0)]  # (N, E, 2, 3)
    return torch.where(mask[..., None, None], ev, 0.0), mask


def _both_ways(d2, pmask, omask, num_p, num_o, N):
    """Mean over each cloud's points of the least distance to its mesh's
    primitives, plus the mean over the primitives of the least distance to
    the points, averaged over the batch."""
    inf = torch.tensor(float("inf"), dtype=d2.dtype, device=d2.device)
    d_po = torch.where(omask[:, None, :], d2, inf).amin(dim=2)  # (N, P)
    d_op = torch.where(pmask[:, :, None], d2, inf).amin(dim=1)  # (N, E or F)
    num_p = num_p.to(d2.dtype).clamp(min=1.0)
    num_o = num_o.to(d2.dtype).clamp(min=1.0)
    point_dist = (torch.where(pmask, d_po, 0.0) / num_p[:, None]).sum()
    other_dist = (torch.where(omask, d_op, 0.0) / num_o[:, None]).sum()
    return (point_dist + other_dist) / N


def point_mesh_face_distance(meshes, pcls, min_triangle_area: float = _DEF_MIN_TRI_AREA) -> torch.Tensor:
    """Point to nearest face plus face to nearest point, each a mean of
    squared distances, averaged over the batch."""
    if len(meshes) != len(pcls):
        raise ValueError("meshes and pointclouds must be equal sized batches")
    pts = pcls.points_padded()  # (N, P, 3)
    tri, fmask = _tris_padded(meshes)
    d2 = point_triangle_distance(
        pts[:, :, None], tri[:, None, :, 0], tri[:, None, :, 1], tri[:, None, :, 2], min_triangle_area
    )  # (N, P, F)
    return _both_ways(d2, pcls.points_padded_mask(), fmask, pcls.num_points_per_cloud(),
                      meshes.num_faces_per_mesh(), len(meshes))


def point_mesh_edge_distance(meshes, pcls) -> torch.Tensor:
    """Point to nearest edge plus edge to nearest point, each a mean of
    squared distances, averaged over the batch."""
    if len(meshes) != len(pcls):
        raise ValueError("meshes and pointclouds must be equal sized batches")
    pts = pcls.points_padded()
    ev, emask = _edges_padded(meshes)
    d2 = point_line_segment_distance(pts[:, :, None], ev[:, None, :, 0], ev[:, None, :, 1])  # (N, P, E)
    return _both_ways(d2, pcls.points_padded_mask(), emask, pcls.num_points_per_cloud(),
                      meshes.num_edges_per_mesh(), len(meshes))
