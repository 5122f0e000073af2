"""Laplacian smoothing losses: uniform, cot and cotcurv (port of
pytorch3d_tpu/loss/mesh_laplacian_smoothing.py).

The sparse products are sums over edges or faces written as `index_add`,
as the JAX package writes them as segment sums; the cotangent Laplacian is
applied inline, without building the sparse matrix.
"""

from __future__ import annotations

import torch

from ..common.math_utils import safe_norm


def _segment_sum(values: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    out = torch.zeros((n, *values.shape[1:]), dtype=values.dtype, device=values.device)
    return out.index_add(0, ids, values)


def mesh_laplacian_smoothing(meshes, method: str = "uniform") -> torch.Tensor:
    if meshes.isempty():
        return torch.tensor(0.0, dtype=torch.float32, device=meshes.device)
    N = len(meshes)
    verts = meshes.verts_packed()  # (V, 3)
    V = verts.shape[0]
    vmask = meshes.verts_packed_mask()
    v_to_mesh = meshes.verts_packed_to_mesh_idx()
    num_verts = meshes.num_verts_per_mesh().to(verts.dtype)
    weights = torch.where(vmask, 1.0 / num_verts[v_to_mesh].clamp(min=1.0), 0.0)

    if method == "uniform":
        edges = meshes.edges_packed()
        valid = torch.all(edges >= 0, dim=-1)
        e0 = torch.where(valid, edges[:, 0], 0)
        e1 = torch.where(valid, edges[:, 1], 0)
        ones = valid.to(verts.dtype)
        deg = _segment_sum(ones, e0, V) + _segment_sum(ones, e1, V)
        nbr_sum = _segment_sum(verts[e1] * ones[:, None], e0, V) + _segment_sum(
            verts[e0] * ones[:, None], e1, V
        )
        # L v = mean(neighbours) - v
        loss_vec = nbr_sum / deg.clamp(min=1.0)[:, None] - verts
        loss_vec = torch.where((deg > 0)[:, None], loss_vec, 0.0)
    elif method in ("cot", "cotcurv"):
        Lv, wsum, inv_areas = _cot_laplacian_apply(verts, meshes.faces_packed())
        if method == "cot":
            loss_vec = Lv / wsum.clamp(min=1e-12)[:, None] - verts
            loss_vec = torch.where((wsum > 0)[:, None], loss_vec, 0.0)
        else:  # cotcurv
            loss_vec = (Lv - wsum[:, None] * verts) * (0.25 * inv_areas)[:, None]
    else:
        raise ValueError("Method should be one of {uniform, cot, cotcurv}")

    loss = safe_norm(loss_vec, dim=1) * weights
    return torch.sum(loss) / N


def _cot_laplacian_apply(verts: torch.Tensor, faces: torch.Tensor, eps: float = 1e-12):
    """(L @ verts, row sums of L, per-vertex inverse areas).

    The cotangent weights and areas are constants of the loss (computed on
    detached verts, as the JAX package's stop_gradient); only the product
    L @ verts is differentiated.
    """
    V = verts.shape[0]
    valid = torch.all(faces >= 0, dim=-1)
    f = faces.clamp(min=0)
    verts_ng = verts.detach()
    v0, v1, v2 = verts_ng[f[:, 0]], verts_ng[f[:, 1]], verts_ng[f[:, 2]]
    A = safe_norm(v1 - v2, dim=1)
    B = safe_norm(v0 - v2, dim=1)
    C = safe_norm(v0 - v1, dim=1)
    A2, B2, C2 = A * A, B * B, C * C
    s = 0.5 * (A + B + C)
    area = torch.sqrt(torch.clamp(s * (s - A) * (s - B) * (s - C), min=eps))
    cota = (B2 + C2 - A2) / area.clamp(min=eps) / 4.0
    cotb = (A2 + C2 - B2) / area.clamp(min=eps) / 4.0
    cotc = (A2 + B2 - C2) / area.clamp(min=eps) / 4.0
    cots = [torch.where(valid, c, 0.0) for c in (cota, cotb, cotc)]

    Lv = torch.zeros_like(verts)
    wsum = torch.zeros(V, dtype=verts.dtype, device=verts.device)
    # weight w on pair (i, j): Lv[i] += w * v[j]; Lv[j] += w * v[i]
    for w, i, j in (
        (cots[0], f[:, 1], f[:, 2]),
        (cots[1], f[:, 2], f[:, 0]),
        (cots[2], f[:, 0], f[:, 1]),
    ):
        Lv = Lv + _segment_sum(w[:, None] * verts[j], i, V)
        Lv = Lv + _segment_sum(w[:, None] * verts[i], j, V)
        wsum = wsum + _segment_sum(w, i, V)
        wsum = wsum + _segment_sum(w, j, V)

    face_area = torch.where(valid, area, 0.0)
    vert_area = (
        _segment_sum(face_area, f[:, 0], V)
        + _segment_sum(face_area, f[:, 1], V)
        + _segment_sum(face_area, f[:, 2], V)
    )
    inv_areas = torch.where(vert_area > 0, 1.0 / vert_area.clamp(min=eps), 0.0)
    return Lv, wsum, inv_areas
