"""Exact 3D IoU of oriented boxes (port of pytorch3d_tpu/ops/iou_box3d.py).

Each box contributes 12 outward-wound triangles; every triangle is clipped
against the other box's 6 half-spaces by a fixed-capacity (10-vertex)
Sutherland-Hodgman pass, and the intersection volume follows from the
divergence theorem over the clipped faces of both boxes.  All box pairs go
through each plane's clip together, as one batch of tensors.

Box corner convention (PyTorch3D's, unit box):
    (0) [0,0,0]  (1) [1,0,0]  (2) [1,1,0]  (3) [0,1,0]
    (4) [0,0,1]  (5) [1,0,1]  (6) [1,1,1]  (7) [0,1,1]
"""

from __future__ import annotations

from typing import Tuple

import torch

# 6 quad faces with outward winding for the unit-box corner order above.
_QUADS = (
    (0, 3, 2, 1),  # z = 0 (outward -z)
    (4, 5, 6, 7),  # z = 1 (+z)
    (0, 1, 5, 4),  # y = 0 (-y)
    (3, 7, 6, 2),  # y = 1 (+y)
    (0, 4, 7, 3),  # x = 0 (-x)
    (1, 2, 6, 5),  # x = 1 (+x)
)
_TRIS = tuple(t for q in _QUADS for t in ((q[0], q[1], q[2]), (q[0], q[2], q[3])))
_CAP = 10  # 3 starting verts + at most 6 plane clips + margin
_EPS = 1e-6


def _box_planes(boxes: torch.Tensor):
    """(..., 8, 3) -> (..., 6, 3) plane points and outward normals."""
    q = torch.tensor(_QUADS, device=boxes.device)
    pts = boxes[..., q[:, 0], :]
    normals = torch.linalg.cross(boxes[..., q[:, 1], :] - pts, boxes[..., q[:, 3], :] - pts)
    # Outward for a right-handed corner order; flipped for a mirrored box.
    center = boxes.mean(dim=-2, keepdim=True)
    s = torch.sign(torch.sum((pts - center) * normals, dim=-1, keepdim=True))
    return pts, normals * torch.where(s == 0, 1.0, s)


def _box_tris(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 8, 3) -> (..., 12, 3, 3) outward-wound triangles."""
    return boxes[..., torch.tensor(_TRIS, device=boxes.device), :]


def _clip_one_plane(verts, count, p0, n, tol):
    """Sutherland-Hodgman on polygons (..., CAP, 3) of `count` (...,)
    vertices: keep the region (x - p0) . n <= tol, for one plane (..., 3)
    each.  A positive tol keeps faces lying on the plane, a negative one
    drops them (so the coincident faces of two boxes count once)."""
    d = torch.sum((verts - p0[..., None, :]) * n[..., None, :], dim=-1)  # (..., CAP)
    idx = torch.arange(_CAP, device=verts.device)
    nxt = torch.where(idx + 1 >= count[..., None], 0, idx + 1)
    active = idx < count[..., None]
    d_nxt = torch.gather(d, -1, nxt)
    v_nxt = torch.gather(verts, -2, nxt[..., None].expand(verts.shape))
    cur_in = (d <= tol) & active
    crossing = active & (cur_in != ((d_nxt <= tol) & active))

    denom = d - d_nxt
    t = d / torch.where(denom.abs() < 1e-12, 1.0, denom)
    inter = verts + t[..., None] * (v_nxt - verts)

    emit_cur = cur_in.long()
    emits = emit_cur + crossing.long()
    start = torch.cumsum(emits, dim=-1) - emits  # exclusive cumsum

    # Slots at or past CAP are dropped, as the JAX scatter's mode="drop".
    out = torch.zeros(verts.shape[:-2] + (_CAP + 1, 3), dtype=verts.dtype, device=verts.device)
    for keep, pos, src in ((cur_in, start, verts), (crossing, start + emit_cur, inter)):
        dest = torch.where(keep & (pos < _CAP), pos, _CAP)
        out.scatter_(-2, dest[..., None].expand(src.shape), src)
    return out[..., :_CAP, :], emits.sum(dim=-1)


def _clipped_faces_volume(tris, planes_p, planes_n, tol):
    """Signed divergence-theorem volume of triangles (P, 12, 3, 3) clipped
    by the 6 half-spaces (P, 6, 3) of their pair's other box, summed per
    pair: each clipped polygon's fan of det[v0, vk, vk+1] / 6."""
    P = tris.shape[0]
    verts = torch.zeros((P, 12, _CAP, 3), dtype=tris.dtype, device=tris.device)
    verts[:, :, :3] = tris
    count = torch.full((P, 12), 3, dtype=torch.long, device=tris.device)
    for k in range(6):
        verts, count = _clip_one_plane(
            verts, count, planes_p[:, None, k].expand(P, 12, 3), planes_n[:, None, k].expand(P, 12, 3), tol
        )
    k = torch.arange(_CAP, device=tris.device)
    valid = (k >= 1) & (k + 1 < count[..., None])
    a = verts
    b = verts[:, :, (k + 1).clamp(max=_CAP - 1)]
    det = torch.sum(verts[:, :, :1] * torch.linalg.cross(a, b), dim=-1)  # (P, 12, CAP)
    return torch.sum(torch.where(valid, det, 0.0), dim=(1, 2)) / 6.0


def _box_volume(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 8, 3) -> (...) volumes."""
    tris = _box_tris(boxes)
    det = torch.sum(tris[..., 0, :] * torch.linalg.cross(tris[..., 1, :], tris[..., 2, :]), dim=-1)
    return det.sum(dim=-1).abs() / 6.0


def _check_coplanar(boxes: torch.Tensor, eps: float = 1e-4) -> None:
    verts = boxes[:, torch.tensor(_QUADS, device=boxes.device)]  # (N, 6, 4, 3)
    v0, v1, v2, v3 = (verts[:, :, i] for i in range(4))
    n = torch.linalg.cross(v1 - v0, v2 - v0)
    n = n / torch.linalg.norm(n, dim=-1, keepdim=True).clamp(min=1e-12)
    if bool((torch.sum((v3 - v0) * n, dim=-1).abs() > eps).any()):
        raise ValueError("Planes have zero areas")


def _check_nonzero(boxes: torch.Tensor, eps: float = 1e-8) -> None:
    if bool((_box_volume(boxes) < eps).any()):
        raise ValueError("Planes have zero areas")


def box3d_overlap(
    boxes1: torch.Tensor,  # (N, 8, 3)
    boxes2: torch.Tensor,  # (M, 8, 3)
    eps: float = 1e-4,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Intersection volume and IoU of every box pair: (vol (N, M), iou (N, M)).

    Raises if a box's faces are not planar (to `eps`) or a box has no
    volume (two host syncs)."""
    if boxes1.ndim != 3 or boxes1.shape[1:] != (8, 3):
        raise ValueError("boxes1 has to be of shape (N, 8, 3)")
    if boxes2.ndim != 3 or boxes2.shape[1:] != (8, 3):
        raise ValueError("boxes2 has to be of shape (M, 8, 3)")
    _check_coplanar(boxes1, eps)
    _check_coplanar(boxes2, eps)
    _check_nonzero(boxes1)
    _check_nonzero(boxes2)

    N, M = boxes1.shape[0], boxes2.shape[0]
    b1 = boxes1[:, None].expand(N, M, 8, 3).reshape(N * M, 8, 3)
    b2 = boxes2[None].expand(N, M, 8, 3).reshape(N * M, 8, 3)
    p1, n1 = _box_planes(b1)
    p2, n2 = _box_planes(b2)
    # Box 1's faces keep the shared boundary (+eps), box 2's take the strict
    # interior (-eps), so faces the two boxes share count once.
    inter = (_clipped_faces_volume(_box_tris(b1), p2, n2, _EPS)
             + _clipped_faces_volume(_box_tris(b2), p1, n1, -_EPS)).abs().reshape(N, M)
    union = _box_volume(boxes1)[:, None] + _box_volume(boxes2)[None, :] - inter
    return inter, inter / union.clamp(min=1e-12)
