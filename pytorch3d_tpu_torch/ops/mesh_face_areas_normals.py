"""Per-face areas and unit normals (port of
pytorch3d_tpu/ops/mesh_face_areas_normals.py): plain tensor arithmetic,
differentiated by autograd."""

from __future__ import annotations

from typing import Tuple

import torch

from ..common.math_utils import safe_norm


def mesh_face_areas_normals(verts: torch.Tensor, faces: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """verts (V, 3), faces (F, 3) int -> (areas (F,), normals (F, 3)).

    Padding faces (an id of -1) and degenerate faces get area 0 and normal
    0, with zero (not NaN) gradients."""
    valid = (faces >= 0).all(dim=-1)
    f = faces.clamp(min=0)
    v0, v1, v2 = verts[f[:, 0]], verts[f[:, 1]], verts[f[:, 2]]
    n = torch.linalg.cross(v1 - v0, v2 - v0, dim=-1)
    norm = safe_norm(n, dim=-1)
    ok = norm > 0
    normals = n * torch.where(ok, 1.0 / torch.where(ok, norm, 1.0), 0.0)[:, None]
    areas = torch.where(valid, 0.5 * norm, 0.0)
    return areas, torch.where(valid[:, None], normals, 0.0)
