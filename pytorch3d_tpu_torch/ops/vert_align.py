"""Sample image feature maps at projected vertices, Mesh R-CNN's "vert
align" (port of pytorch3d_tpu/ops/vert_align.py), through the port's
`grid_sample` (the JAX package's arithmetic)."""

from __future__ import annotations

import torch

from .grid_sample import grid_sample


def vert_align(
    feats,
    verts,
    return_packed: bool = False,
    interp_mode: str = "bilinear",
    padding_mode: str = "zeros",
    align_corners: bool = True,
) -> torch.Tensor:
    """Features at each vertex's (x, y), taken as NDC coordinates in [-1, 1].

    feats: (N, C, H, W) or a list of such maps (their channels are
    concatenated); verts: (N, V, 3), or an object with `verts_padded` or
    `points_padded`.  Returns (N, V, sum C), or (N * V, sum C) with
    `return_packed`.
    """
    if hasattr(verts, "verts_padded"):
        grid = verts.verts_padded()
    elif hasattr(verts, "points_padded"):
        grid = verts.points_padded()
    else:
        grid = verts
    grid = grid[:, None, :, :2]  # (N, 1, V, 2)

    if torch.is_tensor(feats):
        feats = [feats]
    for f in feats:
        if f.ndim != 4:
            raise ValueError("feats must have shape (N, C, H, W)")
        if grid.shape[0] != f.shape[0]:
            raise ValueError("inconsistent batch dimension")

    sampled = [
        grid_sample(f, grid, mode=interp_mode, padding_mode=padding_mode, align_corners=align_corners)[:, :, 0]
        .transpose(1, 2)
        for f in feats
    ]  # each (N, V, C)
    out = torch.cat(sampled, dim=2)
    if return_packed:
        out = out.reshape(-1, out.shape[-1])
    return out
