"""Differentiable splatting of points into voxel grids (port of
pytorch3d_tpu/ops/points_to_volumes.py).

Each point adds a row [1, features] times its corner weight to each of its
corners (8 trilinear corners, or the nearest voxel): one `index_add` of the
(B * P * corners, 1 + C) rows into a (B * D * H * W, 1 + C) table, as the
JAX package does one row scatter-add.  Its backward is the rows' gather.
On the card `index_add` adds atomically, so two calls may differ in the
last bits of a voxel that several points reach.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def add_pointclouds_to_volumes(
    pointclouds,
    initial_volumes,
    mode: str = "trilinear",
    min_weight: float = 1e-4,
    rescale_features: bool = True,
):
    """`initial_volumes` with a `Pointclouds` batch (with features) splatted
    into its densities and features; the points are in world coordinates."""
    pts = pointclouds.points_padded()  # (B, P, 3)
    feats = pointclouds.features_padded()
    if feats is None:
        raise ValueError("Pointclouds have to have features.")
    mask = pointclouds.points_padded_mask().to(pts.dtype)
    features, densities = add_points_features_to_volume_densities_features(
        initial_volumes.world_to_local_coords(pts),
        feats,
        initial_volumes.densities(),
        initial_volumes.features(),
        mode=mode,
        min_weight=min_weight,
        mask=mask,
        rescale_features=rescale_features,
    )
    return initial_volumes.update_padded(new_densities=densities, new_features=features)


def _corners(x, y, z, mode):
    """[(cx, cy, cz, weight or None)] of each point's corners in voxel
    coordinates."""
    if mode == "nearest":
        return [(torch.round(x), torch.round(y), torch.round(z), None)]
    if mode != "trilinear":
        raise ValueError('No such interpolation mode "%s"' % mode)
    x0, y0, z0 = torch.floor(x), torch.floor(y), torch.floor(z)
    wx, wy, wz = x - x0, y - y0, z - z0
    corners = []
    for dz, fz in ((0, 1 - wz), (1, wz)):
        for dy, fy in ((0, 1 - wy), (1, wy)):
            for dx, fx in ((0, 1 - wx), (1, wx)):
                corners.append((x0 + dx, y0 + dy, z0 + dz, fx * fy * fz))
    return corners


def add_points_features_to_volume_densities_features(
    points_3d: torch.Tensor,  # (B, P, 3) local coordinates in [-1, 1]
    points_features: torch.Tensor,  # (B, P, C)
    volume_densities: torch.Tensor,  # (B, 1, D, H, W)
    volume_features: Optional[torch.Tensor],  # (B, C, D, H, W) or None
    mode: str = "trilinear",
    min_weight: float = 1e-4,
    mask: Optional[torch.Tensor] = None,  # (B, P) weights (0 drops a point)
    grid_sizes=None,
    rescale_features: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(features (B, C, D, H, W), densities (B, 1, D, H, W)), in the
    reference's order: each point adds its corner weights to the densities
    and its weighted features to the features; with `rescale_features` the
    features are then divided by max(density, min_weight)."""
    B, P, _ = points_3d.shape
    C = points_features.shape[-1]
    _, _, D, H, W = volume_densities.shape
    n_vox = D * H * W
    if volume_features is None:
        volume_features = volume_densities.new_zeros((B, C, D, H, W))
    if mask is None:
        mask = points_3d.new_ones((B, P))
    # local [-1, 1] -> voxel coordinates (x in [0, W - 1], align_corners)
    x = (points_3d[..., 0] + 1.0) * 0.5 * (W - 1)
    y = (points_3d[..., 1] + 1.0) * 0.5 * (H - 1)
    z = (points_3d[..., 2] + 1.0) * 0.5 * (D - 1)
    idx_all, w_all = [], []
    for cx, cy, cz, w in _corners(x, y, z, mode):
        w = mask if w is None else w * mask
        inside = (cx >= 0) & (cx <= W - 1) & (cy >= 0) & (cy <= H - 1) & (cz >= 0) & (cz <= D - 1)
        w_all.append(torch.where(inside, w, 0.0))
        idx_all.append(
            cz.clamp(0, D - 1).long() * (H * W) + cy.clamp(0, H - 1).long() * W + cx.clamp(0, W - 1).long()
        )
    # rows ordered (batch, corner, point), as the JAX package's per-volume scatter
    base = torch.arange(B, device=points_3d.device)[:, None] * n_vox
    idx = (torch.stack(idx_all, dim=1) + base[:, :, None]).reshape(-1)
    w = torch.stack(w_all, dim=1)  # (B, corners, P)
    payload = torch.cat([torch.ones_like(points_features[..., :1]), points_features], dim=-1)  # (B, P, 1 + C)
    rows = (payload[:, None] * w[..., None]).reshape(-1, 1 + C)
    acc = volume_features.new_zeros((B * n_vox, 1 + C)).index_add(0, idx, rows).reshape(B, n_vox, 1 + C)
    densities = volume_densities + acc[..., 0].reshape(B, 1, D, H, W)
    features = volume_features + acc[..., 1:].transpose(1, 2).reshape(B, C, D, H, W)
    if rescale_features:
        features = features / densities.clamp(min=min_weight)
    return features, densities
