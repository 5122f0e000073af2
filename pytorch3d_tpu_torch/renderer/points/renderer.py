"""PointsRenderer = rasterizer + compositor
(port of pytorch3d_tpu/renderer/points/renderer.py).

Weights are 1 - dists / r^2, with each fragment's own radius where the
radius is given per point.
"""

from __future__ import annotations

import torch
from torch import nn

from .rasterize_points import _format_radius


class PointsRenderer(nn.Module):
    def __init__(self, rasterizer, compositor):
        super().__init__()
        self.rasterizer = rasterizer
        self.compositor = compositor

    def forward(self, point_clouds, **kwargs) -> torch.Tensor:
        """(N, H, W, C) images of the clouds' features."""
        fragments = self.rasterizer(point_clouds, **kwargs)
        raster_settings = kwargs.get("raster_settings", self.rasterizer.raster_settings)
        r = raster_settings.radius

        idx = fragments.idx.permute(0, 3, 1, 2)  # (N, K, H, W)
        dists2 = fragments.dists.permute(0, 3, 1, 2)
        if not isinstance(r, (float, int)):
            # Per-point radius: gather each fragment's own.
            r_packed = _format_radius(r, point_clouds)
            r = torch.where(idx >= 0, r_packed[idx.clamp(min=0)], 1.0)
        weights = torch.where(idx >= 0, 1.0 - dists2 / (r * r), 0.0)

        features = point_clouds.features_packed()  # (N*P, C)
        images = self.compositor(idx, weights, features.t(), **kwargs)
        return images.permute(0, 2, 3, 1)  # (N, C, H, W) -> (N, H, W, C)
