"""PointsRasterizer: camera transform + point rasterization to PointFragments
(port of pytorch3d_tpu/renderer/points/rasterizer.py)."""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch
from torch import nn

from ..cameras import try_get_projection_transform
from .rasterize_points import rasterize_points


class PointFragments(NamedTuple):
    """Rasterizer outputs per pixel."""

    idx: torch.Tensor  # (N, H, W, K) packed point ids, -1 empty
    zbuf: torch.Tensor  # (N, H, W, K) view-space z, -1 empty
    dists: torch.Tensor  # (N, H, W, K) squared NDC distances, -1 empty


class PointsRasterizationSettings(NamedTuple):
    """Point rasterization configuration.  `max_points_per_bin` is accepted
    for API parity: the CUDA path's per-tile lists are exact."""

    image_size: Union[int, Tuple[int, int]] = 256
    radius: Union[float, torch.Tensor] = 0.01
    points_per_pixel: int = 8
    bin_size: Optional[int] = None
    max_points_per_bin: Optional[int] = None


class PointsRasterizer(nn.Module):
    """Rasterize world-space point clouds with a camera."""

    def __init__(self, cameras=None, raster_settings: Optional[PointsRasterizationSettings] = None):
        super().__init__()
        self.cameras = cameras
        self.raster_settings = raster_settings or PointsRasterizationSettings()

    def transform(self, point_clouds, **kwargs):
        """World -> NDC-xy with view-space z kept in the z slot."""
        cameras = kwargs.get("cameras", self.cameras)
        if cameras is None:
            raise ValueError(
                "Cameras must be specified either at initialization or in the "
                "forward pass of PointsRasterizer"
            )
        pts_world = point_clouds.points_padded()
        eps = kwargs.get("eps", None)
        pts_view = cameras.get_world_to_view_transform(**kwargs).transform_points(pts_world, eps=eps)
        to_ndc = cameras.get_ndc_camera_transform(**kwargs)
        projection = try_get_projection_transform(cameras, kwargs)
        if projection is not None:
            pts_ndc = projection.compose(to_ndc).transform_points(pts_view, eps=eps)
        else:
            pts_proj = cameras.transform_points(pts_world, eps=eps)
            pts_ndc = to_ndc.transform_points(pts_proj, eps=eps)
        # Keep view-space z for depth ordering.
        pts_ndc = torch.cat([pts_ndc[..., :2], pts_view[..., 2:3]], dim=-1)
        return point_clouds.update_padded(pts_ndc)

    def forward(self, point_clouds, **kwargs) -> PointFragments:
        clouds_ndc = self.transform(point_clouds, **kwargs)
        raster_settings = kwargs.get("raster_settings", self.raster_settings)
        idx, zbuf, dists = rasterize_points(
            clouds_ndc,
            image_size=raster_settings.image_size,
            radius=raster_settings.radius,
            points_per_pixel=raster_settings.points_per_pixel,
            bin_size=raster_settings.bin_size,
            max_points_per_bin=raster_settings.max_points_per_bin,
        )
        return PointFragments(idx=idx, zbuf=zbuf, dists=dists)
