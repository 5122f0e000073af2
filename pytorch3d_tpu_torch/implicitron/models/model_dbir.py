"""ModelDBIR: depth-based image re-rendering (port of ModelDBIR in
pytorch3d_tpu/implicitron/models/overfit_model.py).  Source RGBD frames are
unprojected into one coloured point cloud, which the points rasterizer
(kernel #5 on the card) renders into the target view and the alpha
compositor composites."""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from ...renderer import AlphaCompositor, PointsRasterizationSettings, PointsRasterizer
from ...structures.pointclouds import Pointclouds
from ..tools.config import expand_args_fields, registry
from .base_model import ImplicitronModelBase, ImplicitronRender


@registry.register
class ModelDBIR(ImplicitronModelBase, nn.Module):
    """Renders at render_image_height x render_image_width, points of radius
    0.01 (NDC), 4 a pixel; above `max_points` a subsample drawn from a
    generator (or handed-in `scores`).  `bin_size=0` forces the plain
    rasterizer on any device."""

    render_image_width: int = 256
    render_image_height: int = 256
    bg_color: float = 0.0
    max_points: int = 100000
    bin_size: Optional[int] = None

    def forward(
        self,
        *,
        camera,
        image_rgb: torch.Tensor,  # (N, H, W, 3) source images
        depth_map: torch.Tensor,  # (N, H, W, 1)
        fg_probability: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        scores: Optional[torch.Tensor] = None,  # (1, N * H * W) the subsample's uniform scores
        target_camera=None,
        **kwargs,
    ) -> Dict[str, Any]:
        """The render of the frames' cloud from `target_camera` (the first
        frame's camera when None)."""
        N, H, W, _ = image_rgb.shape
        device = image_rgb.device
        # NDC pixel centres (1 - (2i + 1) / n), so the splats land back on them
        ys, xs = torch.meshgrid(
            torch.linspace(1 - 1 / H, -1 + 1 / H, H, device=device),
            torch.linspace(1 - 1 / W, -1 + 1 / W, W, device=device),
            indexing="ij",
        )
        xy = torch.stack([xs, ys], dim=-1).reshape(-1, 2)
        pts = [camera[i].unproject_points(torch.cat([xy, depth_map[i, ..., 0].reshape(-1, 1)], dim=-1)[None])[0]
               for i in range(N)]
        cloud = Pointclouds.create(torch.cat(pts)[None], features=image_rgb.reshape(1, -1, 3), device=device)
        if self.max_points > 0 and cloud.points_padded().shape[1] > self.max_points:
            cloud = cloud.subsample(self.max_points, generator=generator, scores=scores)
        radius = 0.01
        rasterizer = PointsRasterizer(
            camera[0] if target_camera is None else target_camera,
            PointsRasterizationSettings(image_size=(self.render_image_height, self.render_image_width),
                                        radius=radius, points_per_pixel=4, bin_size=self.bin_size),
        )
        frags = rasterizer(cloud)
        idx = frags.idx.permute(0, 3, 1, 2)  # (1, K, H, W)
        weights = torch.where(idx >= 0, 1.0 - frags.dists.permute(0, 3, 1, 2) / (radius * radius), 0.0)
        compositor = AlphaCompositor(background_color=(self.bg_color,) * 3)
        images = compositor(idx, weights, cloud.features_packed().t()).permute(0, 2, 3, 1)
        mask_render = (frags.idx[..., :1] >= 0).to(images.dtype)
        zb = frags.zbuf[..., :1]
        depth_render = torch.where(zb > 0, zb, 0.0)
        return {
            "implicitron_render": ImplicitronRender(image_render=images, mask_render=mask_render,
                                                    depth_render=depth_render),
            "images_render": images,
            "masks_render": mask_render,
            "depths_render": depth_render,
            "point_cloud": cloud,
        }


expand_args_fields(ModelDBIR)
