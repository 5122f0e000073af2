"""NeRF utilities (port of pytorch3d_tpu/models/nerf/utils.py): image error
metrics and sampling target images at the rays' NDC locations."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def calc_mse(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean((x - y) ** 2)


def calc_psnr(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return -10.0 * torch.log10(calc_mse(x, y).clamp(min=1e-12))


def sample_images_at_mc_locs(
    target_images: torch.Tensor,  # (B, H, W, C)
    sampled_rays_xy: torch.Tensor,  # (B, ..., 2) NDC xy, +X left, +Y up
) -> torch.Tensor:
    """Bilinear samples (B, ..., C) of the images at the rays' NDC xy, the
    border pixels extended outwards (grid_sample, align_corners=False)."""
    B, C = target_images.shape[0], target_images.shape[-1]
    spatial = sampled_rays_xy.shape[1:-1]
    # grid_sample's x runs right and y down: the negatives of NDC's.
    grid = -sampled_rays_xy.reshape(B, 1, -1, 2)
    images = target_images.permute(0, 3, 1, 2)
    out = F.grid_sample(images, grid.to(images.dtype), mode="bilinear", padding_mode="border", align_corners=False)
    return out[:, :, 0].permute(0, 2, 1).reshape(B, *spatial, C)
