"""Image helpers (port of pytorch3d_tpu/implicitron/tools/image_utils.py)."""

from __future__ import annotations

import torch


def mask_background(image_rgb: torch.Tensor, mask_fg: torch.Tensor, dim_color: int = -1, bg_color=0.0) -> torch.Tensor:
    """Background pixels of a channel-last (..., H, W, 3) image filled with
    `bg_color`: "white", "black", a float or an RGB triple."""
    if isinstance(bg_color, str):
        if bg_color not in ("white", "black"):
            raise ValueError(f"Unknown bg_color={bg_color}.")
        bg = torch.full((3,), 1.0 if bg_color == "white" else 0.0, dtype=image_rgb.dtype, device=image_rgb.device)
    else:
        bg = torch.as_tensor(bg_color, dtype=image_rgb.dtype, device=image_rgb.device).expand(3)
    return image_rgb * mask_fg + (1.0 - mask_fg) * bg
