"""Compositor modules wrapping the compositing functions
(port of pytorch3d_tpu/renderer/points/compositor.py)."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from .compositing import alpha_composite, norm_weighted_sum


def _add_background_color_to_images(pix_idxs, images, background_color):
    """Pixels that no point covers take the background color.

    images: (N, C, H, W); background_color: (C,), or (C-1,) with an alpha
    of 1 appended.
    """
    background_mask = torch.all(pix_idxs < 0, dim=1)  # (N, H, W)
    bg = torch.as_tensor(background_color, dtype=images.dtype, device=images.device)
    if bg.shape[0] == images.shape[1] - 1:
        bg = torch.cat([bg, bg.new_ones(1)])
    return torch.where(background_mask[:, None], bg[None, :, None, None], images)


class _Compositor(nn.Module):
    _composite = None  # a compositing function

    def __init__(self, background_color: Optional[Sequence[float]] = None):
        super().__init__()
        self.background_color = background_color

    def forward(self, fragments, alphas, ptclds, **kwargs) -> torch.Tensor:
        """fragments: (N, K, H, W) packed point ids; alphas (N, K, H, W);
        ptclds: (C, P_packed) features.  Returns (N, C, H, W)."""
        background_color = kwargs.get("background_color", self.background_color)
        images = self._composite(fragments, alphas, ptclds)
        if background_color is not None:
            return _add_background_color_to_images(fragments, images, background_color)
        return images


class AlphaCompositor(_Compositor):
    """Front-to-back alpha compositing."""

    _composite = staticmethod(alpha_composite)


class NormWeightedCompositor(_Compositor):
    """Normalized weighted-sum compositing."""

    _composite = staticmethod(norm_weighted_sum)
