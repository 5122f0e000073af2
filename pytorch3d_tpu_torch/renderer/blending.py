"""Blending functions (port of pytorch3d_tpu/renderer/blending.py)."""

from __future__ import annotations

from typing import NamedTuple, Tuple, Union

import torch


class BlendParams(NamedTuple):
    """Parameters for soft blending."""

    sigma: float = 1e-4
    gamma: float = 1e-4
    background_color: Union[Tuple[float, float, float], torch.Tensor] = (1.0, 1.0, 1.0)


def _get_background_color(blend_params: BlendParams, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(blend_params.background_color, dtype=like.dtype, device=like.device)


def hard_rgb_blend(colors: torch.Tensor, fragments, blend_params: BlendParams) -> torch.Tensor:
    """The closest face's color; alpha = foreground mask.
    colors: (N, H, W, K, 3); returns (N, H, W, 4)."""
    background_color = _get_background_color(blend_params, colors)
    is_background = fragments.pix_to_face[..., 0] < 0  # (N, H, W)
    pixel_colors = torch.where(is_background[..., None], background_color, colors[..., 0, :])
    alpha = (~is_background).to(colors.dtype)[..., None]
    return torch.cat([pixel_colors, alpha], dim=-1)


def sigmoid_alpha_blend(colors, fragments, blend_params: BlendParams) -> torch.Tensor:
    """Silhouette blending (SoftRas); returns (N, H, W, 4)."""
    mask = fragments.pix_to_face >= 0
    prob_map = torch.sigmoid(-fragments.dists / blend_params.sigma) * mask
    alpha = 1.0 - torch.prod(1.0 - prob_map, dim=-1)
    return torch.cat([colors[..., 0, :], alpha[..., None]], dim=-1)


def _per_image(z, like: torch.Tensor) -> Union[float, torch.Tensor]:
    """A per-camera (N,) near/far plane as (N, 1, 1, 1); scalars pass."""
    if isinstance(z, torch.Tensor) and z.ndim == 1:
        return z.to(like.dtype)[:, None, None, None]
    return z


def softmax_rgb_blend(
    colors: torch.Tensor,
    fragments,
    blend_params: BlendParams,
    znear: Union[float, torch.Tensor] = 1.0,
    zfar: Union[float, torch.Tensor] = 100.0,
) -> torch.Tensor:
    """SoftRas z-weighted softmax blending.

    colors: (N, H, W, K, 3); fragments gives pix_to_face/dists/zbuf of shape
    (N, H, W, K).  Returns (N, H, W, 4).
    """
    eps = 1e-10
    background_color = _get_background_color(blend_params, colors)
    mask = fragments.pix_to_face >= 0

    prob_map = torch.sigmoid(-fragments.dists / blend_params.sigma) * mask
    alpha = 1.0 - torch.prod(1.0 - prob_map, dim=-1)

    zfar = _per_image(zfar, colors)
    znear = _per_image(znear, colors)
    z_inv = (zfar - fragments.zbuf) / (zfar - znear) * mask
    z_inv_max = torch.clamp(torch.amax(z_inv, dim=-1, keepdim=True), min=eps)
    weights_num = prob_map * torch.exp((z_inv - z_inv_max) / blend_params.gamma)
    delta = torch.clamp(torch.exp((eps - z_inv_max) / blend_params.gamma), min=eps)
    denom = torch.sum(weights_num, dim=-1, keepdim=True) + delta
    weighted_colors = torch.sum(weights_num[..., None] * colors, dim=-2)
    pixel_rgb = (weighted_colors + delta * background_color) / denom
    return torch.cat([pixel_rgb, alpha[..., None]], dim=-1)
