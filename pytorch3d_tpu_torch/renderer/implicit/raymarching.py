"""Raymarchers: emission-absorption and absorption-only (port of
pytorch3d_tpu/renderer/implicit/raymarching.py), with the shifted cumulative
product that the NeRF raymarcher shares."""

from __future__ import annotations

import torch


def _shifted_cumprod(x: torch.Tensor, shift: int = 1) -> torch.Tensor:
    """cumprod along the last axis, shifted right by `shift` with ones."""
    cp = torch.cumprod(x, dim=-1)
    return torch.cat([torch.ones_like(cp[..., :shift]), cp[..., :-shift]], dim=-1)


def _check_raymarcher_inputs(rays_densities, rays_features, rays_z, features_can_be_none=False,
                             z_can_be_none=True, density_1d=True) -> None:
    if rays_densities.ndim < 1:
        raise ValueError("rays_densities have to have at least one dimension.")
    if density_1d and rays_densities.shape[-1] != 1:
        raise ValueError("The size of the last dimension of rays_densities has to be one.")


class EmissionAbsorptionRaymarcher:
    """Each point's weight is its density times the transmission before it,
    prod_{j < i - shift + 1} (1 + eps - density_j) with shift =
    `surface_thickness`; returns (..., C + 1): the weighted features and the
    opacity 1 - prod(1 - density)."""

    def __init__(self, surface_thickness: int = 1) -> None:
        self.surface_thickness = surface_thickness

    def __call__(
        self,
        rays_densities: torch.Tensor,  # (..., n_pts, 1)
        rays_features: torch.Tensor,  # (..., n_pts, C)
        eps: float = 1e-10,
        **kwargs,
    ) -> torch.Tensor:
        _check_raymarcher_inputs(rays_densities, rays_features, None)
        densities = rays_densities[..., 0]
        absorption = _shifted_cumprod((1.0 + eps) - densities, shift=self.surface_thickness)
        weights = densities * absorption
        features = (weights[..., None] * rays_features).sum(dim=-2)
        opacities = 1.0 - torch.prod(1.0 - densities, dim=-1, keepdim=True)
        return torch.cat([features, opacities], dim=-1)

    forward = __call__


class AbsorptionOnlyRaymarcher:
    """The total absorption along each ray, 1 - prod(1 - clamp(density, 0,
    1)): (..., 1)."""

    def __call__(self, rays_densities: torch.Tensor, **kwargs) -> torch.Tensor:
        _check_raymarcher_inputs(rays_densities, None, None, features_can_be_none=True)
        densities = rays_densities[..., 0]
        return 1.0 - torch.prod(1.0 - densities.clamp(0.0, 1.0), dim=-1, keepdim=True)

    forward = __call__
