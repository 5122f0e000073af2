"""The NeRF emission-absorption raymarcher (port of
pytorch3d_tpu/models/nerf/raymarcher.py): rendered features and the
per-sample weights the importance sampler resamples from."""

from __future__ import annotations

from typing import Tuple

import torch

from ...renderer.implicit.raymarching import _shifted_cumprod


class EmissionAbsorptionNeRFRaymarcher:
    def __init__(self, surface_thickness: int = 1) -> None:
        self.surface_thickness = surface_thickness

    def __call__(
        self,
        rays_densities: torch.Tensor,  # (..., S, 1)
        rays_features: torch.Tensor,  # (..., S, C)
        eps: float = 1e-10,
        **kwargs,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(features (..., C), weights (..., S))."""
        densities = rays_densities[..., 0]
        absorption = _shifted_cumprod((1.0 + eps) - densities, shift=self.surface_thickness)
        weights = densities * absorption
        return (weights[..., None] * rays_features).sum(dim=-2), weights
