"""Implicitron's raymarchers (port of
pytorch3d_tpu/implicitron/models/renderer/raymarcher.py): the weighted
accumulation along rays, with emission-absorption and cumulative-sum
weights."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from ....renderer.implicit.raymarching import _shifted_cumprod
from ...tools.config import ReplaceableBase, registry
from .base import RendererOutput


class RaymarcherBase(ReplaceableBase):
    def __call__(self, rays_densities, rays_features, aux, **kwargs):
        raise NotImplementedError


@dataclasses.dataclass
class AccumulativeRaymarcherBase(RaymarcherBase):
    """Weighted accumulation along rays: densities times the intervals to
    the next depth, capped, give each point's weight with the absorption
    before it."""

    surface_thickness: int = 1
    bg_color: Tuple[float, ...] = (0.0,)
    replicate_last_interval: bool = False
    background_opacity: float = 0.0
    density_relu: bool = True
    blend_output: bool = False

    def _capping_function(self, rays_densities: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _weight_function(self, rays_densities: torch.Tensor, absorption: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def __call__(
        self,
        rays_densities: torch.Tensor,  # (..., S, 1)
        rays_features: torch.Tensor,  # (..., S, C)
        aux: Optional[Dict[str, Any]] = None,
        ray_lengths: Optional[torch.Tensor] = None,  # (..., S)
        density_noise_std: float = 0.0,
        **kwargs,
    ) -> RendererOutput:
        if ray_lengths is None:
            ray_lengths = rays_densities.new_zeros(rays_densities.shape[:-1])
        if self.replicate_last_interval and ray_lengths.shape[-1] > 1:
            last = ray_lengths[..., -1:] - ray_lengths[..., -2:-1]
        else:
            last = torch.full_like(ray_lengths[..., :1], self.background_opacity)
        deltas = torch.cat([ray_lengths[..., 1:] - ray_lengths[..., :-1], last], dim=-1)
        rays_densities = rays_densities[..., 0]
        if self.density_relu:
            rays_densities = torch.relu(rays_densities)
        capped = self._capping_function(deltas * rays_densities)  # (..., S)

        absorption = _shifted_cumprod((1.0 + 1e-10) - capped, shift=self.surface_thickness)
        weights = self._weight_function(capped, absorption)
        features = (weights[..., None] * rays_features).sum(dim=-2)
        depth = (weights * ray_lengths).sum(dim=-1, keepdim=True)
        alpha = weights.sum(dim=-1, keepdim=True).clamp(0.0, 1.0)
        if self.blend_output:
            bg = torch.tensor(self.bg_color, dtype=features.dtype, device=features.device)
            features = features + (1.0 - alpha) * bg
        return RendererOutput(features=features, depths=depth, masks=alpha, weights=weights, aux=aux or {})


@registry.register
@dataclasses.dataclass
class EmissionAbsorptionRaymarcher(AccumulativeRaymarcherBase):
    """cap = 1 - exp(-x); weight = cap * absorption."""

    background_opacity: float = 1e10

    def _capping_function(self, x):
        return 1.0 - torch.exp(-x)

    def _weight_function(self, cap, absorption):
        return cap * absorption


@registry.register
@dataclasses.dataclass
class CumsumRaymarcher(AccumulativeRaymarcherBase):
    """The cumulative-sum marcher of Neural Volumes: cap = x; weight = cap
    times the absorption clamped to [0, 1]."""

    def _capping_function(self, x):
        return x

    def _weight_function(self, cap, absorption):
        return cap * absorption.clamp(0.0, 1.0)
