"""Ray bundles (port of pytorch3d_tpu/renderer/implicit/utils.py).

`RayBundle` is a plain dataclass of tensors; `HeterogeneousRayBundle`
adds, for rays drawn from several cameras (`n_rays_total`), which camera
each ray came from and how many rays each camera gave.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class RayBundle:
    """origins / directions (..., 3), lengths (..., S) and xys (..., 2), the
    rays' NDC image-plane locations."""

    origins: torch.Tensor
    directions: torch.Tensor
    lengths: torch.Tensor
    xys: torch.Tensor

    def replace(self, **changes) -> "RayBundle":
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class HeterogeneousRayBundle(RayBundle):
    """Rays packed from several cameras: camera_ids (n_rays,) is each row's
    camera, camera_counts (n_cameras,) the rows of each camera (every camera
    of the batch counted, zeros included: the shapes stay static)."""

    camera_ids: Optional[torch.Tensor] = None
    camera_counts: Optional[torch.Tensor] = None


def ray_bundle_to_ray_points(ray_bundle: RayBundle) -> torch.Tensor:
    """World points at each depth: origins + lengths * directions."""
    return ray_bundle_variables_to_ray_points(ray_bundle.origins, ray_bundle.directions, ray_bundle.lengths)


def ray_bundle_variables_to_ray_points(
    rays_origins: torch.Tensor,  # (..., 3)
    rays_directions: torch.Tensor,  # (..., 3)
    rays_lengths: torch.Tensor,  # (..., S)
) -> torch.Tensor:
    """(..., S, 3) = origins[..., None, :] + lengths[..., :, None] * dirs."""
    return rays_origins[..., None, :] + rays_lengths[..., :, None] * rays_directions[..., None, :]
