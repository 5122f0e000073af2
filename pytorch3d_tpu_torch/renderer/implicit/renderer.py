"""Implicit and volume renderers (port of
pytorch3d_tpu/renderer/implicit/renderer.py).

`ImplicitRenderer` runs a raysampler, a user's volumetric function and a
raymarcher; `VolumeRenderer` makes the volumetric function a
`VolumeSampler`, which reads a `Volumes` batch at the rays' points through
`ops/grid_sample.py`'s trilinear corner gathers (the JAX package's
arithmetic, not `torch.nn.functional.grid_sample`'s).
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from ...ops.grid_sample import _sample_3d
from .utils import ray_bundle_to_ray_points


class ImplicitRenderer:
    """raysampler -> volumetric_function -> raymarcher.

    The volumetric function is called as ``fn(ray_bundle=..., cameras=...,
    **kwargs) -> (densities (..., n_pts, 1), features (..., n_pts, C))``;
    the keyword arguments of a call go to all three stages (a `generator`
    or the samplers' draws to the raysampler, for instance)."""

    def __init__(self, raysampler: Callable, raymarcher: Callable) -> None:
        if not callable(raysampler):
            raise ValueError('"raysampler" has to be a "Callable" object.')
        if not callable(raymarcher):
            raise ValueError('"raymarcher" has to be a "Callable" object.')
        self.raysampler = raysampler
        self.raymarcher = raymarcher

    def __call__(self, cameras, volumetric_function: Callable, **kwargs) -> Tuple:
        """(images, ray_bundle): the raymarcher's output per ray and the rays."""
        if not callable(volumetric_function):
            raise ValueError('"volumetric_function" has to be a "Callable" object.')
        ray_bundle = self.raysampler(cameras=cameras, **kwargs)
        rays_densities, rays_features = volumetric_function(ray_bundle=ray_bundle, cameras=cameras, **kwargs)
        images = self.raymarcher(
            rays_densities=rays_densities, rays_features=rays_features, ray_bundle=ray_bundle, **kwargs
        )
        return images, ray_bundle

    forward = __call__


class VolumeSampler:
    """Densities and features of a `Volumes` batch at the points of a ray
    bundle whose batch is the volumes' (B, ..., n_pts): trilinear (or
    nearest) with zeros (or border) padding, align_corners=True.  The
    densities and features are read in one gather of a channel-last table
    of both, each channel with the same weights as a separate read."""

    def __init__(self, volumes, sample_mode: str = "bilinear", padding_mode: str = "zeros") -> None:
        self._volumes = volumes
        self._sample_mode = sample_mode
        self._padding_mode = padding_mode

    def _get_ray_directions_transform(self) -> torch.Tensor:
        """The world-to-local matrix without its translation (N, 4, 4)."""
        w2l = self._volumes.get_world_to_local_coords_transform().get_matrix().clone()
        w2l[:, 3, :3] = 0.0
        return w2l

    def __call__(self, ray_bundle, **kwargs) -> Tuple[torch.Tensor, torch.Tensor]:
        """(densities (B, ..., n_pts, C_d), features (B, ..., n_pts, C_f));
        features are (..., 0) for volumes without features."""
        pts_world = ray_bundle_to_ray_points(ray_bundle)  # (B, ..., S, 3)
        B = pts_world.shape[0]
        spatial = pts_world.shape[1:-1]
        pts_local = self._volumes.world_to_local_coords(pts_world.reshape(B, -1, 3))
        densities = self._volumes.densities()  # (B, C_d, D, H, W)
        features = self._volumes.features()  # (B, C_f, D, H, W) or None
        C_d = densities.shape[1]
        table = densities if features is None else torch.cat([densities, features], dim=1)
        table = table.permute(0, 2, 3, 4, 1).contiguous()
        x, y, z = pts_local.unbind(-1)
        values = _sample_3d(table, x, y, z, self._sample_mode, self._padding_mode,
                            self._volumes.get_align_corners())  # (B, P, C_d + C_f)
        values = values.reshape(B, *spatial, table.shape[-1])
        return values[..., :C_d], values[..., C_d:]


class VolumeRenderer:
    """raysampler -> `VolumeSampler` of the given volumes -> raymarcher."""

    def __init__(self, raysampler: Callable, raymarcher: Callable, sample_mode: str = "bilinear") -> None:
        self._renderer = ImplicitRenderer(raysampler, raymarcher)
        self._sample_mode = sample_mode

    def __call__(self, cameras, volumes, **kwargs) -> Tuple:
        """(images, ray_bundle) of the volumes seen by the cameras."""
        volumetric_function = VolumeSampler(volumes, sample_mode=self._sample_mode)
        return self._renderer(cameras=cameras, volumetric_function=volumetric_function, **kwargs)

    forward = __call__
