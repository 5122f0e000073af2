"""Implicit-function helpers (port of
pytorch3d_tpu/implicitron/models/implicit_function/utils.py): the global
code broadcast, the point embeddings of an implicit function, and the
world points of a bundle; the grid interpolators live in voxel_grid.py and
are re-exported here."""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from ....renderer.implicit.utils import ray_bundle_to_ray_points
from .voxel_grid import interpolate_line, interpolate_plane, interpolate_volume  # noqa: F401 (re-exports)


def broadcast_global_code(embeds: torch.Tensor, global_code: torch.Tensor) -> torch.Tensor:
    """A (B, D) global code broadcast over embeds' middle dims and appended
    to its last."""
    gc = global_code.reshape((embeds.shape[0],) + (1,) * (embeds.ndim - 2) + (-1,))
    return torch.cat([embeds, gc.expand(*embeds.shape[:-1], global_code.shape[-1])], dim=-1)


def create_embeddings_for_implicit_function(
    xyz_world: torch.Tensor,  # (B, ..., pts_per_ray, 3)
    xyz_in_camera_coords: bool,
    global_code: Optional[torch.Tensor],
    camera,
    fun_viewpool: Optional[Callable],
    xyz_embedding_function: Optional[Callable],
    diag_cov: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(B, n_src, n_rays, pts_per_ray, C): the points, in the camera's frame
    where asked, embedded (with the integrated embedding's diagonal
    covariance where given), then the pooled source-view features and the
    global code appended."""
    bs = xyz_world.shape[0]
    n_rays = math.prod(xyz_world.shape[1:-2])
    pts_per_ray = xyz_world.shape[-2]
    if xyz_in_camera_coords:
        if camera is None:
            raise ValueError("Camera must be given if xyz_in_camera_coords")
        points = camera.get_world_to_view_transform().transform_points(xyz_world.reshape(bs, -1, 3)).reshape(
            xyz_world.shape)
    else:
        points = xyz_world
    if xyz_embedding_function is None:
        embeds = xyz_world.new_zeros((bs, 1, n_rays, pts_per_ray, 0))
    else:
        embeds = (xyz_embedding_function(points, diag_cov=diag_cov) if diag_cov is not None
                  else xyz_embedding_function(points))
        embeds = embeds.reshape(bs, 1, n_rays, pts_per_ray, -1)
    if fun_viewpool is not None:
        pooled = fun_viewpool(xyz_world.reshape(bs, -1, 3))
        pooled = pooled.reshape(bs, pooled.shape[1], n_rays, pts_per_ray, -1)
        embeds = torch.cat([embeds.expand(*pooled.shape[:-1], embeds.shape[-1]), pooled], dim=-1)
    if global_code is not None:
        embeds = broadcast_global_code(embeds, global_code)
    return embeds


def get_rays_points_world(ray_bundle=None, rays_points_world: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The world ray points from exactly one of ray_bundle and
    rays_points_world."""
    if rays_points_world is not None and ray_bundle is not None:
        raise ValueError("Cannot define both rays_points_world and ray_bundle, one has to be None.")
    if rays_points_world is not None:
        return rays_points_world
    if ray_bundle is not None:
        return ray_bundle_to_ray_points(ray_bundle)
    raise ValueError("ray_bundle and rays_points_world cannot both be None")
