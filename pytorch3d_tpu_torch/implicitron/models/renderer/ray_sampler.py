"""Implicitron's ray samplers (port of
pytorch3d_tpu/implicitron/models/renderer/ray_sampler.py): rays drawn from
the foreground mask while training and the full grid for evaluation, over
depth bounds from the scene's extent (`AdaptiveRaySampler`) or fixed ones
(`NearFarRaySampler`), optionally cast as cones (mip-NeRF).

Each random draw is taken from a `torch.Generator` unless the caller hands
it in (`select`, `u_jiggle`, `camera_ids`, as `NDCMultinomialRaysampler`
takes them), so a test can feed the JAX package's draws.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ....renderer.implicit.raysampling import NDCMultinomialRaysampler
from ...tools.config import ReplaceableBase, registry
from .base import EvaluationMode, ImplicitronRayBundle, RenderSamplingMode


def compute_radii(
    cameras,
    xy_grid: torch.Tensor,  # (B, ..., 2)
    pixel_hw_ndc: Tuple[float, float],
) -> torch.Tensor:
    """World-space base radii (B, ..., 1) of the conical frustums through
    each pixel: each pixel and its +1 pixel x / y neighbours unprojected to
    the z = 1 plane give the footprint-matched radius (dx + dy) / sqrt(12)."""
    B = xy_grid.shape[0]
    spatial = tuple(xy_grid.shape[1:-1])
    xy = xy_grid.reshape(B, -1, 2)
    n_rays = xy.shape[1]
    xy3 = torch.cat([xy, xy + xy.new_tensor([pixel_hw_ndc[1], 0.0]), xy + xy.new_tensor([0.0, pixel_hw_ndc[0]])],
                    dim=1)
    xyz = torch.cat([xy3, xy3.new_ones((B, 3 * n_rays, 1))], dim=-1)
    plane, plane_dx, plane_dy = cameras.unproject_points(xyz, from_ndc=True).split(n_rays, dim=1)
    dx_norm = torch.linalg.norm(plane_dx - plane, dim=-1, keepdim=True)
    dy_norm = torch.linalg.norm(plane_dy - plane, dim=-1, keepdim=True)
    radii = (dx_norm + dy_norm) / 12**0.5
    return radii.reshape(B, *spatial, 1)


class RaySamplerBase(ReplaceableBase):
    def __call__(self, cameras, evaluation_mode, mask=None, generator=None, **draws):
        raise NotImplementedError


@dataclasses.dataclass
class AbstractMaskRaySampler(RaySamplerBase):
    """Training: rays drawn in proportion to the mask; evaluation: the full
    grid."""

    image_width: int = 400
    image_height: int = 400
    sampling_mode_training: str = "mask_sample"
    sampling_mode_evaluation: str = "full_grid"
    n_pts_per_ray_training: int = 64
    n_pts_per_ray_evaluation: int = 64
    n_rays_per_image_sampled_from_mask: int = 1024
    n_rays_total_training: Optional[int] = None
    stratified_point_sampling_training: bool = True
    stratified_point_sampling_evaluation: bool = False
    cast_ray_bundle_as_cone: bool = False

    def __post_init__(self):
        self._sampling_mode = {
            EvaluationMode.TRAINING: RenderSamplingMode(self.sampling_mode_training),
            EvaluationMode.EVALUATION: RenderSamplingMode(self.sampling_mode_evaluation),
        }
        mask_sample = self._sampling_mode[EvaluationMode.TRAINING] == RenderSamplingMode.MASK_SAMPLE
        if self.n_rays_total_training is not None and not mask_sample:
            raise ValueError("n_rays_total_training requires sampling_mode_training='mask_sample'")
        # Conical frustums sample the bin edges: one point more per ray.
        extra = 1 if self.cast_ray_bundle_as_cone else 0
        if self.cast_ray_bundle_as_cone and self.n_rays_total_training:
            raise TypeError("Heterogeneous ray bundle is not supported for conical frustum computation yet")
        self._training_raysampler = NDCMultinomialRaysampler(
            image_width=self.image_width,
            image_height=self.image_height,
            n_pts_per_ray=self.n_pts_per_ray_training + extra,
            min_depth=0.0,
            max_depth=0.0,
            n_rays_per_image=self.n_rays_per_image_sampled_from_mask
            if mask_sample and self.n_rays_total_training is None
            else None,
            n_rays_total=self.n_rays_total_training,
            unit_directions=True,
            stratified_sampling=self.stratified_point_sampling_training,
        )
        self._evaluation_raysampler = NDCMultinomialRaysampler(
            image_width=self.image_width,
            image_height=self.image_height,
            n_pts_per_ray=self.n_pts_per_ray_evaluation + extra,
            min_depth=0.0,
            max_depth=0.0,
            n_rays_per_image=None,
            unit_directions=True,
            stratified_sampling=self.stratified_point_sampling_evaluation,
        )

    def _get_min_max_depth_bounds(self, cameras):
        raise NotImplementedError

    def __call__(
        self,
        cameras,
        evaluation_mode: EvaluationMode = EvaluationMode.EVALUATION,
        mask: Optional[torch.Tensor] = None,  # (B, H, W)
        generator: Optional[torch.Generator] = None,
        select: Optional[torch.Tensor] = None,
        u_jiggle: Optional[torch.Tensor] = None,
        camera_ids: Optional[torch.Tensor] = None,
    ) -> ImplicitronRayBundle:
        """The bundle for `evaluation_mode`; `select`, `u_jiggle` and
        `camera_ids` are `NDCMultinomialRaysampler`'s draws, taken from
        `generator` where not given."""
        sample_mask = mask if self._sampling_mode[evaluation_mode] == RenderSamplingMode.MASK_SAMPLE else None
        min_depth, max_depth = self._get_min_max_depth_bounds(cameras)
        raysampler = {
            EvaluationMode.TRAINING: self._training_raysampler,
            EvaluationMode.EVALUATION: self._evaluation_raysampler,
        }[evaluation_mode]
        bundle = raysampler(
            cameras, mask=sample_mask, min_depth=min_depth, max_depth=max_depth, generator=generator,
            select=select, u_jiggle=u_jiggle, camera_ids=camera_ids,
        )
        if self.cast_ray_bundle_as_cone:
            # The sampled depths are bin edges; the lengths are their midpoints.
            rs = self._training_raysampler
            pixel_hw = (
                abs(rs.max_y - rs.min_y) / max(self.image_height - 1, 1),
                abs(rs.max_x - rs.min_x) / max(self.image_width - 1, 1),
            )
            bins = bundle.lengths
            return ImplicitronRayBundle(
                origins=bundle.origins,
                directions=bundle.directions,
                lengths=0.5 * (bins[..., 1:] + bins[..., :-1]),
                xys=bundle.xys,
                bins=bins,
                pixel_radii_2d=compute_radii(cameras, bundle.xys[..., :2], pixel_hw),
            )
        return ImplicitronRayBundle(
            origins=bundle.origins,
            directions=bundle.directions,
            lengths=bundle.lengths,
            xys=bundle.xys,
            camera_ids=getattr(bundle, "camera_ids", None),
            camera_counts=getattr(bundle, "camera_counts", None),
        )


@registry.register
@dataclasses.dataclass
class AdaptiveRaySampler(AbstractMaskRaySampler):
    """Depths within `scene_extent` of the cameras' mean distance to
    `scene_center` (the near bound at least 1e-3), computed on the cameras'
    device."""

    scene_extent: float = 8.0
    scene_center: Tuple[float, float, float] = (0.0, 0.0, 0.0)

    def _get_min_max_depth_bounds(self, cameras):
        cam_center = cameras.get_camera_center()
        center = torch.tensor(self.scene_center, dtype=cam_center.dtype, device=cam_center.device)
        d = torch.linalg.norm(cam_center - center, dim=-1).mean()
        return (d - self.scene_extent).clamp(min=1e-3), d + self.scene_extent


@registry.register
@dataclasses.dataclass
class NearFarRaySampler(AbstractMaskRaySampler):
    """Fixed near and far bounds."""

    min_depth: float = 0.1
    max_depth: float = 8.0

    def _get_min_max_depth_bounds(self, cameras):
        return self.min_depth, self.max_depth
