"""Renderer base types for Implicitron (port of
pytorch3d_tpu/implicitron/models/renderer/base.py): the evaluation and
sampling modes, the ray bundle, a pass's output, the renderer base, the
argument-binding wrapper of an implicit function, and the conical-frustum
Gaussians of mip-NeRF.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Dict, List, Optional, Tuple

import torch

from ...tools.config import ReplaceableBase


class EvaluationMode(enum.Enum):
    TRAINING = "training"
    EVALUATION = "evaluation"


class RenderSamplingMode(enum.Enum):
    MASK_SAMPLE = "mask_sample"
    FULL_GRID = "full_grid"


@dataclasses.dataclass
class ImplicitronRayBundle:
    """Rays: origins / directions (..., 3), lengths (..., S), xys (..., 2);
    for a heterogeneous bundle each row's camera and the rows of each camera;
    for a cone-cast bundle the bin edges (..., S + 1) and each ray's radius
    (..., 1)."""

    origins: torch.Tensor
    directions: torch.Tensor
    lengths: torch.Tensor
    xys: torch.Tensor
    camera_ids: Optional[torch.Tensor] = None
    camera_counts: Optional[torch.Tensor] = None
    bins: Optional[torch.Tensor] = None
    pixel_radii_2d: Optional[torch.Tensor] = None

    def is_packed(self) -> bool:
        """True for a heterogeneous (one ray a row) bundle."""
        return self.camera_ids is not None and self.camera_counts is not None

    def replace(self, **changes) -> "ImplicitronRayBundle":
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass
class RendererOutput:
    """One pass's render; the passes chain through `prev_stage`."""

    features: torch.Tensor
    depths: torch.Tensor
    masks: torch.Tensor
    prev_stage: Optional["RendererOutput"] = None
    normals: Optional[torch.Tensor] = None
    points: Optional[torch.Tensor] = None
    weights: Optional[torch.Tensor] = None
    aux: Dict[str, Any] = dataclasses.field(default_factory=dict)


class BaseRenderer(ReplaceableBase):
    """Renderer plugin base."""

    def requires_object_mask(self) -> bool:
        return False

    def __call__(
        self,
        ray_bundle: ImplicitronRayBundle,
        implicit_functions: List,
        evaluation_mode: EvaluationMode = EvaluationMode.EVALUATION,
        **kwargs,
    ) -> RendererOutput:
        raise NotImplementedError


class ImplicitFunctionWrapper:
    """Binds extra keyword arguments to an implicit function for the
    duration of a render pass."""

    def __init__(self, fn) -> None:
        self._fn = fn
        self.bound_args: Dict[str, Any] = {}

    def bind_args(self, **bound_args) -> None:
        self.bound_args = bound_args
        on_bind = getattr(self._fn, "on_bind_args", None)
        if on_bind is not None:
            on_bind()

    def unbind_args(self) -> None:
        self.bound_args = {}

    def __call__(self, *args, **kwargs):
        return self._fn(*args, **{**kwargs, **self.bound_args})


# mip-NeRF's conical-frustum Gaussians.


def compute_3d_diagonal_covariance_gaussian(
    rays_directions: torch.Tensor,  # (..., 3)
    rays_dir_variance: torch.Tensor,  # (..., num_intervals)
    radii_variance: torch.Tensor,  # (..., num_intervals)
    eps: float = 1e-6,
) -> torch.Tensor:
    """Diagonal covariances (..., num_intervals, 3) of the frustum Gaussians
    in world coordinates (mip-NeRF eq. 16)."""
    d_outer_diag = rays_directions**2
    dir_mag_sq = d_outer_diag.sum(dim=-1, keepdim=True).clamp(min=eps)
    null_outer_diag = 1 - d_outer_diag / dir_mag_sq
    ray_dir_cov_diag = rays_dir_variance[..., None] * d_outer_diag[..., None, :]
    xy_cov_diag = radii_variance[..., None] * null_outer_diag[..., None, :]
    return ray_dir_cov_diag + xy_cov_diag


def approximate_conical_frustum_as_gaussians(
    bins: torch.Tensor,  # (..., num_points_per_ray + 1)
    radii: torch.Tensor,  # (..., 1)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The stable mean and variance of each frustum along its ray and the
    variance of its radius (mip-NeRF eq. 7)."""
    t_mu = 0.5 * (bins[..., 1:] + bins[..., :-1])
    t_delta = torch.diff(bins, dim=-1) / 2

    t_mu_pow2 = t_mu**2
    t_delta_pow2 = t_delta**2
    t_delta_pow4 = t_delta**4
    den = 3 * t_mu_pow2 + t_delta_pow2

    rays_dir_mean = t_mu + 2 * t_mu * t_delta_pow2 / den
    rays_dir_variance = t_delta_pow2 / 3 - (4 / 15) * (t_delta_pow4 * (12 * t_mu_pow2 - t_delta_pow2) / den**2)
    radii_variance = radii**2 * (t_mu_pow2 / 4 + (5 / 12) * t_delta_pow2 - 4 / 15 * t_delta_pow4 / den)
    return rays_dir_mean, rays_dir_variance, radii_variance


def conical_frustum_to_gaussian(ray_bundle: ImplicitronRayBundle) -> Tuple[torch.Tensor, torch.Tensor]:
    """(means, diagonal covariances) of the Gaussians approximating the
    conical frustums of a cone-cast bundle."""
    if ray_bundle.pixel_radii_2d is None or ray_bundle.bins is None:
        raise ValueError(
            "RayBundle pixel_radii_2d or bins have not been provided. "
            "Have you forgotten to set `cast_ray_bundle_as_cone` to True?"
        )
    rays_dir_mean, rays_dir_variance, radii_variance = approximate_conical_frustum_as_gaussians(
        ray_bundle.bins, ray_bundle.pixel_radii_2d
    )
    means = ray_bundle.origins[..., None, :] + rays_dir_mean[..., None] * ray_bundle.directions[..., None, :]
    diag_covariances = compute_3d_diagonal_covariance_gaussian(
        ray_bundle.directions, rays_dir_variance, radii_variance
    )
    return means, diag_covariances
