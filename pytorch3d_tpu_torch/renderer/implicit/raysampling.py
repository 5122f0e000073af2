"""Ray samplers: the NDC grid and Monte Carlo (port of
pytorch3d_tpu/renderer/implicit/raysampling.py).

Ported: `_xy_to_ray_bundle`, the stratified depth jiggle, the grid branch
of `MultinomialRaysampler` with `NDCMultinomialRaysampler`, and
`MonteCarloRaysampler` with `n_rays_total=None`.  Each random step has a
form that takes its uniforms as an argument (`u_xy`, `u_jiggle`), so a test
can feed both packages the same numbers; without them the samplers draw
from a `torch.Generator`.  The multinomial subsampling of the grid
(`n_rays_per_image`, masks) and the heterogeneous bundles of `n_rays_total`
wait for a later slice.
"""

from __future__ import annotations

from typing import Optional

import torch

from .utils import RayBundle


def _jiggle_within_stratas_with_draws(bin_centers: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Move each depth to lower + (upper - lower) * u within its stratum,
    the strata bounded by the midpoints between neighbouring depths."""
    mids = 0.5 * (bin_centers[..., 1:] + bin_centers[..., :-1])
    upper = torch.cat([mids, bin_centers[..., -1:]], dim=-1)
    lower = torch.cat([bin_centers[..., :1], mids], dim=-1)
    return lower + (upper - lower) * u


def _jiggle_within_stratas(bin_centers: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    u = torch.rand(bin_centers.shape, generator=generator, dtype=bin_centers.dtype, device=bin_centers.device)
    return _jiggle_within_stratas_with_draws(bin_centers, u)


def _xy_to_ray_bundle(
    cameras,
    xy_grid: torch.Tensor,  # (B, ..., 2) NDC
    min_depth: float,
    max_depth: float,
    n_pts_per_ray: int,
    unit_directions: bool = False,
    u_jiggle: Optional[torch.Tensor] = None,  # (B, ..., n_pts_per_ray): stratify with these
) -> RayBundle:
    """Unproject NDC xy into world rays: the points at view depths 1 and 2
    give each ray's direction, its origin lies at depth 0, and its lengths
    are n_pts_per_ray depths spaced evenly over [min_depth, max_depth]
    (jiggled within their strata where `u_jiggle` is given)."""
    B = xy_grid.shape[0]
    spatial = tuple(xy_grid.shape[1:-1])
    xy = xy_grid.reshape(B, -1, 2)
    n_rays = xy.shape[1]
    ones = torch.ones_like(xy[..., :1])
    plane1 = cameras.unproject_points(torch.cat([xy, ones], dim=-1), from_ndc=True)
    plane2 = cameras.unproject_points(torch.cat([xy, 2.0 * ones], dim=-1), from_ndc=True)
    directions = plane2 - plane1
    origins = plane1 - directions
    if n_pts_per_ray > 0:
        depths = torch.linspace(min_depth, max_depth, n_pts_per_ray, dtype=xy.dtype, device=xy.device)
        lengths = depths.expand(B, n_rays, n_pts_per_ray)
        if u_jiggle is not None:
            lengths = _jiggle_within_stratas_with_draws(lengths, u_jiggle.reshape(B, n_rays, n_pts_per_ray))
    else:
        lengths = xy.new_zeros((B, n_rays, 0))
    if unit_directions:
        norm = torch.linalg.norm(directions, dim=-1, keepdim=True)
        directions = directions / norm.clamp(min=1e-12)
        lengths = lengths * norm
    return RayBundle(
        origins=origins.reshape(B, *spatial, 3),
        directions=directions.reshape(B, *spatial, 3),
        lengths=lengths.reshape(B, *spatial, n_pts_per_ray),
        xys=xy_grid,
    )


class MultinomialRaysampler:
    """Rays through every point of an xy grid over [min_x, max_x] x
    [min_y, max_y] (the grid branch: no subsampling)."""

    def __init__(
        self,
        *,
        min_x: float,
        max_x: float,
        min_y: float,
        max_y: float,
        image_width: int,
        image_height: int,
        n_pts_per_ray: int,
        min_depth: float,
        max_depth: float,
        n_rays_per_image: Optional[int] = None,
        n_rays_total: Optional[int] = None,
        unit_directions: bool = False,
        stratified_sampling: bool = False,
    ) -> None:
        if n_rays_per_image is not None or n_rays_total is not None:
            raise NotImplementedError(
                "subsampling the grid (n_rays_per_image, n_rays_total) waits for a later slice of the port"
            )
        self._n_pts_per_ray = n_pts_per_ray
        self._min_depth = min_depth
        self._max_depth = max_depth
        self._unit_directions = unit_directions
        self._stratified_sampling = stratified_sampling
        self.min_x, self.max_x = min_x, max_x
        self.min_y, self.max_y = min_y, max_y
        ys, xs = torch.meshgrid(
            torch.linspace(min_y, max_y, image_height, dtype=torch.float32),
            torch.linspace(min_x, max_x, image_width, dtype=torch.float32),
            indexing="ij",
        )
        self._xy_grid = torch.stack([xs, ys], dim=-1)  # (H, W, 2)
        self._grid_on = {}  # device -> the grid there, copied once

    @property
    def grid_shape(self):
        return tuple(self._xy_grid.shape[:2])

    def __call__(
        self,
        cameras,
        *,
        stratified_sampling: Optional[bool] = None,
        generator: Optional[torch.Generator] = None,
        u_jiggle: Optional[torch.Tensor] = None,
        **kwargs,
    ) -> RayBundle:
        """A bundle of (B, H, W) rays; stratified depths take `u_jiggle`
        (B, H, W, n_pts_per_ray) where given, else draws from `generator`."""
        B = len(cameras)
        n_pts = self._n_pts_per_ray
        stratified = self._stratified_sampling if stratified_sampling is None else stratified_sampling
        if cameras.device not in self._grid_on:
            self._grid_on[cameras.device] = self._xy_grid.to(cameras.device)
        xy_grid = self._grid_on[cameras.device].expand(B, *self._xy_grid.shape)
        if stratified and u_jiggle is None and n_pts > 0:
            u_jiggle = torch.rand((B, *self._xy_grid.shape[:2], n_pts), generator=generator, device=cameras.device)
        return _xy_to_ray_bundle(
            cameras, xy_grid, self._min_depth, self._max_depth, n_pts, self._unit_directions,
            u_jiggle if stratified else None,
        )


class NDCMultinomialRaysampler(MultinomialRaysampler):
    """The grid over the full NDC range at the pixel centres (+X left, +Y
    up: x runs from +range to -range across the image)."""

    def __init__(
        self,
        *,
        image_width: int,
        image_height: int,
        n_pts_per_ray: int,
        min_depth: float,
        max_depth: float,
        n_rays_per_image: Optional[int] = None,
        n_rays_total: Optional[int] = None,
        unit_directions: bool = False,
        stratified_sampling: bool = False,
    ) -> None:
        if image_width >= image_height:
            range_x, range_y = image_width / image_height, 1.0
        else:
            range_x, range_y = 1.0, image_height / image_width
        half_pix_width = range_x / image_width
        half_pix_height = range_y / image_height
        super().__init__(
            min_x=range_x - half_pix_width, max_x=-range_x + half_pix_width,
            min_y=range_y - half_pix_height, max_y=-range_y + half_pix_height,
            image_width=image_width, image_height=image_height, n_pts_per_ray=n_pts_per_ray,
            min_depth=min_depth, max_depth=max_depth, n_rays_per_image=n_rays_per_image,
            n_rays_total=n_rays_total, unit_directions=unit_directions,
            stratified_sampling=stratified_sampling,
        )


class MonteCarloRaysampler:
    """n_rays_per_image rays at uniform random xy in [min_x, max_x] x
    [min_y, max_y] per camera."""

    def __init__(
        self,
        min_x: float,
        max_x: float,
        min_y: float,
        max_y: float,
        n_rays_per_image: int,
        n_pts_per_ray: int,
        min_depth: float,
        max_depth: float,
        *,
        n_rays_total: Optional[int] = None,
        unit_directions: bool = False,
        stratified_sampling: bool = False,
    ) -> None:
        if n_rays_total is not None:
            raise NotImplementedError("n_rays_total (heterogeneous bundles) waits for a later slice of the port")
        self._bounds = (min_x, max_x, min_y, max_y)
        self._n_rays_per_image = n_rays_per_image
        self._n_pts_per_ray = n_pts_per_ray
        self._min_depth = min_depth
        self._max_depth = max_depth
        self._unit_directions = unit_directions
        self._stratified_sampling = stratified_sampling

    def draws_shapes(self, batch: int, stratified_sampling: Optional[bool] = None):
        """{"xy": shape, "jiggle": shape or None}: the uniforms one call needs."""
        stratified = self._stratified_sampling if stratified_sampling is None else stratified_sampling
        R = self._n_rays_per_image
        return {"xy": (batch, R, 2), "jiggle": (batch, R, self._n_pts_per_ray) if stratified else None}

    def with_draws(
        self,
        cameras,
        u_xy: torch.Tensor,  # (B, n_rays_per_image, 2) in [0, 1)
        u_jiggle: Optional[torch.Tensor] = None,  # (B, n_rays_per_image, n_pts_per_ray)
    ) -> RayBundle:
        """The bundle at the given uniforms; depths are stratified exactly
        when `u_jiggle` is given."""
        min_x, max_x, min_y, max_y = self._bounds
        xy = torch.stack(
            [u_xy[..., 0] * (max_x - min_x) + min_x, u_xy[..., 1] * (max_y - min_y) + min_y], dim=-1
        )
        return _xy_to_ray_bundle(
            cameras, xy, self._min_depth, self._max_depth, self._n_pts_per_ray, self._unit_directions, u_jiggle
        )

    def __call__(
        self,
        cameras,
        *,
        stratified_sampling: Optional[bool] = None,
        generator: Optional[torch.Generator] = None,
        **kwargs,
    ) -> RayBundle:
        shapes = self.draws_shapes(len(cameras), stratified_sampling)
        u = {k: None if s is None else torch.rand(s, generator=generator, device=cameras.device)
             for k, s in shapes.items()}
        return self.with_draws(cameras, u["xy"], u["jiggle"])
