"""Ray samplers: the xy grid (whole or subsampled), the NDC grid and Monte
Carlo (port of pytorch3d_tpu/renderer/implicit/raysampling.py), with the
deprecated factories `GridRaysampler` and `NDCGridRaysampler`.

Each random step takes its draws as an argument where the caller has them
(`u_xy`, `u_jiggle`, `select`, `camera_ids`), so a test can feed both
packages the same numbers; without them the samplers draw from a
`torch.Generator`.  With `n_rays_total` the rays come from cameras drawn
uniformly per ray and are packed into a `HeterogeneousRayBundle` of
(n_rays_total, 1) rays, whose camera counts cover every camera of the batch
(the JAX package's static-shape form).
"""

from __future__ import annotations

import warnings
from typing import Optional

import torch

from .utils import HeterogeneousRayBundle, RayBundle


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


def _linspace(start, stop, n: int, like: torch.Tensor) -> torch.Tensor:
    """n depths from start to stop.  Bounds that are 0-dim tensors (computed
    on the device, as `AdaptiveRaySampler`'s) stay there, with no host
    read: start * (1 - i / (n - 1)) + stop * i / (n - 1), and stop itself
    last, as `jnp.linspace` computes them (`torch.linspace` reads tensor
    bounds on the host).  Float bounds keep `torch.linspace`: the other
    formula moves the NeRF paths' depths by an ulp, and on those rays
    chip_smoke's nerf-train step-0 gate (fused field against the plain one
    within 1e-4 on a shared fine bundle) fails by the plain float32 field's
    own distance from float64 (1.2e-3 of the largest gradient; the fused
    field's 2.2e-4)."""
    if not isinstance(start, torch.Tensor) and not isinstance(stop, torch.Tensor):
        return torch.linspace(start, stop, n, dtype=like.dtype, device=like.device)
    start, stop = (torch.as_tensor(b, dtype=like.dtype, device=like.device) for b in (start, stop))
    if n == 1:
        return start.reshape(1)
    step = torch.arange(n - 1, dtype=like.dtype, device=like.device) / (n - 1)
    return torch.cat([start * (1 - step) + stop * step, stop.reshape(1)])


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
        depths = _linspace(min_depth, max_depth, n_pts_per_ray, xy)
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


def _gumbel(shape, generator, device) -> torch.Tensor:
    """Standard Gumbel noise, -log(-log(u)) with u in [tiny, 1)."""
    u = torch.rand(shape, generator=generator, device=device).clamp(min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def _subsample_rays(flat_xy: torch.Tensor, n_rays: int, mask: Optional[torch.Tensor], select: Optional[torch.Tensor],
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """n_rays of each image's H*W grid points, (B, n_rays, 2).

    `select` holds the draws that decide the choice (drawn from `generator`
    when None), one of three kinds as the JAX package chooses:
    - with a `mask` (B, H, W) of weights: Gumbel noise (B, n_rays, H*W);
      each ray takes the argmax of log(max(mask, 1e-12)) + noise, a draw
      with replacement in proportion to the mask;
    - without a mask, n_rays <= H*W: sort keys (B, H*W); the rays are the
      points of the n_rays smallest keys in key order (no replacement);
    - without a mask, n_rays > H*W: the points' indices (B, n_rays) in
      [0, H*W), with replacement."""
    B, HW, _ = flat_xy.shape
    device = flat_xy.device
    if mask is not None:
        if select is None:
            select = _gumbel((B, n_rays, HW), generator, device)
        logits = torch.log(mask.reshape(B, 1, HW).to(flat_xy.dtype).clamp(min=1e-12))
        idx = torch.argmax(logits + select, dim=-1)
    elif n_rays <= HW:
        if select is None:
            select = torch.rand((B, HW), generator=generator, device=device)
        idx = torch.argsort(select, dim=-1, stable=True)[:, :n_rays]
    else:
        idx = torch.randint(HW, (B, n_rays), generator=generator, device=device) if select is None else select
    return torch.gather(flat_xy, 1, idx[..., None].expand(B, n_rays, 2))


def _draw_camera_ids(cameras, n_rays_total: int, generator: Optional[torch.Generator]) -> torch.Tensor:
    """A camera of the batch drawn uniformly for each of n_rays_total rays."""
    return torch.randint(len(cameras), (n_rays_total,), generator=generator, device=cameras.device)


def _pick_cameras(cameras, camera_ids: torch.Tensor):
    """(cameras[camera_ids], the rays of each camera of the batch)."""
    return cameras[camera_ids], torch.bincount(camera_ids, minlength=len(cameras))


class MultinomialRaysampler:
    """Rays through the points of an xy grid over [min_x, max_x] x
    [min_y, max_y]: every point, or `n_rays_per_image` of each image's
    points (in proportion to a `mask` where given), or, with `n_rays_total`,
    that many rays each from a camera drawn uniformly, packed into a
    `HeterogeneousRayBundle`."""

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
        self._n_pts_per_ray = n_pts_per_ray
        self._min_depth = min_depth
        self._max_depth = max_depth
        self._n_rays_per_image = n_rays_per_image
        self._n_rays_total = n_rays_total
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
        mask: Optional[torch.Tensor] = None,
        min_depth: Optional[float] = None,
        max_depth: Optional[float] = None,
        n_rays_per_image: Optional[int] = None,
        n_pts_per_ray: Optional[int] = None,
        stratified_sampling: Optional[bool] = None,
        n_rays_total: Optional[int] = None,
        generator: Optional[torch.Generator] = None,
        camera_ids: Optional[torch.Tensor] = None,
        select: Optional[torch.Tensor] = None,
        u_jiggle: Optional[torch.Tensor] = None,
        **kwargs,
    ) -> RayBundle:
        """A bundle of (B, H, W) rays, of (B, n_rays_per_image) with
        subsampling, or a `HeterogeneousRayBundle` of (n_rays_total, 1) rays.

        Each draw is taken from `generator` unless handed in: `camera_ids`
        (n_rays_total,) the cameras of the rays, `select` the subsampling's
        draws (`_subsample_rays` says which), `u_jiggle` the stratified
        depths' uniforms, (B, rays, n_pts_per_ray) with rays the grid's
        (H, W) or the subsample's count."""
        n_rays_total = n_rays_total or self._n_rays_total
        n_rays_per_image = self._n_rays_per_image if n_rays_per_image is None else n_rays_per_image
        min_depth = self._min_depth if min_depth is None else min_depth
        max_depth = self._max_depth if max_depth is None else max_depth
        n_pts = self._n_pts_per_ray if n_pts_per_ray is None else n_pts_per_ray
        stratified = self._stratified_sampling if stratified_sampling is None else stratified_sampling
        if n_rays_total:
            if n_rays_per_image:
                raise ValueError("`n_rays_total` and `n_rays_per_image` cannot both be defined.")
            if camera_ids is None:
                camera_ids = _draw_camera_ids(cameras, n_rays_total, generator)
            cameras, camera_counts = _pick_cameras(cameras, camera_ids)
            if mask is not None:
                mask = mask[camera_ids]
            n_rays_per_image = 1
        B = len(cameras)
        if cameras.device not in self._grid_on:
            self._grid_on[cameras.device] = self._xy_grid.to(cameras.device)
        xy_grid = self._grid_on[cameras.device].expand(B, *self._xy_grid.shape)
        if n_rays_per_image is not None:
            xy_grid = _subsample_rays(xy_grid.reshape(B, -1, 2), n_rays_per_image, mask, select, generator)
        if stratified and u_jiggle is None and n_pts > 0:
            u_jiggle = torch.rand((*xy_grid.shape[:-1], n_pts), generator=generator, device=cameras.device)
        bundle = _xy_to_ray_bundle(
            cameras, xy_grid, min_depth, max_depth, n_pts, self._unit_directions, u_jiggle if stratified else None,
        )
        if not n_rays_total:
            return bundle
        return HeterogeneousRayBundle(**vars(bundle), camera_ids=camera_ids, camera_counts=camera_counts)


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


# Deprecated positional-argument factories of the reference.
def GridRaysampler(
    min_x: float,
    max_x: float,
    min_y: float,
    max_y: float,
    image_width: int,
    image_height: int,
    n_pts_per_ray: int,
    min_depth: float,
    max_depth: float,
) -> MultinomialRaysampler:
    """DEPRECATED: use MultinomialRaysampler."""
    warnings.warn("GridRaysampler is deprecated, use MultinomialRaysampler instead.", PendingDeprecationWarning)
    return MultinomialRaysampler(
        min_x=min_x, max_x=max_x, min_y=min_y, max_y=max_y, image_width=image_width, image_height=image_height,
        n_pts_per_ray=n_pts_per_ray, min_depth=min_depth, max_depth=max_depth,
    )


def NDCGridRaysampler(
    image_width: int,
    image_height: int,
    n_pts_per_ray: int,
    min_depth: float,
    max_depth: float,
) -> NDCMultinomialRaysampler:
    """DEPRECATED: use NDCMultinomialRaysampler."""
    warnings.warn("NDCGridRaysampler is deprecated, use NDCMultinomialRaysampler instead.",
                  PendingDeprecationWarning)
    return NDCMultinomialRaysampler(
        image_width=image_width, image_height=image_height, n_pts_per_ray=n_pts_per_ray, min_depth=min_depth,
        max_depth=max_depth,
    )


class MonteCarloRaysampler:
    """n_rays_per_image rays at uniform random xy in [min_x, max_x] x
    [min_y, max_y] per camera; with `n_rays_total`, that many rays each from
    a camera drawn uniformly, packed into a `HeterogeneousRayBundle`."""

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
        self._bounds = (min_x, max_x, min_y, max_y)
        self._n_rays_per_image = n_rays_per_image
        self._n_rays_total = n_rays_total
        self._n_pts_per_ray = n_pts_per_ray
        self._min_depth = min_depth
        self._max_depth = max_depth
        self._unit_directions = unit_directions
        self._stratified_sampling = stratified_sampling

    def draws_shapes(self, batch: int, stratified_sampling: Optional[bool] = None, n_rays_total: Optional[int] = None):
        """{"xy": shape, "jiggle": shape or None}: the uniforms one call
        needs; with n_rays_total (here or at construction) `batch` is ignored
        and the rays are (n_rays_total, 1)."""
        stratified = self._stratified_sampling if stratified_sampling is None else stratified_sampling
        n_rays_total = n_rays_total or self._n_rays_total
        B, R = (n_rays_total, 1) if n_rays_total else (batch, self._n_rays_per_image)
        return {"xy": (B, R, 2), "jiggle": (B, R, self._n_pts_per_ray) if stratified else None}

    def with_draws(
        self,
        cameras,
        u_xy: torch.Tensor,  # (B, n_rays_per_image, 2) in [0, 1), or (n_rays_total, 1, 2)
        u_jiggle: Optional[torch.Tensor] = None,  # (B, n_rays_per_image, n_pts_per_ray)
        camera_ids: Optional[torch.Tensor] = None,  # (n_rays_total,)
    ) -> RayBundle:
        """The bundle at the given uniforms; depths are stratified exactly
        when `u_jiggle` is given, and the rays come from the cameras
        `camera_ids` (a `HeterogeneousRayBundle`) when those are given."""
        camera_counts = None
        if camera_ids is not None:
            cameras, camera_counts = _pick_cameras(cameras, camera_ids)
        min_x, max_x, min_y, max_y = self._bounds
        xy = torch.stack(
            [u_xy[..., 0] * (max_x - min_x) + min_x, u_xy[..., 1] * (max_y - min_y) + min_y], dim=-1
        )
        bundle = _xy_to_ray_bundle(
            cameras, xy, self._min_depth, self._max_depth, self._n_pts_per_ray, self._unit_directions, u_jiggle
        )
        if camera_ids is None:
            return bundle
        return HeterogeneousRayBundle(**vars(bundle), camera_ids=camera_ids, camera_counts=camera_counts)

    def __call__(
        self,
        cameras,
        *,
        stratified_sampling: Optional[bool] = None,
        n_rays_total: Optional[int] = None,
        generator: Optional[torch.Generator] = None,
        **kwargs,
    ) -> RayBundle:
        n_rays_total = n_rays_total or self._n_rays_total
        camera_ids = _draw_camera_ids(cameras, n_rays_total, generator) if n_rays_total else None
        shapes = self.draws_shapes(len(cameras), stratified_sampling, n_rays_total)
        u = {k: None if s is None else torch.rand(s, generator=generator, device=cameras.device)
             for k, s in shapes.items()}
        return self.with_draws(cameras, u["xy"], u["jiggle"], camera_ids)
