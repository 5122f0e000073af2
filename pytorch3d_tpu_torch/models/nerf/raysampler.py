"""NeRF ray samplers (port of pytorch3d_tpu/models/nerf/raysampler.py):
Monte Carlo rays at training, the full NDC grid (optionally one chunk of
it) at evaluation, and the importance (fine) resampler.

Random draws come from a `torch.Generator`, or are handed in: the training
rays' xy (`u_xy`), the stratified jiggle (`u_jiggle`) and the fine
sampler's quantiles (`u`), so a test can feed the JAX package's numbers.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ...renderer.implicit.raysampling import MonteCarloRaysampler, NDCMultinomialRaysampler
from ...renderer.implicit.sample_pdf import sample_pdf, sample_pdf_with_draws
from ...renderer.implicit.utils import RayBundle


class NeRFRaysampler:
    """MC rays at train time, the full grid (optionally chunked) at eval."""

    def __init__(
        self,
        n_pts_per_ray: int,
        min_depth: float,
        max_depth: float,
        n_rays_per_image: int,
        image_width: int,
        image_height: int,
        stratified: bool = False,
        stratified_test: bool = False,
    ) -> None:
        self._stratified = stratified
        self._stratified_test = stratified_test
        self._grid_raysampler = NDCMultinomialRaysampler(
            image_width=image_width, image_height=image_height, n_pts_per_ray=n_pts_per_ray,
            min_depth=min_depth, max_depth=max_depth,
        )
        self._mc_raysampler = MonteCarloRaysampler(
            min_x=-1.0, max_x=1.0, min_y=-1.0, max_y=1.0, n_rays_per_image=n_rays_per_image,
            n_pts_per_ray=n_pts_per_ray, min_depth=min_depth, max_depth=max_depth,
        )

    def get_n_chunks(self, chunksize: int, batch_size: int) -> int:
        H, W = self._grid_raysampler.grid_shape
        return int(math.ceil(H * W * batch_size / chunksize))

    def draws_shapes(self, batch: int, training: bool):
        """{name: shape} of the uniforms one call draws."""
        if training:
            return {k: s for k, s in self._mc_raysampler.draws_shapes(batch, self._stratified).items() if s}
        if self._stratified_test:
            H, W = self._grid_raysampler.grid_shape
            return {"jiggle": (batch, H, W, self._grid_raysampler._n_pts_per_ray)}
        return {}

    def __call__(
        self,
        cameras,
        chunksize: Optional[int] = None,
        chunk_idx: int = 0,
        training: bool = True,
        generator: Optional[torch.Generator] = None,
        u_xy: Optional[torch.Tensor] = None,
        u_jiggle: Optional[torch.Tensor] = None,
        **kwargs,
    ) -> RayBundle:
        """Training: (B, n_rays_per_image) MC rays at `u_xy` (drawn when not
        given).  Evaluation: the (B, H, W) grid or, with `chunksize`, rays
        [start, start + chunksize) of the flattened grid, where start =
        chunk_idx * chunksize is clamped to n_rays - chunksize as JAX's
        dynamic_slice clamps it: a last chunk that would run past the grid
        repeats rays of the one before instead of coming back short."""
        if training:
            if u_xy is None:
                return self._mc_raysampler(cameras, stratified_sampling=self._stratified, generator=generator)
            return self._mc_raysampler.with_draws(cameras, u_xy, u_jiggle if self._stratified else None)
        bundle = self._grid_raysampler(
            cameras, stratified_sampling=self._stratified_test, generator=generator, u_jiggle=u_jiggle
        )
        if chunksize is None:
            return bundle
        B = bundle.origins.shape[0]
        flat = {k: getattr(bundle, k).reshape(B, -1, getattr(bundle, k).shape[-1])
                for k in ("origins", "directions", "lengths", "xys")}
        n_rays = flat["origins"].shape[1]
        size = min(chunksize, n_rays)
        start = max(0, min(chunk_idx * chunksize, n_rays - size))
        return RayBundle(**{k: v[:, start : start + size] for k, v in flat.items()})


class ProbabilisticRaysampler:
    """Importance resampling of per-ray depths from the coarse pass's
    emission-absorption weights."""

    def __init__(
        self,
        n_pts_per_ray: int,
        stratified: bool = True,
        stratified_test: bool = False,
        add_input_samples: bool = True,
    ) -> None:
        self._n_pts_per_ray = n_pts_per_ray
        self._stratified = stratified
        self._stratified_test = stratified_test
        self._add_input_samples = add_input_samples

    def stratified(self, training: bool) -> bool:
        return self._stratified if training else self._stratified_test

    def __call__(
        self,
        input_ray_bundle: RayBundle,
        ray_weights: torch.Tensor,  # (..., S)
        training: bool = True,
        generator: Optional[torch.Generator] = None,
        u: Optional[torch.Tensor] = None,  # (..., n_pts_per_ray) quantiles, when stratified
        **kwargs,
    ) -> RayBundle:
        z_vals = input_ray_bundle.lengths
        z_mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        w = ray_weights[..., 1:-1].detach()
        with torch.no_grad():
            if not self.stratified(training):
                z_new = sample_pdf(z_mid, w, self._n_pts_per_ray, det=True)
            elif u is not None:
                z_new = sample_pdf_with_draws(z_mid, w, u)
            else:
                z_new = sample_pdf(z_mid, w, self._n_pts_per_ray, det=False, generator=generator)
            if self._add_input_samples:
                z_new = torch.cat([z_vals, z_new], dim=-1)
            z_new = torch.sort(z_new, dim=-1).values
        return input_ray_bundle.replace(lengths=z_new)
