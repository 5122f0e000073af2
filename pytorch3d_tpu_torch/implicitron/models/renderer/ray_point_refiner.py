"""Importance resampling of ray points from a pass's weights (port of
pytorch3d_tpu/implicitron/models/renderer/ray_point_refiner.py)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ....renderer.implicit.sample_pdf import sample_pdf, sample_pdf_with_draws
from ...tools.config import Configurable
from .base import ImplicitronRayBundle


def apply_blurpool_on_weights(weights: torch.Tensor) -> torch.Tensor:
    """A 2-tap max filter, then a 2-tap blur: a wide, smooth upper envelope
    of the weights (mip-NeRF)."""
    wp = torch.cat([weights[..., :1], weights, weights[..., -1:]], dim=-1)
    weights_max = torch.maximum(wp[..., :-1], wp[..., 1:])
    return 0.5 * (weights_max[..., :-1] + weights_max[..., 1:])


@dataclasses.dataclass
class RayPointRefiner(Configurable):
    """Draws `n_pts_per_ray` depths from the weights' piecewise-constant
    density over the midpoints of the input depths (evenly spaced
    quantiles unless `random_sampling`), with the input depths added where
    `add_input_samples`, sorted."""

    n_pts_per_ray: int = 64
    random_sampling: bool = True
    add_input_samples: bool = True

    def __call__(
        self,
        input_ray_bundle: ImplicitronRayBundle,
        ray_weights: torch.Tensor,  # (..., S)
        blurpool_weights: bool = False,
        sample_pdf_eps: float = 1e-5,
        generator: Optional[torch.Generator] = None,
        u: Optional[torch.Tensor] = None,  # (..., n_pts_per_ray) the quantiles, when random
        **kwargs,
    ) -> ImplicitronRayBundle:
        z_vals = input_ray_bundle.lengths
        w = ray_weights
        if blurpool_weights:
            w = apply_blurpool_on_weights(w) + 0.01
        z_mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        if self.random_sampling and u is not None:
            z_new = sample_pdf_with_draws(z_mid, w[..., 1:-1], u, sample_pdf_eps)
        else:
            z_new = sample_pdf(z_mid, w[..., 1:-1], self.n_pts_per_ray, det=not self.random_sampling,
                               eps=sample_pdf_eps, generator=generator)
        z_new = z_new.detach()
        if self.add_input_samples:
            z_new = torch.cat([z_vals, z_new], dim=-1)
        z_new = torch.sort(z_new, dim=-1).values
        return ImplicitronRayBundle(
            origins=input_ray_bundle.origins,
            directions=input_ray_bundle.directions,
            lengths=z_new,
            xys=input_ray_bundle.xys,
        )
