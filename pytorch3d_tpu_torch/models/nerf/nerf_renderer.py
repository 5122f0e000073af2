"""RadianceFieldRenderer: the coarse + fine NeRF pipeline as one torch module
(port of pytorch3d_tpu/models/nerf/nerf_renderer.py).

At training a Monte-Carlo ray batch runs both passes; at evaluation the
image grid is rendered whole or one chunk at a time.  The random draws of a
call (the MC rays' xy, the stratified jiggle, the fine sampler's quantiles
and the density noise) come from `make_draws` with a `torch.Generator`, or
from the caller as a dict, so a test can hand in the numbers the JAX
package drew from its key.  Both fields run the fused NeRF field (kernels
#12/#13 on the card) unless `use_fused_kernel=False`.

`remat=True` checkpoints each field call (`_RematField`): the forward
keeps only the call's inputs and runs the field without autograd (on the
card #12's serving build, which stores nothing), and the backward runs it
again with autograd (#12's saving build) and takes the gradients from that
(#13 on what the saving build stored).  So a training step launches #12
four times instead of two, and holds no field activations between its
forward and backward.

`ray_sharding` (`parallel.shard_rays(mesh)`) keeps this rank's share of
each (B, R, ...) ray tensor, and of the batch of `image` and of the draws
that follow the rays: the call renders and scores only those rays, as one
device of the JAX package's sharded call does.  The draws are the global
ones, so the ranks together sample exactly the rays one device samples.

Left for later slices: dtypes other than float32, which raise
NotImplementedError.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Union

import torch
from torch import nn

from ...common import DEFAULT_DEVICE
from .implicit_function import NeuralRadianceField
from .raymarcher import EmissionAbsorptionNeRFRaymarcher
from .raysampler import NeRFRaysampler, ProbabilisticRaysampler
from .utils import calc_mse, calc_psnr, sample_images_at_mc_locs

Device = Union[str, torch.device]


class _RematField(torch.autograd.Function):
    """One checkpointed field call: `field(bundle, std, noise)` run without
    autograd in the forward and again with it in the backward."""

    @staticmethod
    def forward(ctx, field, bundle, density_noise_std, noise, *params):
        ctx.field, ctx.bundle, ctx.std, ctx.noise, ctx.params = field, bundle, density_noise_std, noise, params
        with torch.no_grad():
            return field(bundle, density_noise_std, noise=noise)

    @staticmethod
    def backward(ctx, *grads):
        params = ctx.params
        with torch.enable_grad():
            outs = ctx.field(ctx.bundle, ctx.std, noise=ctx.noise)
        wanted = [p for p in params if p.requires_grad]
        got = iter(torch.autograd.grad(outs, wanted, grads, allow_unused=True))
        ctx.field = ctx.bundle = ctx.noise = ctx.params = None
        return (None, None, None, None, *(next(got) if p.requires_grad else None for p in params))


def _field_call(field, bundle, density_noise_std, noise, remat):
    """(densities, colours) of `field` on `bundle`, checkpointed with remat
    when autograd records the call."""
    params = tuple(field.parameters())
    if remat and torch.is_grad_enabled() and any(p.requires_grad for p in params):
        return _RematField.apply(field, bundle, density_noise_std, noise, *params)
    return field(bundle, density_noise_std, noise=noise)


class RadianceFieldRenderer(nn.Module):
    def __init__(
        self,
        image_width: int,
        image_height: int,
        n_pts_per_ray: int = 64,
        n_pts_per_ray_fine: int = 64,
        remat: bool = False,
        n_rays_per_image: int = 1024,
        min_depth: float = 0.1,
        max_depth: float = 100.0,
        stratified: bool = True,
        stratified_test: bool = False,
        density_noise_std: float = 0.0,
        n_harmonic_functions_xyz: int = 6,
        n_harmonic_functions_dir: int = 4,
        n_hidden_neurons_xyz: int = 256,
        n_hidden_neurons_dir: int = 128,
        n_layers_xyz: int = 8,
        append_xyz: Sequence[int] = (5,),
        bg_color: Sequence[float] = (0.0, 0.0, 0.0),
        dtype: torch.dtype = torch.float32,
        use_fused_kernel: bool = True,
        device: Device = DEFAULT_DEVICE,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        """`generator` (on `device`) draws the initial weights: xavier-uniform
        kernels and zero biases, as flax initialises them."""
        super().__init__()
        if dtype != torch.float32:
            raise NotImplementedError("the port's NeRF runs in float32 only so far")
        self.n_pts_per_ray = n_pts_per_ray
        self.n_pts_per_ray_fine = n_pts_per_ray_fine
        self.density_noise_std = density_noise_std
        self.remat = remat
        self.register_buffer("bg_color", torch.tensor(bg_color, dtype=torch.float32, device=device), persistent=False)
        field = dict(
            n_harmonic_functions_xyz=n_harmonic_functions_xyz, n_harmonic_functions_dir=n_harmonic_functions_dir,
            n_hidden_neurons_xyz=n_hidden_neurons_xyz, n_hidden_neurons_dir=n_hidden_neurons_dir,
            n_layers_xyz=n_layers_xyz, append_xyz=append_xyz, use_fused_kernel=use_fused_kernel,
            device=device, generator=generator,
        )
        self._renderer_coarse_field = NeuralRadianceField(**field)
        self._renderer_fine_field = NeuralRadianceField(**field)
        self._raymarcher = EmissionAbsorptionNeRFRaymarcher()
        self._raysampler = NeRFRaysampler(
            n_pts_per_ray=n_pts_per_ray, min_depth=min_depth, max_depth=max_depth,
            n_rays_per_image=n_rays_per_image, image_width=image_width, image_height=image_height,
            stratified=stratified, stratified_test=stratified_test,
        )
        self._raysampler_fine = ProbabilisticRaysampler(
            n_pts_per_ray=n_pts_per_ray_fine, stratified=stratified, stratified_test=stratified_test,
        )

    @property
    def use_fused_kernel(self) -> bool:
        return self._renderer_coarse_field.use_fused_kernel

    @use_fused_kernel.setter
    def use_fused_kernel(self, value: bool) -> None:
        self._renderer_coarse_field.use_fused_kernel = value
        self._renderer_fine_field.use_fused_kernel = value

    def draws_shapes(self, batch: int, training: bool, n_rays: Optional[int] = None) -> Dict[str, tuple]:
        """{name: shape} of the draws one call takes: "xy" and "jiggle"
        (uniform, the rays), "pdf" (uniform, the fine sampler's quantiles),
        "noise_coarse" and "noise_fine" (standard normal).  `n_rays` is the
        rays per camera at evaluation (the chunk's size)."""
        shapes = self._raysampler.draws_shapes(batch, training)
        R = shapes["xy"][1] if training else n_rays
        S, Sf = self.n_pts_per_ray, self.n_pts_per_ray_fine
        if self._raysampler_fine.stratified(training):
            shapes["pdf"] = (batch, R, Sf)
        if self.density_noise_std > 0:
            shapes["noise_coarse"] = (batch, R, S, 1)
            shapes["noise_fine"] = (batch, R, S + Sf, 1)
        return shapes

    def make_draws(self, batch: int, training: bool, generator: Optional[torch.Generator] = None,
                   n_rays: Optional[int] = None) -> Dict[str, torch.Tensor]:
        device = self.bg_color.device
        draws = {}
        for name, shape in self.draws_shapes(batch, training, n_rays).items():
            sample = torch.randn if name.startswith("noise") else torch.rand
            draws[name] = sample(shape, generator=generator, device=device)
        return draws

    def forward(
        self,
        cameras,
        image: Optional[torch.Tensor] = None,  # (B, H, W, 3)
        training: bool = True,
        generator: Optional[torch.Generator] = None,
        chunksize: Optional[int] = None,
        chunk_idx: int = 0,
        draws: Optional[Dict[str, torch.Tensor]] = None,
        ray_sharding=None,
    ):
        """Render rays (MC at training, a grid chunk at evaluation).

        Returns (out, metrics): out holds rgb_coarse, rgb_fine (and rgb_gt
        with `image`), metrics mse and psnr of both passes (with `image`);
        with `ray_sharding`, of this rank's share of the rays.
        """
        if draws is None:
            n_rays = None
            if not training:
                H, W = self._raysampler._grid_raysampler.grid_shape
                n_rays = H * W if chunksize is None else min(chunksize, H * W)
            draws = self.make_draws(len(cameras), training, generator, n_rays)
        ray_bundle = self._raysampler(
            cameras, chunksize=chunksize, chunk_idx=chunk_idx, training=training,
            u_xy=draws.get("xy"), u_jiggle=draws.get("jiggle"),
        )
        if ray_sharding is not None:
            local = ray_sharding.local
            ray_bundle = ray_bundle.replace(origins=local(ray_bundle.origins), directions=local(ray_bundle.directions),
                                            lengths=local(ray_bundle.lengths), xys=local(ray_bundle.xys))
            draws = {k: local(v) if k in ("pdf", "noise_coarse", "noise_fine") else v for k, v in draws.items()}
            if image is not None:  # the batch split as the rays' first dimension
                image = dataclasses.replace(ray_sharding, spec=ray_sharding.spec[:1]).local(image)
        bg = self.bg_color
        densities, colors = _field_call(
            self._renderer_coarse_field, ray_bundle, self.density_noise_std, draws.get("noise_coarse"), self.remat
        )
        rgb_coarse, weights = self._raymarcher(densities, colors)
        rgb_coarse = rgb_coarse + (1.0 - weights.sum(dim=-1, keepdim=True)) * bg

        bundle_fine = self._raysampler_fine(ray_bundle, weights.detach(), training=training, u=draws.get("pdf"))
        densities_f, colors_f = _field_call(
            self._renderer_fine_field, bundle_fine, self.density_noise_std, draws.get("noise_fine"), self.remat
        )
        rgb_fine, weights_f = self._raymarcher(densities_f, colors_f)
        rgb_fine = rgb_fine + (1.0 - weights_f.sum(dim=-1, keepdim=True)) * bg

        out = {"rgb_coarse": rgb_coarse, "rgb_fine": rgb_fine}
        metrics = {}
        if image is not None:
            rgb_gt = sample_images_at_mc_locs(image, ray_bundle.xys)
            out["rgb_gt"] = rgb_gt
            metrics = {
                "mse_coarse": calc_mse(rgb_coarse, rgb_gt),
                "mse_fine": calc_mse(rgb_fine, rgb_gt),
                "psnr_coarse": calc_psnr(rgb_coarse, rgb_gt),
                "psnr_fine": calc_psnr(rgb_fine, rgb_gt),
            }
        return out, metrics
