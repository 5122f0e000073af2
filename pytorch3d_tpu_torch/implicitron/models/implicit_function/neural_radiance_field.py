"""The NeRF and NeRFormer implicit functions of Implicitron (port of
pytorch3d_tpu/implicitron/models/implicit_function/neural_radiance_field.py).

The trunk's input is each point's harmonic embedding, then a global code
(B, C) broadcast over the rays and points, then the source-view features
`fun_viewpool` pools at the point: `latent_dim` is the width of the last
two together (GenericModel sets it).  Then, as in the JAX module:
- `color_dim == 3`: trunk, density and view-conditioned colour head in one
  fused field (`MLPWithInputSkips(head=...)`: kernel #12 forward, #13
  backward on the card, their plain versions on the CPU), at any input
  width the kernels take (455 for repro_multiseq_nerf_wce);
- another `color_dim`: the trunk alone through the fused trunk (#10 / #11),
  then the density and colour layers in torch;
- `use_transformer_trunk` (NeRFormer): `TransformerWithInputSkips` on
  per-view features (`fun_viewpool.per_view`: the view axis kept, the
  embedding broadcast over it), then the density and colour layers; plain
  PyTorch, as it is XLA code in JAX.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
from torch import nn

from ....common import DEFAULT_DEVICE
from ....models.nerf.implicit_function import MLPWithInputSkips
from ....renderer.implicit.harmonic_embedding import HarmonicEmbedding
from ....renderer.implicit.utils import ray_bundle_to_ray_points
from ...tools.config import expand_args_fields, registry
from .base import ImplicitFunctionBase
from .decoding_functions import TransformerWithInputSkips, dense_layer, linear

Device = Union[str, torch.device]


class NeuralRadianceFieldBase(ImplicitFunctionBase, nn.Module):
    n_harmonic_functions_xyz: int = 10
    n_harmonic_functions_dir: int = 4
    n_hidden_neurons_xyz: int = 256
    n_hidden_neurons_dir: int = 128
    latent_dim: int = 0
    input_xyz: bool = True
    xyz_ray_dir_in_camera_coords: bool = False
    color_dim: int = 3
    n_layers_xyz: int = 8
    append_xyz: Tuple[int, ...] = (5,)
    use_transformer_trunk: bool = False
    transformer_dim_down_factor: float = 1.0
    device: Device = DEFAULT_DEVICE
    generator: Optional[torch.Generator] = None

    def __post_init__(self):
        self.harmonic_embedding_xyz = HarmonicEmbedding(self.n_harmonic_functions_xyz)
        self.harmonic_embedding_dir = HarmonicEmbedding(self.n_harmonic_functions_dir)
        H = self.n_hidden_neurons_xyz
        d_in = self.harmonic_embedding_xyz.get_output_dim(3) + self.latent_dim
        d_dir = self.harmonic_embedding_dir.get_output_dim(3)
        device, g = self.device, self.generator
        if self.use_transformer_trunk:
            self.xyz_encoder = TransformerWithInputSkips(
                self.n_layers_xyz, d_in, H, d_in, H, self.append_xyz,
                dim_down_factor=self.transformer_dim_down_factor, device=device, generator=g,
            )
        else:
            self.xyz_encoder = MLPWithInputSkips(
                self.n_layers_xyz, H, d_in, H, self.append_xyz, device=device, generator=g,
            )
        self.intermediate_linear = dense_layer(H, H, device=device, generator=g)
        self.density_layer = dense_layer(H, 1, device=device, generator=g)
        self.color_layer_hidden = dense_layer(H + d_dir, self.n_hidden_neurons_dir, device=device, generator=g)
        self.color_layer_out = dense_layer(self.n_hidden_neurons_dir, self.color_dim, device=device, generator=g)
        self.generator = None  # used once; a module keeps no generator

    def _head_params(self):
        wi, bi = self.intermediate_linear()
        wd, bd = self.density_layer()
        wc1, bc1 = self.color_layer_hidden()
        wc2, bc2 = self.color_layer_out()
        H = self.n_hidden_neurons_xyz
        return (wd, bd, wi, bi, wc1[:H], wc1[H:], bc1, wc2, bc2)

    def _dir_embed(self, spatial, directions):
        d = directions / torch.linalg.norm(directions, dim=-1, keepdim=True).clamp(min=1e-12)
        d_embed = self.harmonic_embedding_dir(d)
        return d_embed[..., None, :].expand(*spatial, d_embed.shape[-1])

    def _get_colors(self, features, directions):
        d_embed = self._dir_embed(features.shape[:-1], directions)
        inp = torch.cat([linear(self.intermediate_linear, features), d_embed], dim=-1)
        return torch.sigmoid(linear(self.color_layer_out, torch.relu(linear(self.color_layer_hidden, inp))))

    @staticmethod
    def requires_pooling_without_aggregation() -> bool:
        return False

    def forward(
        self,
        ray_bundle,
        fun_viewpool=None,
        camera=None,
        global_code: Optional[torch.Tensor] = None,  # (B, latent_dim)
        density_noise_std: float = 0.0,
        **kwargs,
    ):
        """Densities (..., S, 1) in [0, 1) and colours (..., S, color_dim)
        at the bundle's points.  fun_viewpool(points (..., 3)): the pooled
        source-view features (..., C), or with `per_view` set (V, ..., C)."""
        pts = ray_bundle_to_ray_points(ray_bundle)
        embeds = self.harmonic_embedding_xyz(pts)
        if global_code is not None:  # (B, D) broadcast over the ray and point dims
            g = global_code.reshape(global_code.shape[:1] + (1,) * (embeds.ndim - 2) + global_code.shape[-1:])
            embeds = torch.cat([embeds, g.expand(*embeds.shape[:-1], global_code.shape[-1])], dim=-1)
        per_view = fun_viewpool is not None and getattr(fun_viewpool, "per_view", False)
        if fun_viewpool is not None and not per_view:
            embeds = torch.cat([embeds, fun_viewpool(pts)], dim=-1)
        elif per_view:  # the view axis kept for the transformer to attend over
            if not self.use_transformer_trunk:
                raise ValueError("per-view pooling requires the transformer trunk")
            pooled = fun_viewpool(pts)  # (V, ..., C)
            embeds = torch.cat([embeds[None].expand(pooled.shape[0], *embeds.shape), pooled], dim=-1)
        if self.use_transformer_trunk:
            features = self.xyz_encoder(embeds, embeds, pool_axis=per_view)
        elif self.color_dim == 3:
            d_embed = self._dir_embed(embeds.shape[:-1], ray_bundle.directions)
            out4 = self.xyz_encoder(embeds, embeds, head=(d_embed, self._head_params()))
            densities = 1.0 - torch.exp(-nn.functional.softplus(out4[..., 0:1]))
            return densities, torch.sigmoid(out4[..., 1:4])
        else:
            features = self.xyz_encoder(embeds, embeds)
        raw_density = linear(self.density_layer, features)
        densities = 1.0 - torch.exp(-nn.functional.softplus(raw_density))
        return densities, self._get_colors(features, ray_bundle.directions)


expand_args_fields(NeuralRadianceFieldBase)


@registry.register
class NeuralRadianceFieldImplicitFunction(NeuralRadianceFieldBase):
    pass


expand_args_fields(NeuralRadianceFieldImplicitFunction)


@registry.register
class NeRFormerImplicitFunction(NeuralRadianceFieldBase):
    """NeRFormer: the transformer trunk, attending over the source views and
    over each ray's points; GenericModel hands it per-view features."""

    use_transformer_trunk: bool = True
    transformer_dim_down_factor: float = 2.0
    n_hidden_neurons_xyz: int = 80
    n_layers_xyz: int = 2
    append_xyz: Tuple[int, ...] = (1,)

    @staticmethod
    def requires_pooling_without_aggregation() -> bool:
        return True


expand_args_fields(NeRFormerImplicitFunction)
