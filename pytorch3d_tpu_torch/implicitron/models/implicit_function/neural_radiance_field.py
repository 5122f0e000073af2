"""The NeRF implicit function of Implicitron (port of
pytorch3d_tpu/implicitron/models/implicit_function/neural_radiance_field.py).

Three branches, as in the JAX module:
- `color_dim == 3`: trunk, density and view-conditioned colour head in one
  fused field (`MLPWithInputSkips(head=...)`: kernel #12 forward, #13
  backward on the card, their plain versions on the CPU);
- another `color_dim`: the trunk alone through the fused trunk (#10 / #11),
  then the density and colour layers in torch;
- a global code (B, C) concatenated to every point's harmonic embedding
  before the trunk (`latent_dim` = C widens the trunk's input).

The transformer trunk (`NeRFormerImplicitFunction`) and pooled source-view
features wait for the slice that ports the view pooler and
`decoding_functions`.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
from torch import nn

from ....common import DEFAULT_DEVICE
from ....models.nerf.implicit_function import MLPWithInputSkips, _DenseParams
from ....renderer.implicit.harmonic_embedding import HarmonicEmbedding
from ....renderer.implicit.utils import ray_bundle_to_ray_points
from ...tools.config import expand_args_fields, registry
from .base import ImplicitFunctionBase

Device = Union[str, torch.device]

_VIEW_POOLER_SLICE = "the view pooler's slice (feature extractor, view pooler, decoding_functions / NeRFormer)"


def _lecun_dense(in_features: int, features: int, device, generator) -> _DenseParams:
    """A dense layer with flax's lecun_normal kernel: a normal of variance
    1 / fan_in truncated at two deviations (the truncation's shrink undone)."""
    dense = _DenseParams(in_features, features, device, generator)
    std = (1.0 / in_features) ** 0.5 / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(dense.kernel, std=std, a=-2 * std, b=2 * std, generator=generator)
    return dense


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
        if self.use_transformer_trunk:
            raise NotImplementedError(f"the transformer trunk (NeRFormer) waits for {_VIEW_POOLER_SLICE}")
        self.harmonic_embedding_xyz = HarmonicEmbedding(self.n_harmonic_functions_xyz)
        self.harmonic_embedding_dir = HarmonicEmbedding(self.n_harmonic_functions_dir)
        H = self.n_hidden_neurons_xyz
        d_in = self.harmonic_embedding_xyz.get_output_dim(3) + self.latent_dim
        d_dir = self.harmonic_embedding_dir.get_output_dim(3)
        device, g = self.device, self.generator
        self.xyz_encoder = MLPWithInputSkips(
            self.n_layers_xyz, H, d_in, H, self.append_xyz, device=device, generator=g,
        )
        self.intermediate_linear = _lecun_dense(H, H, device, g)
        self.density_layer = _lecun_dense(H, 1, device, g)
        self.color_layer_hidden = _lecun_dense(H + d_dir, self.n_hidden_neurons_dir, device, g)
        self.color_layer_out = _lecun_dense(self.n_hidden_neurons_dir, self.color_dim, device, g)
        self.generator = None  # used once; a module keeps no generator

    @staticmethod
    def _dense(dp, x):
        k, b = dp()
        return x @ k + b

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
        inp = torch.cat([self._dense(self.intermediate_linear, features), d_embed], dim=-1)
        return torch.sigmoid(self._dense(self.color_layer_out, torch.relu(self._dense(self.color_layer_hidden, inp))))

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
        at the bundle's points."""
        if fun_viewpool is not None:
            raise NotImplementedError(f"pooled source-view features wait for {_VIEW_POOLER_SLICE}")
        pts = ray_bundle_to_ray_points(ray_bundle)
        embeds = self.harmonic_embedding_xyz(pts)
        if global_code is not None:  # (B, D) broadcast over the ray and point dims
            g = global_code.reshape(global_code.shape[:1] + (1,) * (embeds.ndim - 2) + global_code.shape[-1:])
            embeds = torch.cat([embeds, g.expand(*embeds.shape[:-1], global_code.shape[-1])], dim=-1)
        if self.color_dim == 3:
            d_embed = self._dir_embed(embeds.shape[:-1], ray_bundle.directions)
            out4 = self.xyz_encoder(embeds, embeds, head=(d_embed, self._head_params()))
            densities = 1.0 - torch.exp(-nn.functional.softplus(out4[..., 0:1]))
            return densities, torch.sigmoid(out4[..., 1:4])
        features = self.xyz_encoder(embeds, embeds)
        raw_density = self._dense(self.density_layer, features)
        densities = 1.0 - torch.exp(-nn.functional.softplus(raw_density))
        return densities, self._get_colors(features, ray_bundle.directions)


expand_args_fields(NeuralRadianceFieldBase)


@registry.register
class NeuralRadianceFieldImplicitFunction(NeuralRadianceFieldBase):
    pass


expand_args_fields(NeuralRadianceFieldImplicitFunction)
