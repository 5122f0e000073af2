"""The NeRF field as torch modules (port of
pytorch3d_tpu/models/nerf/implicit_function.py).

Parameters keep the flax layout and names: each dense layer is a
`_DenseParams` holding `kernel` (in, out) and `bias` (out,), so a flax
checkpoint converts by renaming (`convert.nerf_state_dict_from_flax`) and the
fused kernels take the kernels as they are.

`MLPWithInputSkips` keeps the JAX module's three branches: with a head, the
fused NeRF field (kernels #12/#13 on the card); without one, when the skip
input is the trunk input, the fused trunk (#10/#11); otherwise the plain
layer-by-layer chain.  The JAX package's TPU gates (backend, lane widths,
problem size) are not carried over: on a CUDA tensor the kernels run at
every width they take, on a CPU tensor their plain versions run, and
`use_fused_kernel=False` forces the plain chain on any device.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
from torch import nn

from ...common import DEFAULT_DEVICE
from ...ops.fused_mlp_cuda import fused_mlp, fused_nerf_field, fused_nerf_field_plain
from ...renderer.implicit.harmonic_embedding import HarmonicEmbedding
from ...renderer.implicit.utils import RayBundle, ray_bundle_to_ray_points

Device = Union[str, torch.device]


class _DenseParams(nn.Module):
    """One dense layer's kernel (in, out), xavier-uniform, and bias (out,),
    zero, as flax initialises them."""

    def __init__(self, in_features: int, features: int, device: Device = DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        kernel = torch.empty((in_features, features), device=device)
        nn.init.xavier_uniform_(kernel, generator=generator)
        self.kernel = nn.Parameter(kernel)
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.kernel, self.bias


class MLPWithInputSkips(nn.Module):
    """ReLU MLP that concatenates the skip input z after the hidden features
    at the layers in `input_skips`."""

    def __init__(
        self,
        n_layers: int,
        output_dim: int,
        skip_dim: int,
        hidden_dim: int,
        input_skips: Sequence[int] = (),
        use_fused_kernel: bool = True,
        device: Device = DEFAULT_DEVICE,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.n_layers = n_layers
        self.output_dim = output_dim
        self.hidden_dim = hidden_dim
        self.input_skips = tuple(input_skips)
        self.use_fused_kernel = use_fused_kernel
        for li in range(n_layers):  # the input x has the skip input's width, as in the NeRF field
            in_dim = (hidden_dim if li > 0 else skip_dim) + (skip_dim if li in self.input_skips else 0)
            self.add_module(f"layer{li}", _DenseParams(in_dim, hidden_dim, device, generator))

    def weights(self):
        layers = [getattr(self, f"layer{li}") for li in range(self.n_layers)]
        return [m.kernel for m in layers], [m.bias for m in layers]

    def forward(self, x: torch.Tensor, z: torch.Tensor, head: Optional[tuple] = None) -> torch.Tensor:
        """(..., D) -> (..., hidden_dim); with head = (d_embed (..., Ddir),
        the 9 head tensors), the NeRF head runs in the same kernel and the
        result is (..., 4) [raw density, rgb logits]."""
        kernels, biases = self.weights()
        lead = x.shape[:-1]
        if head is not None:
            d_embed, head_params = head
            flat = x.reshape(-1, x.shape[-1])
            flat_de = d_embed.reshape(-1, d_embed.shape[-1])
            field = fused_nerf_field if self.use_fused_kernel else fused_nerf_field_plain
            out = field(flat, flat_de, kernels, biases, head_params, self.input_skips)
            return out.reshape(*lead, 4)
        if self.use_fused_kernel and x is z:
            out = fused_mlp(x.reshape(-1, x.shape[-1]), kernels, biases, self.input_skips)
            return out.reshape(*lead, self.hidden_dim)
        y = x
        for li in range(self.n_layers):
            if li in self.input_skips:
                y = torch.cat([y, z], dim=-1)
            y = torch.relu(y @ kernels[li] + biases[li])
        return y


class NeuralRadianceField(nn.Module):
    """NeRF MLP: density from the embedded point, colour from the point's
    features and the embedded view direction."""

    def __init__(
        self,
        n_harmonic_functions_xyz: int = 6,
        n_harmonic_functions_dir: int = 4,
        n_hidden_neurons_xyz: int = 256,
        n_hidden_neurons_dir: int = 128,
        n_layers_xyz: int = 8,
        append_xyz: Sequence[int] = (5,),
        use_fused_kernel: bool = True,
        device: Device = DEFAULT_DEVICE,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.harmonic_embedding_xyz = HarmonicEmbedding(n_harmonic_functions_xyz)
        self.harmonic_embedding_dir = HarmonicEmbedding(n_harmonic_functions_dir)
        dim_xyz = self.harmonic_embedding_xyz.get_output_dim(3)
        dim_dir = self.harmonic_embedding_dir.get_output_dim(3)
        H = n_hidden_neurons_xyz
        self.n_hidden_neurons_xyz = H
        self.mlp_xyz = MLPWithInputSkips(
            n_layers_xyz, H, dim_xyz, H, append_xyz, use_fused_kernel=use_fused_kernel,
            device=device, generator=generator,
        )
        self.intermediate_linear = _DenseParams(H, H, device, generator)
        self.density_layer = _DenseParams(H, 1, device, generator)
        self.color_layer_hidden = _DenseParams(H + dim_dir, n_hidden_neurons_dir, device, generator)
        self.color_layer_out = _DenseParams(n_hidden_neurons_dir, 3, device, generator)

    @property
    def use_fused_kernel(self) -> bool:
        return self.mlp_xyz.use_fused_kernel

    @use_fused_kernel.setter
    def use_fused_kernel(self, value: bool) -> None:
        self.mlp_xyz.use_fused_kernel = value

    def head_params(self) -> tuple:
        """The 9 head tensors in the fused field's order; the colour layer's
        kernel splits at H into the rows for the point features (wc1a) and
        those for the direction embedding (wc1b)."""
        wi, bi = self.intermediate_linear()
        wd, bd = self.density_layer()
        wc1, bc1 = self.color_layer_hidden()
        wc2, bc2 = self.color_layer_out()
        H = self.n_hidden_neurons_xyz
        return (wd, bd, wi, bi, wc1[:H], wc1[H:], bc1, wc2, bc2)

    @staticmethod
    def densities_from_raw(
        raw: torch.Tensor,  # (..., S, 1)
        depth_values: torch.Tensor,  # (..., S)
        density_noise_std: float = 0.0,
        noise: Optional[torch.Tensor] = None,  # (..., S, 1) standard normal
    ) -> torch.Tensor:
        """1 - exp(-delta * relu(raw + std * noise)), delta the step to the
        next depth (1e10 after the last)."""
        deltas = torch.cat(
            [depth_values[..., 1:] - depth_values[..., :-1], torch.full_like(depth_values[..., :1], 1e10)], dim=-1
        )[..., None]
        if noise is not None:
            raw = raw + density_noise_std * noise
        return 1.0 - torch.exp(-deltas * torch.relu(raw))

    def forward(
        self,
        ray_bundle: RayBundle,
        density_noise_std: float = 0.0,
        noise: Optional[torch.Tensor] = None,
        **kwargs,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Densities (..., S, 1) and colours (..., S, 3) at the bundle's
        points; `noise` (..., S, 1), standard normal, is added to the raw
        density times `density_noise_std` where given."""
        points = ray_bundle_to_ray_points(ray_bundle)
        embeds_xyz = self.harmonic_embedding_xyz(points)
        d = ray_bundle.directions / torch.linalg.norm(ray_bundle.directions, dim=-1, keepdim=True).clamp(min=1e-12)
        d_embed = self.harmonic_embedding_dir(d)
        d_embed = d_embed[..., None, :].expand(*embeds_xyz.shape[:-1], d_embed.shape[-1])
        out4 = self.mlp_xyz(embeds_xyz, embeds_xyz, head=(d_embed, self.head_params()))
        densities = self.densities_from_raw(out4[..., 0:1], ray_bundle.lengths, density_noise_std, noise)
        return densities, torch.sigmoid(out4[..., 1:4])
