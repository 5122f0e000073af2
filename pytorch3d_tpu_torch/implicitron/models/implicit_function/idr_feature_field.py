"""IDR's neural surface: a signed distance and a feature vector at each
point (port of
pytorch3d_tpu/implicitron/models/implicit_function/idr_feature_field.py).

The layers keep flax's layout and names (`linear{l}`: `kernel` (in, out),
`bias`, and with weight norm `scale`), so a flax checkpoint converts by
renaming.  Weight norm is written out as the JAX module computes it,
W = scale * v / sqrt(sum_in v^2 + 1e-12) for each output column of the
(in, out) kernel, with `scale` starting at the initial column norms;
`torch.nn.utils.weight_norm` has no epsilon and another layout.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ....common import DEFAULT_DEVICE
from ....renderer.implicit.harmonic_embedding import HarmonicEmbedding
from ...tools.config import expand_args_fields, registry
from .base import ImplicitFunctionBase
from .decoding_functions import _lecun_

Device = Union[str, torch.device]


class _Dense(nn.Module):
    """x @ kernel + bias, flax's (in, out) kernel, initialised in place by the
    caller."""

    def __init__(self, in_features: int, features: int, device: Device = DEFAULT_DEVICE) -> None:
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros((in_features, features), device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def weight(self) -> torch.Tensor:
        return self.kernel

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.weight() + self.bias


class _WeightNormDense(_Dense):
    """A dense layer with weight normalisation: the kernel v, one `scale` an
    output unit (made equal to v's column norms by `init_scale`)."""

    def __init__(self, in_features: int, features: int, device: Device = DEFAULT_DEVICE) -> None:
        super().__init__(in_features, features, device)
        self.scale = nn.Parameter(torch.ones(features, device=device))

    def _norm(self) -> torch.Tensor:
        return torch.sqrt((self.kernel * self.kernel).sum(dim=0) + 1e-12)

    def init_scale(self) -> None:
        with torch.no_grad():
            self.scale.copy_(self._norm())

    def weight(self) -> torch.Tensor:
        return self.kernel * (self.scale / self._norm())


def dense(in_features: int, features: int, weight_norm: bool, kernel_init, bias_init,
          device: Device = DEFAULT_DEVICE) -> _Dense:
    """A (weight-normalised) dense layer: `kernel_init(kernel)` and
    `bias_init(bias)` fill the tensors in place (under no_grad)."""
    layer = (_WeightNormDense if weight_norm else _Dense)(in_features, features, device)
    with torch.no_grad():
        kernel_init(layer.kernel)
        bias_init(layer.bias)
    if weight_norm:
        layer.init_scale()
    return layer


def _zeros(t: torch.Tensor) -> None:
    t.zero_()


@registry.register
class IdrFeatureField(ImplicitFunctionBase, nn.Module):
    """points (..., 3) -> (..., d_out + feature_vector_size): the signed
    distance first, then the features.  Softplus layers (beta 100) with
    the embedding concatenated again (over sqrt 2) before the layers in
    `skip_in`; with `geometric_init` the net starts near the sphere SDF
    |x| - bias."""

    feature_vector_size: int = 3
    d_in: int = 3
    d_out: int = 1
    dims: Tuple[int, ...] = (512, 512, 512, 512, 512, 512, 512, 512)
    geometric_init: bool = True
    bias: float = 1.0
    skip_in: Tuple[int, ...] = ()
    weight_norm: bool = True
    n_harmonic_functions_xyz: int = 0
    pooled_feature_dim: int = 0
    device: Device = DEFAULT_DEVICE
    generator: Optional[torch.Generator] = None

    def __post_init__(self):
        self.embed = HarmonicEmbedding(self.n_harmonic_functions_xyz, append_input=True)
        in_dim = self.embed.get_output_dim(self.d_in)
        layer_dims = [in_dim] + list(self.dims) + [self.d_out + self.feature_vector_size]
        n_lin = len(layer_dims) - 1
        for li in range(n_lin):
            out_d = layer_dims[li + 1] - (in_dim if li + 1 in self.skip_in else 0)
            if self.geometric_init:
                kinit, binit = self._geometric_init_for(li, n_lin, layer_dims[li], out_d, in_dim)
            else:
                kinit, binit = (lambda t, fan=layer_dims[li]: _lecun_(t, fan, self.generator)), _zeros
            self.add_module(f"linear{li}", dense(layer_dims[li], out_d, self.weight_norm, kinit, binit, self.device))
        self.n_layers = n_lin
        self.generator = None  # used once; a module keeps no generator

    def _normal(self, t: torch.Tensor, std: float, mean: float = 0.0) -> torch.Tensor:
        return torch.randn(t.shape, generator=self.generator, device=t.device) * std + mean

    def _geometric_init_for(self, li, n_lin, in_d, out_d, embed_dim):
        """The sphere-SDF initialisation of IDR, in flax's (in, out) layout:
        the last layer's kernel sqrt(pi / in) plus a 1e-4 spread and bias
        -bias; the first layer reads only the raw xyz, the embedding's LAST
        three channels ([sin..., cos..., xyz]); a skip layer zeroes the
        rows of the appended harmonics and keeps those of its raw xyz."""
        std_mid = math.sqrt(2.0) / math.sqrt(out_d)
        if li == n_lin - 1:
            mean = math.sqrt(math.pi) / math.sqrt(in_d)
            return (lambda t: t.copy_(self._normal(t, 1e-4, mean))), (lambda t: t.fill_(-self.bias))
        if li == 0:
            def first(t):
                t.zero_()
                t[-3:] = self._normal(t[-3:], std_mid)
            return first, _zeros
        if li in self.skip_in:
            def skip(t):
                t.copy_(self._normal(t, std_mid))
                t[-embed_dim:-3] = 0.0
            return skip, _zeros
        return (lambda t: t.copy_(self._normal(t, std_mid))), _zeros

    def forward(self, points: torch.Tensor, **kwargs) -> torch.Tensor:
        x0 = self.embed(points)
        x = x0
        for li in range(self.n_layers):
            if li in self.skip_in:
                x = torch.cat([x, x0], dim=-1) / math.sqrt(2.0)
            x = getattr(self, f"linear{li}")(x)
            if li < self.n_layers - 1:
                x = F.softplus(x * 100.0) / 100.0
        return x

    def get_sdf(self, points: torch.Tensor) -> torch.Tensor:
        return self(points)[..., 0]

    @staticmethod
    def requires_pooling_without_aggregation() -> bool:
        return False


expand_args_fields(IdrFeatureField)
