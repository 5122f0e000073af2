"""Decoding functions of Implicitron's implicit functions (port of
pytorch3d_tpu/implicitron/models/implicit_function/decoding_functions.py):
`ElementwiseDecoder`, Implicitron's own `MLPWithInputSkips` and
`MLPDecoder`, and NeRFormer's transformer trunk
(`TransformerEncoderLayer`, `TransformerWithInputSkips`).

Parameters keep the flax layout and names, so a flax checkpoint converts by
renaming (`convert.generic_model_state_dict_from_flax`): a dense layer is a
kernel (in, out) and a bias; the attention's query / key / value kernels
are (d, heads, d / heads) with (heads, d / heads) biases and its output
kernel (heads, d / heads, d); a layer norm has `scale` and `bias`.  The
attention is written out as products and a softmax, as flax's
`MultiHeadDotProductAttention` computes it (the query scaled by
1 / sqrt(d / heads)), and the layer norm as flax's (eps 1e-6, the
variance as E[x^2] - E[x]^2 clamped at 0).  None of this runs a kernel of
the port: NeRFormer's trunk is plain PyTorch, as it is XLA code in JAX.
"""

from __future__ import annotations

from enum import Enum
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ....common import DEFAULT_DEVICE
from ....models.nerf.implicit_function import _DenseParams
from ...tools.config import ReplaceableBase, expand_args_fields, registry

Device = Union[str, torch.device]


class DecoderActivation(Enum):
    """Activation choices; the modules also take the raw strings."""

    RELU = "relu"
    SOFTPLUS = "softplus"
    SIGMOID = "sigmoid"
    IDENTITY = "identity"


class DecoderFunctionBase(ReplaceableBase):
    """Maps the embedding of a spatial location to the quantity wanted
    (density, colour)."""


_ACTIVATIONS = {
    "relu": torch.relu,
    "softplus": F.softplus,
    "sigmoid": torch.sigmoid,
    "identity": lambda t: t,
}


def _lecun_(w: torch.Tensor, fan_in: int, generator) -> torch.Tensor:
    """flax's lecun_normal in place: a normal of variance 1 / fan_in
    truncated at two deviations (the truncation's shrink undone)."""
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)


def dense_layer(in_features: int, features: int, xavier: bool = False, bias_init: float = 0.0,
                device: Device = DEFAULT_DEVICE, generator: Optional[torch.Generator] = None) -> _DenseParams:
    """A dense layer as flax keeps it (`_DenseParams`: kernel (in, out),
    bias (out,)): the kernel xavier-uniform, or lecun-normal drawn after
    that, flax's `nn.Dense` default; the bias `bias_init`."""
    layer = _DenseParams(in_features, features, device, generator)
    if not xavier:
        _lecun_(layer.kernel, in_features, generator)
    if bias_init:
        with torch.no_grad():
            layer.bias.fill_(float(bias_init))
    return layer


def linear(layer: _DenseParams, x: torch.Tensor) -> torch.Tensor:
    """x @ kernel + bias of a flax-layout dense layer."""
    kernel, bias = layer()
    return x @ kernel + bias


@registry.register
class ElementwiseDecoder(DecoderFunctionBase, nn.Module):
    """operation(features * scale + shift), the operation one of relu,
    softplus, sigmoid or identity."""

    scale: float = 1.0
    shift: float = 0.0
    operation: str = "identity"

    def forward(self, features: torch.Tensor, z: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.operation not in _ACTIVATIONS:
            raise ValueError("`operation` can only be `relu`, `softplus`, `sigmoid` or `identity`.")
        return _ACTIVATIONS[self.operation](features * self.scale + self.shift)


expand_args_fields(ElementwiseDecoder)


class MLPWithInputSkips(nn.Module):
    """Implicitron's MLP with skip inputs: dense layers with ReLU, the skip
    input z concatenated before the layers in `input_skips` or, with
    `skip_affine_trans`, applied as an affine map (y - mu) * softplus(log
    std) predicted from z by `skip_affine{l}a` / `skip_affine{l}b`.
    `last_layer_bias_init` sets the last bias, `last_activation` the last
    nonlinearity, `use_xavier_init` xavier-uniform kernels (else flax's
    lecun normal).  This is not the NeRF trunk of `models/nerf`."""

    def __init__(
        self,
        n_layers: int = 8,
        input_dim: int = 39,
        output_dim: int = 256,
        skip_dim: int = 39,
        hidden_dim: int = 256,
        input_skips: Sequence[int] = (5,),
        skip_affine_trans: bool = False,
        last_layer_bias_init: Optional[float] = None,
        last_activation: str = "relu",
        use_xavier_init: bool = True,
        device: Device = DEFAULT_DEVICE,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        if last_activation not in _ACTIVATIONS:
            raise ValueError("`last_activation` can only be `relu`, `softplus`, `sigmoid` or `identity`.")
        self.n_layers = n_layers
        self.input_skips = tuple(input_skips)
        self.skip_affine_trans = skip_affine_trans
        self.last_activation = last_activation
        kw = dict(xavier=use_xavier_init, device=device, generator=generator)
        for li in range(n_layers):
            last = li + 1 >= n_layers
            in_dim = input_dim if li == 0 else hidden_dim
            if li in self.input_skips:
                if skip_affine_trans:
                    self.add_module(f"skip_affine{li}a", dense_layer(skip_dim, 2 * hidden_dim, **kw))
                    self.add_module(f"skip_affine{li}b", dense_layer(2 * hidden_dim, 2 * hidden_dim, **kw))
                else:
                    in_dim += skip_dim
            bias = last_layer_bias_init if last and last_layer_bias_init is not None else 0.0
            self.add_module(f"layer{li}", dense_layer(in_dim, output_dim if last else hidden_dim, bias_init=bias, **kw))

    def forward(self, x: torch.Tensor, z: Optional[torch.Tensor] = None) -> torch.Tensor:
        if z is None:
            z = x
        y = x
        for li in range(self.n_layers):
            if li in self.input_skips:
                if self.skip_affine_trans:
                    hidden = torch.relu(linear(getattr(self, f"skip_affine{li}a"), z))
                    mu, log_std = linear(getattr(self, f"skip_affine{li}b"), hidden).chunk(2, dim=-1)
                    y = (y - mu) * F.softplus(log_std)
                else:
                    y = torch.cat([y, z], dim=-1)
            y = linear(getattr(self, f"layer{li}"), y)
            y = _ACTIVATIONS[self.last_activation if li + 1 >= self.n_layers else "relu"](y)
        return y


@registry.register
class MLPDecoder(DecoderFunctionBase, nn.Module):
    """An `MLPWithInputSkips` (submodule `network`) configured by
    `network_args`, its input `input_dim` wide unless they say otherwise."""

    input_dim: int = 3
    network_args: Optional[Dict[str, Any]] = None
    param_groups: Optional[Dict[str, str]] = None
    device: Device = DEFAULT_DEVICE
    generator: Optional[torch.Generator] = None

    def __post_init__(self):
        args = dict(self.network_args or {})
        args.setdefault("input_dim", self.input_dim)
        args.setdefault("skip_dim", args["input_dim"])  # the skips take the decoder's input again
        self.network = MLPWithInputSkips(**args, device=self.device, generator=self.generator)
        self.generator = None  # used once; a module keeps no generator

    def forward(self, features: torch.Tensor, z: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.network(features, z)


expand_args_fields(MLPDecoder)


class _DenseGeneral(nn.Module):
    """flax's DenseGeneral as the attention uses it: kernel `kernel_shape`
    contracting the input's last `n_in` axes, bias `bias_shape`."""

    def __init__(self, kernel_shape: Tuple[int, ...], bias_shape: Tuple[int, ...], n_in: int,
                 device: Device = DEFAULT_DEVICE, generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        fan_in = 1
        for s in kernel_shape[:n_in]:
            fan_in *= s
        self.n_in = n_in
        self.kernel = nn.Parameter(_lecun_(torch.empty(kernel_shape, device=device), fan_in, generator))
        self.bias = nn.Parameter(torch.zeros(bias_shape, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.tensordot(x, self.kernel, dims=self.n_in) + self.bias


class MultiHeadDotProductAttention(nn.Module):
    """Self-attention as flax's MultiHeadDotProductAttention computes it:
    q, k, v = x W + b per head (`query`, `key`, `value`, each (d, heads,
    d / heads)), softmax(q k^T / sqrt(d / heads)) v, then `out` ((heads,
    d / heads, d))."""

    def __init__(self, d_model: int, n_heads: int, device: Device = DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        if d_model % n_heads:
            raise ValueError(f"the width {d_model} does not split into {n_heads} heads")
        hd = d_model // n_heads
        kw = dict(device=device, generator=generator)
        self.query = _DenseGeneral((d_model, n_heads, hd), (n_heads, hd), 1, **kw)
        self.key = _DenseGeneral((d_model, n_heads, hd), (n_heads, hd), 1, **kw)
        self.value = _DenseGeneral((d_model, n_heads, hd), (n_heads, hd), 1, **kw)
        self.out = _DenseGeneral((n_heads, hd, d_model), (d_model,), 2, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (..., L, d)
        q, k, v = self.query(x), self.key(x), self.value(x)  # (..., L, heads, hd)
        q = q / q.shape[-1] ** 0.5
        w = torch.softmax(torch.einsum("...qhd,...khd->...hqk", q, k), dim=-1)
        return self.out(torch.einsum("...hqk,...khd->...qhd", w, v))


class LayerNorm(nn.Module):
    """flax's LayerNorm over the last axis: (x - E[x]) / sqrt(E[x^2] - E[x]^2
    + eps) * scale + bias, the variance clamped at 0, eps 1e-6."""

    def __init__(self, features: int, eps: float = 1e-6, device: Device = DEFAULT_DEVICE) -> None:
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=-1, keepdim=True)
        var = ((x * x).mean(dim=-1, keepdim=True) - mean * mean).clamp(min=0.0)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.scale) + self.bias


class TransformerEncoderLayer(nn.Module):
    """Post-norm encoder layer that may narrow its output: self-attention,
    residual, `norm1`; a feed-forward (`linear1`, ReLU, `linear2`) to
    d_model_out added to the first d_model_out channels of its input (the
    truncated residual), `norm2`.  (batch, seq, d_model) -> (batch, seq,
    d_model_out)."""

    def __init__(self, d_model: int, d_model_out: int, n_heads: int = 4, dim_feedforward: int = 64,
                 device: Device = DEFAULT_DEVICE, generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.d_model_out = d_model_out
        self.self_attn = MultiHeadDotProductAttention(d_model, n_heads, **kw)
        self.norm1 = LayerNorm(d_model, device=device)
        self.linear1 = dense_layer(d_model, dim_feedforward, **kw)
        self.linear2 = dense_layer(dim_feedforward, d_model_out, **kw)
        self.norm2 = LayerNorm(d_model_out, device=device)

    def forward(self, src: torch.Tensor) -> torch.Tensor:
        src = self.norm1(src + self.self_attn(src))
        ff = linear(self.linear2, torch.relu(linear(self.linear1, src)))
        return self.norm2(src[..., : self.d_model_out] + ff)


class TransformerWithInputSkips(nn.Module):
    """NeRFormer's trunk: x (n_pool, ..., n_pts, C), the leading axis the
    source views (a singleton one is added with pool_axis=False).  `first`
    maps x to hidden_dim; each layer l adds `skip{l}`(z) at the skips, then
    attends across the views (`pool{l}`, batched over rays x points) and
    across the ray's points (`ray{l}`, batched over views x rays), the width
    going from round(hidden / factor**l) to round(hidden / factor**(l+1));
    the views are then pooled by a softmax over them of channel 0 and `last`
    maps to output_dim: (..., n_pts, output_dim)."""

    def __init__(
        self,
        n_layers: int = 2,
        input_dim: int = 39,
        output_dim: int = 256,
        skip_dim: int = 39,
        hidden_dim: int = 64,
        input_skips: Sequence[int] = (1,),
        n_heads: int = 4,
        dim_down_factor: float = 1.0,
        device: Device = DEFAULT_DEVICE,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.n_layers, self.hidden_dim, self.output_dim = n_layers, hidden_dim, output_dim
        self.input_skips = tuple(input_skips)
        self.dims = [int(round(hidden_dim / (dim_down_factor**i))) for i in range(n_layers + 1)]
        self.first = dense_layer(input_dim, hidden_dim, **kw)
        for li in range(n_layers):
            dimin, dimout = self.dims[li], self.dims[li + 1]
            if li in self.input_skips:
                self.add_module(f"skip{li}", dense_layer(skip_dim, dimin, **kw))
            self.add_module(f"pool{li}", TransformerEncoderLayer(dimin, dimout, n_heads, hidden_dim, **kw))
            self.add_module(f"ray{li}", TransformerEncoderLayer(dimout, dimout, n_heads, hidden_dim, **kw))
        self.last = dense_layer(self.dims[-1], output_dim, **kw)

    def forward(self, x: torch.Tensor, z: torch.Tensor, pool_axis: bool = False) -> torch.Tensor:
        if not pool_axis:
            x, z = x[None], z[None]
        V, lead, P = x.shape[0], tuple(x.shape[1:-2]), x.shape[-2]
        y = linear(self.first, x).reshape(V, -1, P, self.hidden_dim)  # (V, R, P, d)
        z_flat = z.reshape(V, -1, P, z.shape[-1])
        R = y.shape[1]
        for li in range(self.n_layers):
            dimout = self.dims[li + 1]
            if li in self.input_skips:
                y = y + linear(getattr(self, f"skip{li}"), z_flat)
            # across the views: R * P sequences of V
            yp = getattr(self, f"pool{li}")(y.movedim(0, 2).reshape(R * P, V, y.shape[-1]))
            # across the ray's points: V * R sequences of P
            yr = yp.reshape(R, P, V, dimout).movedim(2, 0).reshape(V * R, P, dimout)
            y = getattr(self, f"ray{li}")(yr).reshape(V, R, P, dimout)
        w = torch.softmax(y[..., :1], dim=0)
        y = linear(self.last, (y * w).sum(dim=0))  # (R, P, output_dim)
        return y.reshape(lead + (P, self.output_dim))
