"""The ResNet feature pyramid of Implicitron's view pooling (port of
pytorch3d_tpu/implicitron/models/feature_extractor/resnet_feature_extractor.py).

A torchvision-layout ResNet (18/34/50/101/152) with frozen batch norm as
four plain parameters, per-stage 1x1 projections, l2 normalisation and
image / feature rescaling.  Module names are the flax module's
(`stem_conv`, `stem_bn`, `layer{s}_block{b}` with `conv{i}`, `bn{i}`,
`downsample_conv`, `downsample_bn`, and `proj{s}`), so a flax checkpoint
maps by name (`convert.generic_model_state_dict_from_flax`: conv kernels
HWIO -> OIHW).  `pretrained=True` downloads nothing: torchvision-named
weights load through `params_from_torch_state_dict`.

The arithmetic follows the JAX module: images come in channels-last
(N, H, W, 3); every 3x3 conv pads as flax's "SAME" does (a stride-2 conv on
an even side pads (0, 1), where `Conv2d(padding=1)` pads (1, 1)); the
input resize is `jax.image.resize`'s bilinear, which antialiases when it
shrinks (`F.interpolate(antialias=True)`); features go out (N, C, H, W)
keyed `res_layer_{k}`, `mask` (the mask as given, not resized) and `image`
(the resized image).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ....common import DEFAULT_DEVICE
from ...tools.config import expand_args_fields, registry
from .feature_extractor import FeatureExtractorBase

Device = Union[str, torch.device]

MASK_FEATURE_NAME = "mask"
IMAGE_FEATURE_NAME = "image"

_FEAT_DIMS = {
    "resnet18": (64, 128, 256, 512),
    "resnet34": (64, 128, 256, 512),
    "resnet50": (256, 512, 1024, 2048),
    "resnet101": (256, 512, 1024, 2048),
    "resnet152": (256, 512, 1024, 2048),
}
# (blocks per stage, bottleneck?)
_LAYOUTS = {
    "resnet18": ((2, 2, 2, 2), False),
    "resnet34": ((3, 4, 6, 3), False),
    "resnet50": ((3, 4, 6, 3), True),
    "resnet101": ((3, 4, 23, 3), True),
    "resnet152": ((3, 8, 36, 3), True),
}

_RESNET_MEAN = (0.485, 0.456, 0.406)
_RESNET_STD = (0.229, 0.224, 0.225)


class _Conv(nn.Module):
    """A conv with an OIHW `weight` (and `bias` with use_bias), flax's
    lecun-normal init, and "SAME" padding computed per input as XLA does:
    total = max((ceil(n / s) - 1) s + k - n, 0), the smaller half first.
    `padding` gives explicit (lo, hi) pairs instead (the stem's (3, 3))."""

    def __init__(self, in_features: int, features: int, kernel: int, stride: int = 1, use_bias: bool = False,
                 padding: Optional[Tuple[int, int]] = None, device: Device = DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.stride, self.padding = stride, padding
        w = torch.empty((features, in_features, kernel, kernel), device=device)
        std = (1.0 / (in_features * kernel * kernel)) ** 0.5 / 0.87962566103423978
        nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)
        self.weight = nn.Parameter(w)
        self.bias = nn.Parameter(torch.zeros(features, device=device)) if use_bias else None

    @staticmethod
    def same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
        total = max((-(-n // s) - 1) * s + k - n, 0)
        return total // 2, total - total // 2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.weight.shape[-1]
        if self.padding is not None:
            (top, bottom), (left, right) = self.padding, self.padding
        else:
            top, bottom = self.same_pads(x.shape[-2], k, self.stride)
            left, right = self.same_pads(x.shape[-1], k, self.stride)
        if top or bottom or left or right:
            x = F.pad(x, (left, right, top, bottom))
        return F.conv2d(x, self.weight, self.bias, stride=self.stride)


class FrozenBatchNorm(nn.Module):
    """Batch norm in inference form, (scale, bias, mean, var) as plain
    parameters: x * scale / sqrt(var + eps) + (bias - mean * that)."""

    def __init__(self, features: int, eps: float = 1e-5, device: Device = DEFAULT_DEVICE) -> None:
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.mean = nn.Parameter(torch.zeros(features, device=device))
        self.var = nn.Parameter(torch.ones(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (N, C, H, W)
        inv = self.scale * torch.rsqrt(self.var + self.eps)
        return x * inv[:, None, None] + (self.bias - self.mean * inv)[:, None, None]


class BasicBlock(nn.Module):
    """torchvision's BasicBlock: 3x3-BN-relu-3x3-BN plus the identity or a
    1x1-BN skip."""

    def __init__(self, in_features: int, features: int, stride: int = 1, device: Device = DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.conv1 = _Conv(in_features, features, 3, stride, **kw)
        self.bn1 = FrozenBatchNorm(features, device=device)
        self.conv2 = _Conv(features, features, 3, **kw)
        self.bn2 = FrozenBatchNorm(features, device=device)
        if in_features != features or stride != 1:
            self.downsample_conv = _Conv(in_features, features, 1, stride, **kw)
            self.downsample_bn = FrozenBatchNorm(features, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        if hasattr(self, "downsample_conv"):
            x = self.downsample_bn(self.downsample_conv(x))
        return torch.relu(x + y)


class Bottleneck(nn.Module):
    """torchvision's Bottleneck: 1x1 -> 3x3 (stride) -> 1x1 (4x the width)
    plus the skip; `features` is the output width."""

    def __init__(self, in_features: int, features: int, stride: int = 1, device: Device = DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        kw = dict(device=device, generator=generator)
        width = features // 4
        self.conv1 = _Conv(in_features, width, 1, **kw)
        self.bn1 = FrozenBatchNorm(width, device=device)
        self.conv2 = _Conv(width, width, 3, stride, **kw)
        self.bn2 = FrozenBatchNorm(width, device=device)
        self.conv3 = _Conv(width, features, 1, **kw)
        self.bn3 = FrozenBatchNorm(features, device=device)
        if in_features != features or stride != 1:
            self.downsample_conv = _Conv(in_features, features, 1, stride, **kw)
            self.downsample_bn = FrozenBatchNorm(features, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        if hasattr(self, "downsample_conv"):
            x = self.downsample_bn(self.downsample_conv(x))
        return torch.relu(x + y)


def resize_bilinear(image: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """`jax.image.resize(image, (N, h, w, C), "bilinear")` of a channels-last
    (N, H, W, C) image: a triangle kernel stretched by the scale where it
    shrinks (antialiased), the weights renormalised at the borders."""
    x = F.interpolate(image.movedim(-1, 1), size=size, mode="bilinear", align_corners=False, antialias=True)
    return x.movedim(1, -1)


@registry.register
class ResNetFeatureExtractor(FeatureExtractorBase, nn.Module):
    """Multi-scale ResNet feature pyramid.

    arch: the resnet layout (resnet18/34/50/101/152).  pretrained: kept for
    the configs; no weights are downloaded.  stages: the stages emitted as
    `res_layer_{k}`.  normalize_image: subtract and divide by ImageNet's
    RGB mean and std.  image_rescale: the bilinear input resize.
    first_max_pool: a 3x3 stride-2 max pool after the stem.  proj_dim: the
    per-stage 1x1 projection width (a stage no wider stays as it is).
    l2_norm: per-stage l2 normalisation scaled by 1 / sqrt(len(stages)).
    add_masks / add_images: the `mask` / `image` entries.
    global_average_pool: the spatial mean of each emitted stage.
    feature_rescale: a factor on every output.
    """

    arch: str = "resnet34"
    pretrained: bool = True
    stages: Tuple[int, ...] = (1, 2, 3, 4)
    normalize_image: bool = True
    image_rescale: float = 128 / 800.0
    first_max_pool: bool = True
    proj_dim: int = 32
    l2_norm: bool = True
    add_masks: bool = True
    add_images: bool = True
    global_average_pool: bool = False
    feature_rescale: float = 1.0
    device: Device = DEFAULT_DEVICE
    generator: Optional[torch.Generator] = None

    def __post_init__(self):
        self.stages = tuple(self.stages)
        kw = dict(device=self.device, generator=self.generator)
        if self.stages:
            self.stem_conv = _Conv(3, 64, 7, 2, padding=(3, 3), **kw)
            self.stem_bn = FrozenBatchNorm(64, device=self.device)
            layout, bottleneck = _LAYOUTS[self.arch]
            block_cls = Bottleneck if bottleneck else BasicBlock
            in_features = 64
            for stage in range(1, max(self.stages) + 1):
                feats = _FEAT_DIMS[self.arch][stage - 1]
                for b in range(layout[stage - 1]):
                    stride = 2 if (stage > 1 and b == 0) else 1
                    self.add_module(f"layer{stage}_block{b}", block_cls(in_features, feats, stride, **kw))
                    in_features = feats
                if stage in self.stages and 0 < self.proj_dim < feats:
                    self.add_module(f"proj{stage}", _Conv(feats, self.proj_dim, 1, use_bias=True, **kw))
        self.register_buffer("_mean", torch.tensor(_RESNET_MEAN, device=self.device), persistent=False)
        self.register_buffer("_std", torch.tensor(_RESNET_STD, device=self.device), persistent=False)
        self.generator = None  # used once; a module keeps no generator

    def get_feat_dims(self) -> int:
        """Total channels over every emitted entry."""
        dims = 0
        for stage in self.stages:
            native = _FEAT_DIMS[self.arch][stage - 1]
            dims += self.proj_dim if 0 < self.proj_dim < native else native
        return dims + (1 if self.add_masks else 0) + (3 if self.add_images else 0)

    def forward(
        self,
        image_rgb: Optional[torch.Tensor],  # (N, H, W, 3) channels-last
        masks: Optional[torch.Tensor] = None,  # (N, H, W, 1)
        **kwargs,
    ) -> Dict[str, torch.Tensor]:
        """{name: (N, C_i, H_i, W_i)} feature maps ((N, C_i) under
        global_average_pool)."""
        out: Dict[str, torch.Tensor] = {}
        imgs_resized = image_rgb
        if image_rgb is not None and self.image_rescale != 1.0:
            _, h, w, _ = image_rgb.shape
            size = (max(int(round(h * self.image_rescale)), 1), max(int(round(w * self.image_rescale)), 1))
            imgs_resized = resize_bilinear(image_rgb, size)

        if self.stages:
            if imgs_resized is None:
                raise ValueError("ResNetFeatureExtractor: the stages need an image")
            x = imgs_resized
            if self.normalize_image:
                x = (x - self._mean) / self._std
            x = torch.relu(self.stem_bn(self.stem_conv(x.movedim(-1, 1))))
            if self.first_max_pool:
                x = F.max_pool2d(x, 3, stride=2, padding=1)
            layout, _ = _LAYOUTS[self.arch]
            for stage in range(1, max(self.stages) + 1):
                for b in range(layout[stage - 1]):
                    x = getattr(self, f"layer{stage}_block{b}")(x)
                if stage not in self.stages:
                    continue
                f = x
                if hasattr(self, f"proj{stage}"):
                    f = getattr(self, f"proj{stage}")(f)
                if self.global_average_pool:
                    f = f.mean(dim=(2, 3))
                if self.l2_norm:
                    normfac = 1.0 / math.sqrt(len(self.stages))
                    f = f / torch.linalg.norm(f, dim=1, keepdim=True).clamp(min=1e-12) * normfac
                out[f"res_layer_{stage}"] = f

        if self.add_masks and masks is not None:
            out[MASK_FEATURE_NAME] = masks.movedim(-1, 1)
        if self.add_images:
            if imgs_resized is None:
                raise ValueError("ResNetFeatureExtractor: add_images needs an image")
            out[IMAGE_FEATURE_NAME] = imgs_resized.movedim(-1, 1)
        if self.feature_rescale != 1.0:
            out = {k: self.feature_rescale * f for k, f in out.items()}
        return out


expand_args_fields(ResNetFeatureExtractor)

_BN_LEAVES = (("weight", "scale"), ("bias", "bias"), ("running_mean", "mean"), ("running_var", "var"))


def params_from_torch_state_dict(
    extractor: ResNetFeatureExtractor, state_dict: Mapping[str, Any]
) -> Dict[str, torch.Tensor]:
    """The extractor's state dict with torchvision ResNet weights put in:
    `conv1.weight`, `bn1.*`, `layer{s}.{b}.conv{i}.weight`,
    `layer{s}.{b}.bn{i}.{weight, bias, running_mean, running_var}` and
    `layer{s}.{b}.downsample.{0, 1}.*` (tensors or arrays, OIHW as the port
    keeps them).  Entries the extractor does not hold (stages past
    max(stages), fc) are ignored; a shape that differs raises.  The input
    is not changed; load the result with `load_state_dict`."""
    new = {k: v.clone() for k, v in extractor.state_dict().items()}

    def put(name, value):
        if name not in new:
            return
        value = torch.as_tensor(value, dtype=new[name].dtype).to(new[name].device)
        if tuple(value.shape) != tuple(new[name].shape):
            raise ValueError(f"{name}: shape {tuple(value.shape)} != {tuple(new[name].shape)}")
        new[name] = value

    def put_bn(ours, theirs):
        for t_leaf, leaf in _BN_LEAVES:
            if f"{theirs}.{t_leaf}" in state_dict:
                put(f"{ours}.{leaf}", state_dict[f"{theirs}.{t_leaf}"])

    if "conv1.weight" in state_dict:
        put("stem_conv.weight", state_dict["conv1.weight"])
    put_bn("stem_bn", "bn1")
    layout, bottleneck = _LAYOUTS[extractor.arch]
    for stage in range(1, 5):
        for b in range(layout[stage - 1]):
            mod, tv = f"layer{stage}_block{b}", f"layer{stage}.{b}"
            for i in range(1, (3 if bottleneck else 2) + 1):
                if f"{tv}.conv{i}.weight" in state_dict:
                    put(f"{mod}.conv{i}.weight", state_dict[f"{tv}.conv{i}.weight"])
                put_bn(f"{mod}.bn{i}", f"{tv}.bn{i}")
            if f"{tv}.downsample.0.weight" in state_dict:
                put(f"{mod}.downsample_conv.weight", state_dict[f"{tv}.downsample.0.weight"])
                put_bn(f"{mod}.downsample_bn", f"{tv}.downsample.1")
    return new
