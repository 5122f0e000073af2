"""Aggregate the features sampled in every source view (port of
pytorch3d_tpu/implicitron/models/view_pooler/feature_aggregator.py)."""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, Sequence

import torch

from ...tools.config import ReplaceableBase, registry


class ReductionFunction(enum.Enum):
    """View reductions; the aggregators also take the raw strings."""

    AVG = "avg"
    MAX = "max"
    STD = "std"
    STD_AVG = "std_avg"


class FeatureAggregatorBase(ReplaceableBase):
    exclude_target_view: bool = True

    def get_aggregated_feature_dim(self, feats_dim: int, n_views: int) -> int:
        raise NotImplementedError


def _masked_mean_std(x: torch.Tensor, mask: torch.Tensor, dim: int):
    """The mask-weighted mean and standard deviation over `dim` (the weight
    sum clamped at 1e-4, the variance at 1e-8)."""
    w = mask.sum(dim=dim).clamp(min=1e-4)
    mean = (x * mask).sum(dim=dim) / w
    var = (((x - mean.unsqueeze(dim)) ** 2) * mask).sum(dim=dim) / w
    return mean, var.clamp(min=1e-8).sqrt()


def _ray_angle_weights(camera, pts: torch.Tensor, min_w: float, gamma: float) -> torch.Tensor:
    """(V, P, 1) weights from how well each source view's ray to a point
    agrees with the first view's: clamp((cos + 1) / 2, min_w) ** gamma."""
    centers = camera.get_camera_center()  # (V, 3)
    p = pts.reshape(-1, 3)
    view_dirs = p[None] - centers[:, None]  # (V, P, 3)
    view_dirs = view_dirs / torch.linalg.norm(view_dirs, dim=-1, keepdim=True).clamp(min=1e-8)
    cos = (view_dirs * view_dirs[:1]).sum(dim=-1)[..., None]
    return (0.5 * (cos + 1.0)).clamp(min=min_w) ** gamma


def _concat_views(feats_sampled: Dict[str, torch.Tensor], weights: torch.Tensor) -> Dict[str, torch.Tensor]:
    """{name: (1, P, V * C)}: each view's weighted features side by side."""
    out = {}
    for name, f in feats_sampled.items():  # (V, P, C)
        V, P, C = f.shape
        out[name] = (f * weights).transpose(0, 1).reshape(P, V * C)[None]
    return out


@registry.register
@dataclasses.dataclass
class IdentityFeatureAggregator(FeatureAggregatorBase):
    """Every view's masked features concatenated, without reduction."""

    def get_aggregated_feature_dim(self, feats_dim: int, n_views: int) -> int:
        return feats_dim * n_views

    def __call__(self, feats_sampled: Dict, masks_sampled, **kwargs):
        return _concat_views(feats_sampled, masks_sampled)


@registry.register
@dataclasses.dataclass
class ReductionFeatureAggregator(FeatureAggregatorBase):
    """Mean / std / std_avg / max over the views, concatenated in the order
    of `reduction_functions`: (1, P, C * k) per feature map."""

    reduction_functions: Sequence = ("avg", "std")

    def _reduction_names(self):
        return [r.value if isinstance(r, ReductionFunction) else str(r) for r in self.reduction_functions]

    def get_aggregated_feature_dim(self, feats_dim: int, n_views: int) -> int:
        return feats_dim * len(self.reduction_functions)

    def __call__(self, feats_sampled: Dict, masks_sampled, **kwargs):
        out = {}
        for name, f in feats_sampled.items():  # (V, P, C)
            parts = []
            mean, std = _masked_mean_std(f, masks_sampled, dim=0)
            for red in self._reduction_names():
                if red == "avg":
                    parts.append(mean)
                elif red == "std":
                    parts.append(std)
                elif red == "std_avg":
                    parts.append(std.mean(dim=-1, keepdim=True))
                elif red == "max":
                    parts.append(torch.where(masks_sampled > 0, f, -torch.inf).amax(dim=0))
                else:
                    raise ValueError(f"unknown reduction {red}")
            out[name] = torch.cat(parts, dim=-1)[None]
        return out


@registry.register
@dataclasses.dataclass
class AngleWeightedIdentityFeatureAggregator(FeatureAggregatorBase):
    """Every view's features weighted by its ray-angle agreement with the
    first view, concatenated without reduction."""

    weight_by_ray_angle_gamma: float = 1.0
    min_ray_angle_weight: float = 0.1

    def get_aggregated_feature_dim(self, feats_dim: int, n_views: int) -> int:
        return feats_dim * n_views

    def __call__(self, feats_sampled: Dict, masks_sampled, camera=None, pts=None, **kwargs):
        if camera is None or pts is None:
            raise ValueError("camera and pts are required for angle weighted aggregation")
        w = _ray_angle_weights(camera, pts, self.min_ray_angle_weight, self.weight_by_ray_angle_gamma)
        return _concat_views(feats_sampled, masks_sampled * w)


@registry.register
@dataclasses.dataclass
class AngleWeightedReductionFeatureAggregator(ReductionFeatureAggregator):
    """The reductions with each view's mask weighted by its ray-angle
    agreement with the first view."""

    weight_by_ray_angle_gamma: float = 1.0
    min_ray_angle_weight: float = 0.1

    def __call__(self, feats_sampled: Dict, masks_sampled, camera=None, pts=None, **kwargs):
        if camera is not None and pts is not None:
            masks_sampled = masks_sampled * _ray_angle_weights(
                camera, pts, self.min_ray_angle_weight, self.weight_by_ray_angle_gamma)
        return super().__call__(feats_sampled, masks_sampled, **kwargs)
