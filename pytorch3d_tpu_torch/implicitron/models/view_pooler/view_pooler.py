"""ViewPooler: the view sampler and a feature aggregator (port of
pytorch3d_tpu/implicitron/models/view_pooler/view_pooler.py)."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

from ...tools.config import Configurable, registry
from .feature_aggregator import (
    AngleWeightedIdentityFeatureAggregator,
    FeatureAggregatorBase,
    _ray_angle_weights,
)
from .view_sampler import ViewSampler


@dataclasses.dataclass
class ViewPooler(Configurable):
    view_sampler_args: Dict[str, Any] = dataclasses.field(default_factory=dict)
    feature_aggregator_class_type: str = "ReductionFeatureAggregator"
    feature_aggregator_args: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        self.view_sampler = ViewSampler(**self.view_sampler_args)
        agg_cls = registry.get(FeatureAggregatorBase, self.feature_aggregator_class_type)
        self.feature_aggregator = agg_cls(**self.feature_aggregator_args)

    def get_aggregated_feature_dim(self, feats_dim: int, n_views: int) -> int:
        return self.feature_aggregator.get_aggregated_feature_dim(feats_dim, n_views)

    def has_aggregation(self) -> bool:
        """False for the identity aggregators, which keep every view."""
        return "Identity" not in self.feature_aggregator_class_type

    def __call__(self, *, pts, seq_id_pts=None, camera=None, seq_id_camera=None, feats=None, masks=None,
                 **kwargs):
        """{name: (1, P, C_agg)}: the aggregated features at the points."""
        sampled, sample_masks = self.view_sampler(pts, seq_id_pts, camera, seq_id_camera, feats, masks)
        return self.feature_aggregator(sampled, sample_masks, camera=camera, pts=pts, **kwargs)

    def sample_per_view(self, *, pts, camera=None, feats=None, masks=None, **kwargs):
        """({name: (V, P, C)}, sample masks (V, P, 1)) without aggregation,
        for implicit functions that attend over the views (NeRFormer): the
        view axis is kept; the angle-weighted identity aggregator's ray-angle
        weights are applied."""
        sampled, sample_masks = self.view_sampler(pts, None, camera, None, feats, masks)
        agg = self.feature_aggregator
        w = sample_masks
        if isinstance(agg, AngleWeightedIdentityFeatureAggregator):
            w = w * _ray_angle_weights(camera, pts, agg.min_ray_angle_weight, agg.weight_by_ray_angle_gamma)
        return {k: f * w for k, f in sampled.items()}, sample_masks
