"""Feature extractor base (port of
pytorch3d_tpu/implicitron/models/feature_extractor/feature_extractor.py)."""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ...tools.config import ReplaceableBase


class FeatureExtractorBase(ReplaceableBase):
    """Extracts a dict of feature maps `{name: (B, C_i, H_i, W_i)}` from
    images; implementations are `torch.nn.Module`s."""

    def get_feat_dims(self) -> int:
        """Total number of output feature dimensions (sum over maps)."""
        raise NotImplementedError

    def forward(
        self,
        imgs: Optional[torch.Tensor],
        masks: Optional[torch.Tensor] = None,
        **kwargs,
    ) -> Dict[Any, torch.Tensor]:
        raise NotImplementedError
