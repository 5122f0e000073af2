"""The model contract of Implicitron's trainer (port of
pytorch3d_tpu/implicitron/models/base_model.py): a model is called with the
keyword batch of a FrameData and returns a `preds` dict that holds its
render under ``preds["implicitron_render"]``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import torch

from ..tools.config import ReplaceableBase
from .renderer.base import EvaluationMode


@dataclasses.dataclass
class ImplicitronRender:
    """The tensors describing one render."""

    depth_render: Optional[torch.Tensor] = None
    image_render: Optional[torch.Tensor] = None
    mask_render: Optional[torch.Tensor] = None
    camera_distance: Optional[torch.Tensor] = None

    def clone(self) -> "ImplicitronRender":
        """A copy of detached clones."""

        def safe_clone(t):
            return t.detach().clone() if t is not None else None

        return ImplicitronRender(
            depth_render=safe_clone(self.depth_render),
            image_render=safe_clone(self.image_render),
            mask_render=safe_clone(self.mask_render),
            camera_distance=safe_clone(self.camera_distance),
        )


class ImplicitronModelBase(ReplaceableBase):
    """Replaceable base of image-generation models: `torch.nn.Module`s whose
    `forward` takes the keyword batch below and returns a `preds` dict with
    the render at ``preds["implicitron_render"]``."""

    log_vars: List[str] = ["objective"]

    def forward(
        self,
        *,
        image_rgb: Optional[torch.Tensor] = None,  # (B, H, W, 3)
        camera=None,
        fg_probability: Optional[torch.Tensor] = None,  # (B, H, W, 1)
        mask_crop: Optional[torch.Tensor] = None,
        depth_map: Optional[torch.Tensor] = None,
        sequence_name: Optional[List[str]] = None,
        evaluation_mode: EvaluationMode = EvaluationMode.EVALUATION,
        **kwargs,
    ) -> Dict[str, Any]:
        raise NotImplementedError()
