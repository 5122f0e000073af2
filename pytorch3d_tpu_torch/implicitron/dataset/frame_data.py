"""FrameData, the unit record of Implicitron's datasets (port of the
`FrameData` dataclass of pytorch3d_tpu/implicitron/dataset/frame_data.py).
Images are channels-last tensors, cameras the port's cameras.  The
builders that load frames from disk are not ported yet."""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Union

import numpy as np
import torch


@dataclasses.dataclass
class FrameData:
    frame_number: Optional[Union[int, np.ndarray]] = None
    sequence_name: Optional[Union[str, List[str]]] = None
    sequence_category: Optional[Union[str, List[str]]] = None
    frame_timestamp: Optional[torch.Tensor] = None
    image_size_hw: Optional[torch.Tensor] = None
    effective_image_size_hw: Optional[torch.Tensor] = None
    image_path: Optional[Union[str, List[str]]] = None
    image_rgb: Optional[torch.Tensor] = None  # (N, H, W, 3)
    mask_crop: Optional[torch.Tensor] = None  # (N, H, W, 1)
    depth_path: Optional[Union[str, List[str]]] = None
    depth_map: Optional[torch.Tensor] = None  # (N, H, W, 1)
    depth_mask: Optional[torch.Tensor] = None
    mask_path: Optional[Union[str, List[str]]] = None
    fg_probability: Optional[torch.Tensor] = None  # (N, H, W, 1)
    bbox_xywh: Optional[torch.Tensor] = None
    crop_bbox_xywh: Optional[torch.Tensor] = None
    camera: Optional[Any] = None
    camera_quality_score: Optional[torch.Tensor] = None
    point_cloud_quality_score: Optional[torch.Tensor] = None
    sequence_point_cloud_path: Optional[Union[str, List[str]]] = None
    sequence_point_cloud: Optional[Any] = None
    sequence_point_cloud_idx: Optional[torch.Tensor] = None
    frame_type: Optional[Union[str, List[str]]] = None
    meta: dict = dataclasses.field(default_factory=dict)

    def keys(self):
        return [f.name for f in dataclasses.fields(self)]

    def __getitem__(self, k):
        return getattr(self, k)

    @classmethod
    def collate(cls, batch: List["FrameData"]) -> "FrameData":
        """Stack single-frame FrameData into a batch: tensors concatenated
        along the batch, strings listed, cameras joined."""
        out = {}
        for f in dataclasses.fields(cls):
            vals = [getattr(b, f.name) for b in batch]
            if all(v is None for v in vals):
                out[f.name] = None
            elif torch.is_tensor(vals[0]):
                out[f.name] = torch.cat(vals, dim=0)
            elif isinstance(vals[0], str):
                out[f.name] = list(vals)
            elif f.name == "camera" and vals[0] is not None:
                from ...renderer.camera_utils import join_cameras_as_batch

                out[f.name] = join_cameras_as_batch(vals)
            else:
                out[f.name] = vals
        return cls(**out)
