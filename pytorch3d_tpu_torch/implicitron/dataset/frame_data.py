"""FrameData, the unit record of Implicitron's datasets, and the builders
that load a frame from disk (port of
pytorch3d_tpu/implicitron/dataset/frame_data.py).  Images are channels-last
tensors, cameras the port's cameras."""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Any, List, Optional, Union

import numpy as np
import torch

from ...common import DEFAULT_DEVICE


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


class FrameDataBuilderBase:
    """Base of the builders that make a `FrameData` from a frame's
    annotation."""

    def build(self, frame_annotation, sequence_annotation=None, **kwargs) -> "FrameData":
        raise NotImplementedError


@dataclasses.dataclass
class GenericFrameDataBuilder(FrameDataBuilderBase):
    """Loads a frame's image, mask and depth and runs the geometry pipeline:
    an optional crop around the mask's box with the camera refocused, an
    aspect-preserving resize with zero padding (`mask_crop` marks the
    image), and the camera rescaled to it.  Loading and resizing run on the
    host in numpy; the frame's tensors and camera are made on `device`
    (None: the card).

    `frame_annotation` is a CO3D-style dict ({"sequence_name", "image":
    {"path", "size"}, "mask": {"path"}, "depth": {"path",
    "scale_adjustment"}, "viewpoint": {...}}) or a `types.FrameAnnotation`."""

    dataset_root: str = ""
    load_images: bool = True
    load_depths: bool = True
    load_depth_masks: bool = True
    load_masks: bool = True
    image_height: Optional[int] = 256
    image_width: Optional[int] = 256
    box_crop: bool = False
    box_crop_mask_thr: float = 0.4
    box_crop_context: float = 0.3
    device: Optional[Union[str, torch.device]] = None

    def _resolve(self, path: str) -> str:
        return os.path.join(self.dataset_root, path) if self.dataset_root else path

    def _load_image_hwc(self, path: str):
        if not self.load_images or not path:
            return None
        from PIL import Image

        p = self._resolve(path)
        if not os.path.isfile(p):
            warnings.warn(f"image not found: {p}")
            return None
        im = Image.open(p).convert("RGB")
        return np.asarray(im, np.float32) / 255.0

    def _load_mask_hwc(self, path: str):
        if not self.load_masks or not path:
            return None
        from PIL import Image

        p = self._resolve(path)
        if not os.path.isfile(p):
            return None
        im = Image.open(p).convert("L")
        return (np.asarray(im, np.float32) / 255.0)[..., None]

    def _load_depth_hwc(self, entry):
        if not self.load_depths:
            return None
        d = entry.get("depth") or {}
        path = d.get("path", "")
        if not path:
            return None
        p = self._resolve(path)
        if not os.path.isfile(p):
            return None
        from PIL import Image

        depth = np.asarray(Image.open(p), np.float32)
        if depth.ndim == 3:
            depth = depth[..., 0]
        scale = float(d.get("scale_adjustment", 1.0))
        return (depth * scale)[..., None]

    def build(self, frame_annotation, sequence_annotation=None, **kwargs) -> "FrameData":
        from ...renderer.cameras import PerspectiveCameras
        from . import utils as du

        device = DEFAULT_DEVICE if self.device is None else torch.device(self.device)
        entry = frame_annotation
        if dataclasses.is_dataclass(entry) and not isinstance(entry, type):
            entry = dataclasses.asdict(entry)
        sequence_category = kwargs.get("sequence_category")
        if sequence_category is None and sequence_annotation is not None:
            seq = sequence_annotation
            if dataclasses.is_dataclass(seq) and not isinstance(seq, type):
                seq = dataclasses.asdict(seq)
            sequence_category = seq.get("category", "default")
        if sequence_category is None:
            sequence_category = "default"

        def f32(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=device)

        vp = entry.get("viewpoint") or {}
        camera = None
        if vp:
            camera = PerspectiveCameras.create(
                R=f32(vp["R"])[None], T=f32(vp["T"])[None], focal_length=f32(vp["focal_length"])[None],
                principal_point=f32(vp["principal_point"])[None], device=device,
            )
        image = self._load_image_hwc((entry.get("image") or {}).get("path", ""))
        mask = self._load_mask_hwc((entry.get("mask") or {}).get("path", ""))
        depth = self._load_depth_hwc(entry)

        bbox_xywh = None
        crop_bbox_xywh = None
        if self.box_crop and mask is not None and image is not None:
            bbox_xywh = np.asarray(du.get_bbox_from_mask(mask[..., 0], self.box_crop_mask_thr), np.float64)
            bbox_xyxy = du.get_clamp_bbox(
                bbox_xywh, box_crop_context=self.box_crop_context, image_path=(entry.get("image") or {}).get("path", "")
            )
            clamped = du.clamp_box_to_image_bounds_and_round(bbox_xyxy, image.shape[:2])
            crop_bbox_xywh = du.bbox_xyxy_to_xywh(clamped)
            pre_crop_wh = (image.shape[1], image.shape[0])
            image = du.crop_around_box(image, clamped)
            mask = du.crop_around_box(mask, clamped)
            if depth is not None:
                depth = du.crop_around_box(depth, clamped)
            if camera is not None:
                camera = du.adjust_camera_to_bbox_crop(camera, pre_crop_wh, crop_bbox_xywh)

        mask_crop = None
        if image is not None:
            H = self.image_height or image.shape[0]
            W = self.image_width or image.shape[1]
            pre_hw = image.shape[:2]
            image, scale, mask_crop = du.resize_image(image, H, W)
            if mask is not None:
                mask, _, _ = du.resize_image(mask, H, W, mode="nearest")
            if depth is not None:
                depth, _, _ = du.resize_image(depth, H, W, mode="nearest")
            if camera is not None:
                camera = du.adjust_camera_to_image_scale(camera, (pre_hw[1], pre_hw[0]), (W, H))

        def frame_tensor(x):
            return None if x is None else f32(x)[None]

        meta = entry.get("meta")
        return FrameData(
            frame_number=entry.get("frame_number"),
            sequence_name=entry["sequence_name"],
            sequence_category=sequence_category,
            image_rgb=frame_tensor(image),
            fg_probability=frame_tensor(mask),
            depth_map=frame_tensor(depth),
            mask_crop=frame_tensor(mask_crop),
            bbox_xywh=None if bbox_xywh is None else f32(bbox_xywh),
            # int32, as the JAX package's arrays hold the rounded box
            crop_bbox_xywh=None if crop_bbox_xywh is None else torch.as_tensor(
                crop_bbox_xywh.astype(np.int32), device=device),
            camera=camera,
            image_path=(entry.get("image") or {}).get("path"),
            mask_path=(entry.get("mask") or {}).get("path"),
            frame_type=meta.get("frame_type") if isinstance(meta, dict) else None,
        )


@dataclasses.dataclass
class FrameDataBuilder(GenericFrameDataBuilder):
    """The default builder."""
